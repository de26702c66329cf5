"""``correct`` must come out false when the timed path is broken, and the
control (the reference in bfloat16, in the program's place) must fail the
cell's limits.

Each run here skips the harness's look for a card (``--rehearse``: the CPU
at the workload's rehearsal size, the port's plain engine) and drives the
rest of a run, the window, the sample and the comparison, with a fault
planted in the port underneath.  The cells run on one card, so there is no
exchange between cards to leave out.  The JPEG cell, whose workload file
the benchmark keeps though ``BENCHMARK.json`` does not list it, runs from a
checkout whose ``BENCHMARK.json`` adds it.
"""

import json
import os

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.parallel.batch import BatchedStitch
from imagestitching_tpu_torch.runtime import pipeline

from stitchbench import control, harness, run

ARRAYS = "phone12mp_exif.arrays"
JPEG = "phone12mp_exif.jpeg"
STITCH_CELLS = [ARRAYS, JPEG]
SERVE = "serve64_1080p.closed64"
SEED = 2_147_483_659          # more than 32 signed bits hold


@pytest.fixture
def root(request, tmp_path, monkeypatch):
    """The checkout root for the test's cell: the repository's, or for the
    JPEG cell one whose ``BENCHMARK.json`` lists it beside the arrays
    cell."""
    if request.node.callspec.params["cell"] != JPEG:
        return harness.ROOT
    spec = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    spec["workloads"].append({"name": JPEG, "config": "phone12mp_exif",
                              "traffic": "jpeg", "chips": 1,
                              "why": "nine JPEG files a job"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if ARRAYS in m.get("workloads", []):
            m["workloads"].append(JPEG)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    os.symlink(os.path.join(harness.ROOT, "stitchbench"),
               tmp_path / "stitchbench")
    monkeypatch.setattr(run, "ROOT", str(tmp_path))
    return str(tmp_path)


def _run(capsys, cell, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(SEED), "--seconds",
                   "1", "--trace", str(trace), "--rehearse"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", STITCH_CELLS + [SERVE])
def test_sound_run_is_correct(cell, root, capsys):
    line = _run(capsys, cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == {"resampled_max_diff", "exact_max_diff",
                                   "mismatch_ppm", "failed_jobs"}


def _state_unchanged(monkeypatch):
    # every draw returns the canvas as it was: background only
    monkeypatch.setattr(cuda_resize, "draw_placement", lambda *a, **k: None)
    monkeypatch.setattr(cuda_resize, "_compose", lambda *a, **k: None)


def _answer_altered(monkeypatch):
    # one value of the returned canvas flipped by 128 where it is made
    orig = pipeline.run_overlapped

    def altered(*a, **k):
        out, m = orig(*a, **k)
        out[0, 0, 0] ^= 0x80
        return out, m
    monkeypatch.setattr(pipeline, "run_overlapped", altered)


def _half_batch_left_out(monkeypatch):
    # the second half of each flush's jobs never computed (zero canvases)
    orig = BatchedStitch.__call__

    def half(self, stacks):
        out = orig(self, stacks)
        out[len(out) // 2:] = 0
        return out
    monkeypatch.setattr(BatchedStitch, "__call__", half)


def _one_slot_altered(monkeypatch):
    # one value of the second canvas of every flush flipped by 128: a
    # fault of one batch position, which only a sample that covers every
    # position finds in every run
    orig = BatchedStitch.__call__

    def altered(self, stacks):
        out = orig(self, stacks)
        if len(out) > 1:
            out[1, 0, 0, 0] ^= 0x80
        return out
    monkeypatch.setattr(BatchedStitch, "__call__", altered)


def _batch_mates_swapped(monkeypatch):
    # each job handed its neighbour's canvas
    orig = BatchedStitch.__call__
    monkeypatch.setattr(BatchedStitch, "__call__",
                        lambda self, stacks: np.roll(orig(self, stacks), 1,
                                                     axis=0))


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in STITCH_CELLS for f in (_state_unchanged, _answer_altered)
] + [(SERVE, f) for f in (_state_unchanged, _half_batch_left_out,
                          _one_slot_altered, _batch_mates_swapped)])
def test_fault_makes_correct_false(cell, fault, root, monkeypatch, capsys):
    fault(monkeypatch)
    line = _run(capsys, cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", STITCH_CELLS + [SERVE])
def test_bfloat16_control_fails_the_limits(cell, root):
    c = harness.Cell(cell, root)
    limits = c.config["correct"]
    for seed in (11, 12, 13):
        traffic = c.traffic().Traffic(c, seed, torch.device("cpu"), True,
                                      harness.Spans())
        try:
            traffic.make_inputs()
            got = control.control_numbers(traffic, seed, torch.bfloat16)
        finally:
            traffic.close()
        assert any(got[k] > limits[k] for k in limits), (seed, got)
        assert got["resampled_max_diff"] > limits["resampled_max_diff"]
