"""BASELINE config 5 served over a jobs mesh of four devices, as the
four-card benchmark cell ``serve64_1080p_mesh4.closed64`` serves it, here
on a mesh of four ``cpu`` devices with the plain engine (``engine=
"torch"``) at config 5's shapes divided by 16.

One flush of 5, 13, 16 or 45 jobs each (a flush of 13 or 45 pads 3 zero
jobs to reach a multiple of 4; one of 5 pads 3 to 8, so its last card
holds only padding): every canvas is held to the float64 reference of its
own sources (``stitchbench/reference/``: within 1 uint8 step on resampled
values, exact on copies and background) and equals the one-device
server's canvas, and ``BatchedStitch``'s on the jobs stacked on the host
with zero jobs, bit for bit; no padded job's canvas comes back; the flush
counts its jobs, its padding and its distinct devices (1: the mesh
repeats one device) and each ``batch.*`` span its card, each upload its
rows copied from the jobs' own arrays."""

import dataclasses
import os
import time

import numpy as np
import pytest

from imagestitching_tpu_torch import RuntimeConfig, StitchServer
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.parallel.batch import BatchedStitch
from imagestitching_tpu_torch.parallel.mesh import make_mesh
from imagestitching_tpu_torch.runtime import spans
from stitchbench import deploy, harness
from stitchbench.reference.stitch import compare

CONFIG = harness.load_json(os.path.join(
    harness.ROOT, "stitchbench", "configs", "serve64_1080p_mesh4.json"))
SHAPES = deploy.shapes(CONFIG, 16)
ORIENT = [o for _, _, o in SHAPES]
OPTIONS = deploy.options(CONFIG)
BATCH = ("batch.h2d", "batch.draw", "batch.sync", "batch.readback")
SIZES = [5, 13, 16, 45]


def _jobs(n):
    rng = np.random.default_rng(1000 + n)
    return [[rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in SHAPES]
            for _ in range(n)]


def _serve(jobs, mesh):
    """One flush of every job (``max_batch`` is their number): the
    canvases, in submission order, and the worker's span records."""
    config = dataclasses.replace(RuntimeConfig(device="cpu"), mesh=mesh)
    t0 = time.perf_counter_ns()
    with StitchServer(max_batch=len(jobs), max_wait_s=30.0, engine="torch",
                      use_mesh=mesh is not None, config=config) as server:
        futs = [server.submit(imgs, OPTIONS, orientations=ORIENT)
                for imgs in jobs]
        outs = [f.result(timeout=120) for f in futs]
        worker = server._thread.ident
        assert server.stats()["batches"] == 1
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    return outs, [r for r in records if r.thread == worker]


@pytest.fixture(scope="module", params=SIZES, ids=[f"b{n}" for n in SIZES])
def served(request):
    jobs = _jobs(request.param)
    mesh_outs, records = _serve(jobs, make_mesh(devices=["cpu"] * 4))
    one_outs, one_records = _serve(jobs, None)
    return jobs, mesh_outs, records, one_outs, one_records


def test_mesh_canvases_hold_to_the_reference(served):
    jobs, outs, *_ = served
    layout = deploy.layout(CONFIG, SHAPES)
    for imgs, out in zip(jobs, outs):
        got = compare(layout, imgs, out)
        assert got["resampled_max_diff"] <= 1
        assert got["exact_max_diff"] == 0


def test_mesh_canvases_equal_the_one_device_server(served):
    _, outs, _, one_outs, _ = served
    for got, want in zip(outs, one_outs):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_no_padded_job_canvas_comes_back(served):
    """Job k's canvas is row k of its flush's host array, whose rows past
    the real jobs are the padded zero jobs', which nobody receives."""
    jobs, outs, *_ = served
    n, padded = len(jobs), -(-len(jobs) // 4) * 4
    assert len(outs) == n
    assert [harness.batch_position(out) for out in outs] == list(range(n))
    assert {out.base.shape[0] for out in outs} == {padded}


def test_flush_counts_jobs_pad_jobs_and_cards(served):
    jobs, _, records, _, one_records = served
    n = len(jobs)
    (flush,) = [r for r in records if r.name == "serve.flush"]
    assert flush.counts == {"jobs": n, "pad_jobs": -n % 4, "cards": 1}
    (flush,) = [r for r in one_records if r.name == "serve.flush"]
    assert flush.counts == {"jobs": n, "pad_jobs": 0, "cards": 1}


def test_batch_spans_carry_their_card(served):
    """Per card an upload, a draw and a readback; one sync for the one
    device, counted as card 0's.  The one-device server's spans are card
    0's."""
    _, _, records, _, one_records = served
    (flush,) = [r for r in records if r.name == "serve.flush"]
    batch = [(r.name, r.counts["card"]) for r in records
             if r.name in BATCH and r.parent == flush.span]
    assert sorted(batch) == sorted(
        [(name, k) for name in ("batch.h2d", "batch.draw", "batch.readback")
         for k in range(4)] + [("batch.sync", 0)])
    assert sorted((r.name, r.counts["card"]) for r in one_records
                  if r.name in BATCH) == sorted((n, 0) for n in BATCH)


def test_mesh_canvases_equal_batched_stitch_on_stacked_inputs(served):
    """The flush hands each slot's jobs' own arrays and the padded rows
    are zero-filled on each card: the same canvases as the jobs stacked on
    the host with zero jobs up to a multiple of 4, run over the mesh."""
    jobs, outs, *_ = served
    n, padded = len(jobs), -(-len(jobs) // 4) * 4
    plan = solve([ImageSpec(w, h, o) for w, h, o in SHAPES], OPTIONS,
                 RuntimeConfig().limits)
    stacks = [np.stack([imgs[k] for imgs in jobs]
                       + [np.zeros_like(jobs[0][k])] * (padded - n))
              for k in range(len(SHAPES))]
    want = BatchedStitch(plan, padded, engine="torch",
                         mesh=make_mesh(devices=["cpu"] * 4))(stacks)
    for i, out in enumerate(outs):
        np.testing.assert_array_equal(out, want[i])


def test_every_card_uploads_its_rows_direct(served):
    """Every card's upload, one holding only padding too, copies rows from
    the jobs' own arrays; so does the one-device server's."""
    _, _, records, _, one_records = served
    for recs, cards in ((records, 4), (one_records, 1)):
        h2d = [r.counts for r in recs if r.name == "batch.h2d"]
        assert sorted(c["card"] for c in h2d) == list(range(cards))
        assert all(c["direct"] == 1 for c in h2d)
