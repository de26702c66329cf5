"""The four-card cell ``serve64_1080p_mesh4.closed64``: its six per-layer
readers (``stitchbench/mesh_spans.py``) on synthetic span records, and its
configuration and workload files, which parse and deploy on the CPU over a
mesh of four ``cpu`` devices.  ``run.py --rehearse`` builds its server with
``make_mesh()``, which spans every CUDA card and raises without one, so
the cell has no rehearsal; these tests stand in for it."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from stitchbench import deploy, harness, mesh_spans
from stitchbench.harness import ROOT, Cell, load_module
from stitchbench.reference.stitch import compare
from imagestitching_tpu_torch import StitchServer
from imagestitching_tpu_torch.parallel.mesh import make_mesh
from imagestitching_tpu_torch.runtime import spans

CELL = "serve64_1080p_mesh4.closed64"
MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms
NAMES = ["stack_ms.mesh", "pad_jobs.mesh", "flush_ms.mesh", "card_ms.mesh",
         "card_overlap.mesh"]


def _flush(span, start, cards, pad=3, jobs=45, overlapped=False):
    """A ``serve.flush`` of four shards at ``start`` ms: a 100 ms stack,
    then per card 10 ms of upload, 5 of draw, 2 of sync and 20 of readback,
    the cards one after another (``overlapped=False``) or all at once.
    Records are (name, job, span, parent, start ms, end ms, counts)."""
    kids = [("serve.stack", 0, span + 1, span, start, start + 100, None)]
    t = start + 100
    sid = span + 2
    for card in range(4):
        c0 = t if not overlapped else start + 100
        for name, ms in (("batch.h2d", 10), ("batch.draw", 5),
                         ("batch.sync", 2), ("batch.readback", 20)):
            kids.append((name, 0, sid, span, c0, c0 + ms, {"card": card}))
            sid += 1
            c0 += ms
        t = c0
    end = t if not overlapped else start + 100 + 37
    counts = {"jobs": jobs, "pad_jobs": pad, "cards": cards}
    return kids + [("serve.flush", 0, span, 0, start, end + 1, counts)]


SERIAL = _flush(10, 1000, cards=4)                    # 100 + 4 x 37 + 1 ms
OVERLAPPED = _flush(50, 1500, cards=4, pad=0, jobs=64, overlapped=True)
OUTSIDE = _flush(90, 800, cards=4, pad=1)             # starts before t0
WANT = {
    "serial": {"stack_ms.mesh": 100.0, "pad_jobs.mesh": 3.0,
               "flush_ms.mesh": 4 * 37 + 1.0, "card_ms.mesh": 37.0,
               "card_overlap.mesh": 1.0},
    "overlapped": {"stack_ms.mesh": 100.0, "pad_jobs.mesh": 0.0,
                   "flush_ms.mesh": 38.0, "card_ms.mesh": 37.0,
                   "card_overlap.mesh": 4.0},
}
CASES = {"serial": SERIAL + OUTSIDE, "overlapped": OVERLAPPED + OUTSIDE,
         "both": SERIAL + OVERLAPPED + OUTSIDE}


def _reader(name):
    return load_module(os.path.join(ROOT, "stitchbench", "metrics",
                                    f"{name}.py"),
                       "test_metric_" + name.replace(".", "_"))


def _ring(monkeypatch, records, capacity=1 << 10, trim=1):
    ring = spans.Ring(capacity, trim)
    for name, job, span, parent, a, b, counts in records:
        ring.append(name, job, span, parent, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", list(CASES))
def test_mesh_reader_on_synthetic_spans(case, name, monkeypatch):
    _ring(monkeypatch, CASES[case])
    want = (WANT[case][name] if case in WANT else
            (WANT["serial"][name] + WANT["overlapped"][name]) / 2)
    assert _reader(name).read(REC) == pytest.approx(want)


def test_a_flush_that_ends_after_the_window_counts_whole(monkeypatch):
    """A flush that starts inside the window counts with every child, the
    ones that start after the window's end too."""
    _ring(monkeypatch, _flush(10, 1950, cards=4))
    assert _reader("card_ms.mesh").read(REC) == pytest.approx(37.0)
    assert _reader("card_overlap.mesh").read(REC) == pytest.approx(1.0)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_reader_gives_none_when_the_window_lost_a_span(name,
                                                            monkeypatch):
    # the ring keeps the last three records: the rest, inside the window,
    # were dropped
    _ring(monkeypatch, SERIAL + OVERLAPPED, capacity=3, trim=0)
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("records", [[], OUTSIDE], ids=["empty", "outside"])
def test_mesh_reader_gives_none_without_a_flush(name, records, monkeypatch):
    _ring(monkeypatch, records)
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("cards,pad", [(1, 3), (3, 3), (4, 2)])
def test_pad_jobs_gives_none_unless_every_flush_filled_every_card(
        cards, pad, monkeypatch):
    """One flush on fewer distinct cards than the cell's 4 (a mesh that
    repeats a device reads 1), or whose 45 jobs and its padding do not
    divide by 4: the reading is None, not that of the others; the timings
    still read."""
    assert mesh_spans.cell_chips("pad_jobs.mesh") == 4
    _ring(monkeypatch, SERIAL + _flush(50, 1500, cards=cards, pad=pad))
    assert _reader("pad_jobs.mesh").read(REC) is None
    assert _reader("card_ms.mesh").read(REC) == pytest.approx(37.0)


@pytest.mark.parametrize("name,want", [
    ("stack_ms.mesh", 100.0), ("flush_ms.mesh", 4 * 37 + 1.0),
    ("pad_jobs.mesh", None), ("card_ms.mesh", None),
    ("card_overlap.mesh", None)])
def test_a_port_whose_spans_carry_no_card_reads_the_flush_only(
        name, want, monkeypatch):
    """The parent's port: ``serve.flush`` counts nothing and no ``batch.*``
    span carries a card.  The readers that need them answer None and do
    not raise."""
    records = [r[:6] + (None,) for r in _flush(10, 1000, cards=4)]
    _ring(monkeypatch, records)
    got = _reader(name).read(REC)
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_reader_gives_none_for_a_port_without_spans(name, monkeypatch):
    _ring(monkeypatch, SERIAL)
    from imagestitching_tpu_torch import runtime

    monkeypatch.delattr(runtime, "spans")
    monkeypatch.setitem(sys.modules,
                        "imagestitching_tpu_torch.runtime.spans", None)
    assert _reader(name).read(REC) is None


def test_mesh_roofline_reads_the_device_time_of_every_card():
    """The formula of ``kernel_roofline.serve``: the summed device time of
    all four cards is its denominator."""
    rec = {"jobs": [{"ok": True}] * 4, "job_bytes": 3_350_000,
           "device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"busy_s": 0.25, "window_s": 1.0, "work_s": 0.008}}
    mesh = Cell(CELL).reader("kernel_roofline.mesh")
    serve = Cell("serve64_1080p.closed64").reader("kernel_roofline.serve")
    assert mesh.read(rec) == pytest.approx(0.05) == serve.read(rec)
    rec["trace"] = None
    assert mesh.read(rec) is None


def test_cell_files_and_entries():
    cell = Cell(CELL)
    one = Cell("serve64_1080p.closed64")
    assert cell.chips == 4 and cell.kind == "closed_server"
    assert cell.params == {"clients": 64, "pool_jobs": 64,
                           "warm_batches": [64], "check_jobs": 64}
    # config 5 as the one-card cell has it, served over the mesh
    for key in ("shapes", "options", "runtime", "correct", "precision"):
        assert cell.config[key] == one.config[key], key
    assert cell.config["server"] == {**one.config["server"],
                                     "use_mesh": True}
    assert cell.config["reduced"] == []
    assert "whichever card drew it" in cell.config["guarantees"]
    assert ([m["name"] for m in cell.metrics(False)]
            == ["jobs_per_s", "setup_s"])
    assert sorted(m["name"] for m in cell.metrics(True)) == sorted(
        NAMES + ["kernel_roofline.mesh"])
    assert all(m["workloads"] == [CELL] and m["moves"] == "jobs_per_s"
               for m in cell.metrics(True))


def test_the_cell_has_no_rehearsal(monkeypatch):
    """Its server spans every CUDA card and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        deploy.server(Cell(CELL).config, "cpu", True)


@pytest.mark.parametrize("jobs", [13, 16])
def test_the_configuration_deploys_on_a_cpu_mesh(jobs):
    """The configuration's server fields and runtime, at config 5's shapes
    divided by 16, on a mesh of four ``cpu`` devices with the plain
    engine: every canvas is held to the float64 reference of its own
    sources, as the cell's check holds it, and no padded zero job's canvas
    comes back."""
    cfg = Cell(CELL).config
    shapes = deploy.shapes(cfg, 16)
    runtime = dataclasses.replace(
        deploy.runtime(cfg, "cpu", True),
        mesh=make_mesh(devices=["cpu"] * 4))
    rng = np.random.default_rng(jobs)
    pool = [[rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in shapes]
            for _ in range(jobs)]
    server_fields = {**cfg["server"], "max_batch": jobs, "max_wait_s": 5.0}
    options = deploy.options(cfg)
    orient = [o for _, _, o in shapes]
    with StitchServer(**server_fields, engine="torch",
                      config=runtime) as server:
        futs = [server.submit(imgs, options, orientations=orient)
                for imgs in pool]
        outs = [f.result(timeout=60) for f in futs]
    positions = [harness.batch_position(out) for out in outs]
    assert sorted(positions) == list(range(jobs))
    assert {out.base.shape[0] for out in outs} == {-(-jobs // 4) * 4}
    for imgs, out in zip(pool, outs):
        got = compare(deploy.layout(cfg, shapes), imgs, out)
        assert got["resampled_max_diff"] <= cfg["correct"][
            "resampled_max_diff"]
        assert got["exact_max_diff"] == 0
