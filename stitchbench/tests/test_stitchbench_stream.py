"""The cell ``phone48mp_h6_max.arrays`` and its readers: the cell's files
and entries; its three ``.stream`` readers (the streamed rung's
``stream.*`` phases) and the accepted ``.job`` readers it shares with the
12 MP phone cell, each on synthetic spans and jobs of the port's plain
path (``prepare``, the rung, ``readback``); None where a span of the
window was dropped, where the spans are missing (a port whose plain path
records none) or where the port keeps no spans; and the two device readers
on a synthetic trace."""

import sys

import pytest

from stitchbench.harness import Cell
from imagestitching_tpu_torch.runtime import spans

CELL = "phone48mp_h6_max.arrays"
MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms

# (name, job, span, parent, start ms, end ms, counts)
STREAM = [
    # outside the window: a root that starts before it, and its spans
    ("stitch", 3, 90, 0, 900, 1100, None),
    ("prepare", 3, 91, 90, 900, 910, {"images": 6}),
    ("streamed", 3, 92, 90, 920, 1080, {"sources": 6, "fences": 1,
                                        "bytes": 600}),
    ("stream.h2d", 3, 93, 92, 921, 950, {"bytes": 100}),
    ("readback", 3, 94, 90, 1080, 1099, {"pinned_new": 0}),
    # job 1: two sources, a fence after the second
    ("stitch", 1, 1, 0, 1100, 1400, None),
    ("prepare", 1, 2, 1, 1100, 1104, {"images": 2}),
    ("streamed", 1, 3, 1, 1110, 1300, {"sources": 2, "fences": 1,
                                       "bytes": 200}),
    ("stream.h2d", 1, 4, 3, 1111, 1150, {"bytes": 100}),
    ("stream.draw", 1, 5, 3, 1150, 1152, {"kernel": 1}),
    ("stream.h2d", 1, 6, 3, 1152, 1200, {"bytes": 100}),
    ("stream.draw", 1, 7, 3, 1200, 1201, {"kernel": 0}),
    ("stream.fence", 1, 8, 3, 1201, 1210, None),
    ("readback", 1, 9, 1, 1300, 1330, {"pinned_new": 1, "new_pages": 9}),
    # job 2: one source, no fence
    ("stitch", 2, 20, 0, 1500, 1900, None),
    ("prepare", 2, 21, 20, 1500, 1506, {"images": 1}),
    ("streamed", 2, 22, 20, 1510, 1890, {"sources": 1, "fences": 0,
                                         "bytes": 100}),
    ("stream.h2d", 2, 23, 22, 1511, 1560, {"bytes": 100}),
    ("stream.draw", 2, 24, 22, 1560, 1563, {"kernel": 1}),
    ("readback", 2, 25, 20, 1890, 1900, {"pinned_new": 0, "new_pages": 0}),
]
READINGS = [
    ("h2d_ms.stream", (39 + 48 + 49) / 2),
    ("draw_ms.stream", (2 + 1 + 3) / 2),
    ("fence_ms.stream", (9 + 0) / 2),
    # every readback that starts in the window, job 3's too
    ("readback_pinned_new.job", (0 + 1 + 0) / 3),
    ("readback_pages.job", (9 + 0) / 2),
    # each root less its direct children: 300 - (4 + 190 + 30), 400 -
    # (6 + 380 + 10)
    ("untraced_ms.job", (76 + 4) / 2),
]
NAMES = [name for name, _ in READINGS]
STREAM_NAMES = ["h2d_ms.stream", "draw_ms.stream", "fence_ms.stream"]
# the spans a parent's plain path lacks
MISSING = STREAM_NAMES + ["readback_pinned_new.job", "readback_pages.job"]
JOB = ["prepare_ms.job", "readback_ms.job"]
DEVICE = ["kernel_roofline.job", "idle_share.job"]
SHARED = ["phone12mp_exif.arrays", CELL]


def _reader(name):
    return Cell(CELL).reader(name)


def _ring(monkeypatch, records, capacity=1 << 10, trim=1):
    ring = spans.Ring(capacity, trim)
    for name, job, span, parent, a, b, counts in records:
        ring.append(name, job, span, parent, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)


def test_cell_files_and_entries():
    cell = Cell(CELL)
    nine = Cell("phone48mp_max.arrays")
    assert cell.chips == 1 and cell.kind == "closed_stitch"
    assert cell.params == {"inputs": "arrays", "pool_jobs": 2,
                           "check_jobs": 2, "rehearsal": {"scale": 16}}
    assert cell.config["shapes"] == [
        [8064, 6048, o] for o in (1, 6, 3, 8, 1, 5)]
    assert cell.config["options"] == {"direction": "horizontal",
                                      "mode": "max", "gap": 4}
    assert cell.config["runtime"] == {"budget": "default"}
    (entry,) = [c for c in cell.spec["configs"]
                if c["name"] == cell.entry["config"]]
    assert cell.config["reduced"] == [] == entry["reduced"]
    assert entry["source"] == cell.config["source"]
    for key in ("precision", "guarantees"):
        assert cell.config[key] == nine.config[key], key
    correct = cell.config["correct"]
    assert (correct["resampled_max_diff"], correct["exact_max_diff"]) == (1,
                                                                          0)
    assert ([m["name"] for m in cell.metrics(False)]
            == ["job_ms_p50", "setup_s"])
    assert sorted(m["name"] for m in cell.metrics(True)) == sorted(
        NAMES + JOB + DEVICE)
    assert all(m["moves"] == "job_ms_p50" for m in cell.metrics(True))
    lists = {m["name"]: m["workloads"] for m in cell.metrics(True)}
    assert lists == {name: [CELL] if name in STREAM_NAMES else SHARED
                     for name in lists}
    layers = {m["name"]: m["layer"] for m in cell.metrics(True)}
    assert {layers[n] for n in STREAM_NAMES} == {
        "runtime.pipeline (streamed rung)"}
    # every other layer is one the benchmark already names
    named = {m["layer"] for m in cell.spec["per_layer"]
             if m["name"] not in STREAM_NAMES}
    assert set(layers.values()) - named == {
        "runtime.pipeline (streamed rung)"}


@pytest.mark.parametrize("name,want", READINGS, ids=NAMES)
def test_reader_on_synthetic_spans(name, want, monkeypatch):
    _ring(monkeypatch, STREAM)
    assert _reader(name).read(REC) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_when_the_window_lost_a_span(name, monkeypatch):
    # the ring keeps the last three records: the rest, inside the window,
    # were dropped
    _ring(monkeypatch, STREAM, capacity=3, trim=0)
    assert len(spans.snapshot(0, 3000 * MS)[0]) == 3
    assert _reader(name).read(REC) is None


def test_job_readers_on_synthetic_jobs():
    """``prepare_ms.job`` and ``readback_ms.job`` read ``StitchMetrics``,
    whose ``prepare_s`` and ``readback_s`` the plain path takes from its
    ``prepare`` and ``readback`` spans."""
    rec = {"jobs": [{"ok": True, "m": {"prepare_s": 0.004,
                                       "readback_s": 0.030}},
                    {"ok": True, "m": {"prepare_s": 0.006,
                                       "readback_s": 0.010}},
                    {"ok": False, "m": None}]}
    assert _reader("prepare_ms.job").read(rec) == pytest.approx(5.0)
    assert _reader("readback_ms.job").read(rec) == pytest.approx(20.0)


@pytest.mark.parametrize("name", MISSING)
def test_reader_gives_none_when_the_spans_are_missing(name, monkeypatch):
    """The parent's plain path: a ``streamed`` span without counts, and no
    ``prepare``, ``stream.*`` or ``readback`` spans."""
    _ring(monkeypatch, [r[:6] + (None,) for r in STREAM
                        if r[0] in ("stitch", "streamed")])
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_for_a_port_without_spans(name, monkeypatch):
    _ring(monkeypatch, STREAM)
    from imagestitching_tpu_torch import runtime

    monkeypatch.delattr(runtime, "spans")
    monkeypatch.setitem(sys.modules,
                        "imagestitching_tpu_torch.runtime.spans", None)
    assert _reader(name).read(REC) is None


def test_device_readers_on_a_synthetic_trace():
    """``kernel_roofline.job``: 4 jobs of 3.35 GB at 3.35 TB/s bound 4 ms
    of 8 ms of device work."""
    rec = {"jobs": [{"ok": True}] * 4 + [{"ok": False}],
           "job_bytes": 3_350_000_000,
           "device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"busy_s": 0.25, "window_s": 1.0, "work_s": 0.008}}
    roofline = _reader("kernel_roofline.job")
    idle = _reader("idle_share.job")
    assert roofline.read(rec) == pytest.approx(50.0)
    assert idle.read(rec) == pytest.approx(75.0)
    rec["device_kind"] = "another card"
    assert roofline.read(rec) is None
    rec["trace"] = None
    assert roofline.read(rec) is None
    assert idle.read(rec) is None
