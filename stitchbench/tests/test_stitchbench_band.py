"""The cell ``phone48mp_max.arrays`` and its seven ``.band`` readers: the
cell's files and entries, each span or count reader's value on synthetic
spans of the port's banded rung, None where a span of the window was
dropped, where the spans are missing (a port whose banded rung records
none) or where the port keeps no spans, and the two device readers on a
synthetic trace."""

import sys

import pytest

from stitchbench.harness import Cell
from imagestitching_tpu_torch.runtime import spans

CELL = "phone48mp_max.arrays"
MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms

# (name, job, span, parent, start ms, end ms, counts)
BAND = [
    # outside the window: a root that starts before it, and its spans
    ("stitch", 3, 90, 0, 900, 1100, None),
    ("banded", 3, 91, 90, 950, 1090, {"chunks": 35, "band_rows": 2048}),
    ("band.fill", 3, 92, 91, 950, 960, None),
    # job 1: one identity placement, one resampled in two chunks
    ("stitch", 1, 1, 0, 1100, 1400, None),
    ("plan", 1, 2, 1, 1100, 1101, None),
    ("banded", 1, 3, 1, 1110, 1390, {"chunks": 2, "band_rows": 2048}),
    ("band.fill", 1, 4, 3, 1110, 1150, None),
    ("band.blit", 1, 5, 3, 1150, 1160, None),
    ("band.prepare", 1, 6, 3, 1160, 1162, None),
    ("band.crop", 1, 7, 3, 1162, 1170, {"bytes": 100}),
    ("band.h2d", 1, 8, 3, 1170, 1175, {"bytes": 100}),
    ("band.draw", 1, 9, 3, 1175, 1176, None),
    ("band.readback", 1, 10, 3, 1176, 1190, None),
    ("band.crop", 1, 11, 3, 1190, 1202, {"bytes": 100}),
    ("band.h2d", 1, 12, 3, 1202, 1208, {"bytes": 100}),
    ("band.draw", 1, 13, 3, 1208, 1209, None),
    ("band.readback", 1, 14, 3, 1209, 1225, None),
    # job 2: one resampled placement in four chunks, summed as one
    ("stitch", 2, 20, 0, 1500, 1900, None),
    ("banded", 2, 21, 20, 1510, 1890, {"chunks": 4, "band_rows": 512}),
    ("band.fill", 2, 22, 21, 1510, 1570, None),
    ("band.crop", 2, 23, 21, 1580, 1600, {"bytes": 400}),
    ("band.h2d", 2, 24, 21, 1600, 1610, {"bytes": 400}),
    ("band.readback", 2, 25, 21, 1610, 1640, None),
]
READINGS = [
    ("fill_ms.band", (40 + 60) / 2),
    ("crop_ms.band", (8 + 12 + 20) / 2),
    ("h2d_ms.band", (5 + 6 + 10) / 2),
    ("readback_ms.band", (14 + 16 + 30) / 2),
    ("chunks.band", (2 + 4) / 2),
]
NAMES = [name for name, _ in READINGS]
DEVICE = ["kernel_roofline.band", "idle_share.band"]


def _reader(name):
    return Cell(CELL).reader(name)


def _ring(monkeypatch, records, capacity=1 << 10, trim=1):
    ring = spans.Ring(capacity, trim)
    for name, job, span, parent, a, b, counts in records:
        ring.append(name, job, span, parent, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)


def test_cell_files_and_entries():
    cell = Cell(CELL)
    phone = Cell("phone12mp_exif.arrays")
    assert cell.chips == 1 and cell.kind == "closed_stitch"
    assert cell.params == {"inputs": "arrays", "pool_jobs": 2,
                           "check_jobs": 2, "rehearsal": {"scale": 16}}
    assert cell.config["shapes"] == [
        [8064, 6048, o] for o in (1, 6, 3, 8, 1, 5, 2, 7, 4)]
    assert cell.config["options"] == {"direction": "vertical",
                                      "mode": "max", "gap": 4}
    assert cell.config["runtime"] == {"budget": "default"}
    assert cell.config["reduced"] == []
    for key in ("precision", "guarantees"):
        assert cell.config[key] == phone.config[key], key
    correct = cell.config["correct"]
    assert (correct["resampled_max_diff"], correct["exact_max_diff"]) == (1,
                                                                          0)
    assert ([m["name"] for m in cell.metrics(False)]
            == ["job_ms_p50", "setup_s"])
    assert sorted(m["name"] for m in cell.metrics(True)) == sorted(
        NAMES + DEVICE)
    assert all(m["workloads"] == [CELL] and m["moves"] == "job_ms_p50"
               for m in cell.metrics(True))


@pytest.mark.parametrize("name,want", READINGS, ids=NAMES)
def test_reader_on_synthetic_spans(name, want, monkeypatch):
    _ring(monkeypatch, BAND)
    assert _reader(name).read(REC) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_when_the_window_lost_a_span(name, monkeypatch):
    # the ring keeps the last three records: the rest, inside the window,
    # were dropped
    _ring(monkeypatch, BAND, capacity=3, trim=0)
    assert len(spans.snapshot(0, 3000 * MS)[0]) == 3
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_when_the_spans_are_missing(name, monkeypatch):
    """The parent's banded rung: a ``banded`` span without counts and no
    ``band.*`` spans."""
    _ring(monkeypatch, [r[:6] + (None,) for r in BAND
                        if not r[0].startswith("band.")])
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_for_a_port_without_spans(name, monkeypatch):
    _ring(monkeypatch, BAND)
    from imagestitching_tpu_torch import runtime

    monkeypatch.delattr(runtime, "spans")
    monkeypatch.setitem(sys.modules,
                        "imagestitching_tpu_torch.runtime.spans", None)
    assert _reader(name).read(REC) is None


def test_device_readers_on_a_synthetic_trace():
    """``kernel_roofline.band`` is ``kernel_roofline.job``'s formula: 4
    jobs of 3.35 GB at 3.35 TB/s bound 4 ms of 8 ms of device work."""
    rec = {"jobs": [{"ok": True}] * 4 + [{"ok": False}],
           "job_bytes": 3_350_000_000,
           "device_kind": "NVIDIA H100 80GB HBM3",
           "trace": {"busy_s": 0.25, "window_s": 1.0, "work_s": 0.008}}
    band = _reader("kernel_roofline.band")
    job = Cell("phone12mp_exif.arrays").reader("kernel_roofline.job")
    assert band.read(rec) == pytest.approx(50.0) == job.read(rec)
    assert _reader("idle_share.band").read(rec) == pytest.approx(75.0)
    rec["device_kind"] = "another card"
    assert band.read(rec) is None
    rec["trace"] = None
    assert band.read(rec) is None
    assert _reader("idle_share.band").read(rec) is None
