"""The readers of the port's spans (``stitchbench/port_spans.py`` and the
seven metrics that use it): their values on synthetic spans, None where a
span of the window was dropped or the spans are missing, and every reading
in a rehearsal of each cell."""

import json
import os
import subprocess
import sys

import pytest

from stitchbench.harness import ROOT, load_module
from imagestitching_tpu_torch.runtime import spans

MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms

# (name, job, span, parent, start ms, end ms, counts)
PHONE = [
    # outside the window: a root that starts before it, and its spans
    ("stitch", 3, 90, 0, 900, 1100, None),
    ("stage.pin_copy", 3, 91, 90, 1005, 1050, None),
    # job 1: two sources
    ("stitch", 1, 1, 0, 1000, 1200, None),
    ("plan", 1, 2, 1, 1000, 1010, None),
    ("decode", 1, 3, 1, 1005, 1020, None),
    ("stage.slot_wait", 1, 4, 1, 1020, 1022, None),
    ("stage.pin_copy", 1, 5, 1, 1022, 1030, None),
    ("stage.enqueue", 1, 6, 1, 1030, 1031, None),
    ("draw", 1, 7, 1, 1031, 1032, None),
    ("stage.fence", 1, 8, 1, 1032, 1040, None),
    ("stage.slot_wait", 1, 9, 1, 1040, 1043, None),
    ("stage.pin_copy", 1, 10, 1, 1043, 1050, None),
    ("drain", 1, 11, 1, 1050, 1060, None),
    ("readback", 1, 12, 1, 1060, 1190, {"new_pages": 100}),
    # job 2: one source, gaps between its phases
    ("stitch", 2, 20, 0, 1300, 1400, None),
    ("stage.pin_copy", 2, 21, 20, 1310, 1320, None),
    ("stage.slot_wait", 2, 22, 20, 1320, 1321, None),
    ("readback", 2, 23, 20, 1330, 1390, {"new_pages": 300}),
]
SERVE = [
    ("serve.flush", 0, 90, 0, 900, 1100, None),
    ("batch.h2d", 0, 91, 90, 1000, 1050, None),
    ("serve.flush", 0, 10, 0, 1000, 1700, None),
    ("serve.stack", 0, 11, 10, 1000, 1300, None),
    ("batch.h2d", 0, 12, 10, 1301, 1400, None),
    ("batch.draw", 0, 13, 10, 1400, 1401, None),
    ("batch.sync", 0, 14, 10, 1402, 1405, None),
    ("batch.readback", 0, 15, 10, 1406, 1690, None),
    ("serve.queue", 5, 16, 10, 990, 1000, None),
    # a flush of two jobs shards: two uploads
    ("serve.flush", 0, 30, 0, 1750, 1950, None),
    ("serve.stack", 0, 31, 30, 1750, 1800, None),
    ("batch.h2d", 0, 32, 30, 1800, 1850, None),
    ("batch.h2d", 0, 33, 30, 1850, 1860, None),
    ("batch.draw", 0, 34, 30, 1860, 1870, None),
    ("batch.sync", 0, 35, 30, 1870, 1872, None),
    ("batch.readback", 0, 36, 30, 1872, 1940, None),
]

READINGS = [
    ("pin_copy_ms.job", PHONE, (8 + 7 + 10) / 2),
    ("slot_wait_ms.job", PHONE, (2 + 3 + 1) / 2),
    ("readback_pages.job", PHONE, (100 + 300) / 2),
    # job 1's children cover 190 of its 200 ms, job 2's 71 of its 100
    ("untraced_ms.job", PHONE, (10 + 29) / 2),
    ("h2d_ms.serve", SERVE, (99 + 60) / 2),
    ("sync_ms.serve", SERVE, (3 + 2) / 2),
    ("readback_ms.serve", SERVE, (284 + 68) / 2),
]
NAMES = [name for name, _, _ in READINGS]


def _reader(name):
    return load_module(os.path.join(ROOT, "stitchbench", "metrics",
                                    f"{name}.py"),
                       "test_metric_" + name.replace(".", "_"))


def _ring(monkeypatch, records, capacity=1 << 10, trim=1):
    ring = spans.Ring(capacity, trim)
    for name, job, span, parent, a, b, counts in records:
        ring.append(name, job, span, parent, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)


@pytest.mark.parametrize("name,records,want", READINGS, ids=NAMES)
def test_reader_on_synthetic_spans(name, records, want, monkeypatch):
    _ring(monkeypatch, records)
    assert _reader(name).read(REC) == pytest.approx(want)


@pytest.mark.parametrize("name,records,want", READINGS, ids=NAMES)
def test_reader_gives_none_when_the_window_lost_a_span(name, records, want,
                                                       monkeypatch):
    del want
    # the ring keeps the last three records: the rest, inside the window,
    # were dropped
    _ring(monkeypatch, records, capacity=3, trim=0)
    assert len(spans.snapshot(0, 3000 * MS)[0]) == 3
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("records", [[], PHONE[:2] + SERVE[:2]],
                         ids=["empty", "outside"])
@pytest.mark.parametrize("name", NAMES)
def test_reader_gives_none_when_the_spans_are_missing(name, records,
                                                      monkeypatch):
    _ring(monkeypatch, records)
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("name,records,want", READINGS, ids=NAMES)
def test_reader_gives_none_for_a_port_without_spans(name, records, want,
                                                    monkeypatch):
    """A port that records no spans (the module is missing): the reader
    answers None instead of raising."""
    del want
    _ring(monkeypatch, records)
    from imagestitching_tpu_torch import runtime

    monkeypatch.delattr(runtime, "spans")
    monkeypatch.setitem(sys.modules,
                        "imagestitching_tpu_torch.runtime.spans", None)
    assert _reader(name).read(REC) is None


@pytest.mark.parametrize("cell", ["phone12mp_exif.arrays",
                                  "serve64_1080p.closed64"])
def test_rehearsal_prints_every_new_reading(cell):
    out = subprocess.run(
        [sys.executable, "stitchbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0", "--rehearse"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [t for t in out.stderr.splitlines()
            if t.startswith("stitchbench: readings ")][-1]
    readings = json.loads(line.split(" ", 2)[2])
    mine = [name for name, records, _ in READINGS
            if (records is PHONE) == cell.startswith("phone")]
    assert all(readings[name] is not None for name in mine), readings
