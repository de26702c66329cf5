"""The reader of ``readback_pinned_new.job``: the mean ``pinned_new`` count
of the window's ``readback`` spans, and None where the window holds no
such count (a port whose readback does not count its pinned blocks)."""

import os

import pytest

from stitchbench.harness import ROOT, load_module
from imagestitching_tpu_torch.runtime import spans

MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms


def _read(monkeypatch, records):
    ring = spans.Ring(1 << 10, 1)
    for k, (name, a, b, counts) in enumerate(records):
        ring.append(name, 1 + k, 10 + k, 0, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)
    reader = load_module(os.path.join(ROOT, "stitchbench", "metrics",
                                      "readback_pinned_new.job.py"),
                         "test_metric_readback_pinned_new_job")
    return reader.read(REC)


def _readback(a, pinned_new):
    return ("readback", a, a + 10, {"pinned_new": pinned_new,
                                    "new_pages": 65536 * pinned_new})


@pytest.mark.parametrize("records,want", [
    # one miss in four readbacks; one before the window does not count
    ([_readback(900, 1), _readback(1000, 1), _readback(1100, 0),
      _readback(1200, 0), _readback(1300, 0)], 0.25),
    # the parent's readback: pages counted, no pinned blocks
    ([("readback", 1000, 1010, {"new_pages": 59946}), ("drain", 990, 1000,
                                                       None)], None),
    ([("drain", 1000, 1010, None)], None),
], ids=["one-miss-in-four", "pages-alone", "no-readback"])
def test_readback_pinned_new_reads_the_miss_share(records, want,
                                                  monkeypatch):
    got = _read(monkeypatch, records)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
