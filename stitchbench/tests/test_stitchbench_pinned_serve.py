"""The reader of ``readback_pinned_new.serve``: the mean ``pinned_new``
count of the window's ``batch.host`` spans, and None where the window
holds no such span (a port whose flush does not take its host array in a
span)."""

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
                                      "readback_pinned_new.serve.py"),
                         "test_metric_readback_pinned_new_serve")
    return reader.read(REC)


def _host(a, pinned_new):
    return ("batch.host", a, a + 1, {"pinned_new": pinned_new})


def _readback(a, card):
    return ("batch.readback", a + 1, a + 5, {"card": card})


@pytest.mark.parametrize("records,want", [
    # one fresh block in four flushes; one before the window does not
    # count, nor do the flushes' readbacks
    ([_host(900, 1), _host(1000, 1), _readback(1000, 0), _host(1100, 0),
      _host(1200, 0), _host(1300, 0), _readback(1300, 0)], 0.25),
    # a flush that grew the pool by two blocks
    ([_host(1000, 2), _host(1100, 0)], 1.0),
    # the parent's flush: readbacks and no host span
    ([("serve.flush", 1000, 1010, {"jobs": 4, "pad_jobs": 0, "cards": 1}),
      _readback(1000, 0)], None),
    ([("serve.flush", 1000, 1010, None)], None),
], ids=["one-fresh-in-four", "two-blocks", "readbacks-alone", "no-batch"])
def test_readback_pinned_new_serve_reads_the_fresh_blocks(records, want,
                                                          monkeypatch):
    got = _read(monkeypatch, records)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)
