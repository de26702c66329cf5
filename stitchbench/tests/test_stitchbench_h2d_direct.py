"""The reader of ``h2d_direct.serve``: the mean ``direct`` count of the
window's ``batch.h2d`` spans (1 an upload of rows copied from the jobs'
own arrays, 0 one of whole stacks), and None where the window holds no
such count (a port whose uploads do not count it) or lost a record."""

import os

import pytest

from stitchbench.harness import ROOT, load_module
from imagestitching_tpu_torch.runtime import spans

MS = 1_000_000
REC = {"t0": 1.0, "t_end": 2.0}          # the window [1000, 2000] ms


def _read(monkeypatch, records, capacity=1 << 10, trim=1):
    ring = spans.Ring(capacity, trim)
    for k, (name, a, b, counts) in enumerate(records):
        ring.append(name, 0, 10 + k, 0, a * MS, b * MS, counts)
    monkeypatch.setattr(spans, "RING", ring)
    reader = load_module(os.path.join(ROOT, "stitchbench", "metrics",
                                      "h2d_direct.serve.py"),
                         "test_metric_h2d_direct_serve")
    return reader.read(REC)


def _h2d(a, direct=None, card=0):
    counts = {"card": card}
    if direct is not None:
        counts["direct"] = direct
    return ("batch.h2d", a, a + 10, counts)


@pytest.mark.parametrize("records,want", [
    # every card's upload direct; one before the window does not count
    ([_h2d(900, 0), _h2d(1000, 1), _h2d(1100, 1, 1), _h2d(1200, 1, 2),
      _h2d(1300, 1, 3)], 1.0),
    ([_h2d(1000, 1), _h2d(1100, 0), _h2d(1200, 0), _h2d(1300, 1)], 0.5),
    ([_h2d(1000, 0), ("batch.draw", 1010, 1011, {"card": 0})], 0.0),
    # the parent's uploads: a card, no direct count
    ([_h2d(1000), _h2d(1100, card=1), ("serve.stack", 990, 1000, None)],
     None),
    ([("serve.flush", 1000, 1500, {"jobs": 3})], None),
    ([], None),
], ids=["all-direct", "mixed", "stacks", "parent", "no-upload", "empty"])
def test_h2d_direct_reads_the_direct_share(records, want, monkeypatch):
    got = _read(monkeypatch, records)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_h2d_direct_gives_none_when_the_window_lost_a_span(monkeypatch):
    records = [_h2d(1000 + 100 * k, 1) for k in range(5)]
    # the ring keeps the last two records; the rest, inside the window,
    # were dropped
    assert _read(monkeypatch, records, capacity=2, trim=0) is None
