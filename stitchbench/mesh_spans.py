"""A server's flushes over a run's measured window, card by card, from the
port's spans (``imagestitching_tpu_torch.runtime.spans``), for the
per-layer metrics of a cell served over a jobs mesh.

A flush is a ``serve.flush`` span that starts inside the window, with its
direct children: ``serve.stack`` and, per shard or device, ``batch.h2d``,
``batch.draw``, ``batch.sync`` and ``batch.readback``, each counting
``card`` (its index on the jobs axis).  A flush counts ``jobs``,
``pad_jobs`` and ``cards``.  A child may start after the window's end, in a
flush that started before it, and counts with its flush.

Each reading is a mean over the window's flushes, or None, never a partial
number: where the port keeps no spans, where a record that met the window
was dropped from the port's ring, where the window holds no flush, or where
a flush lacks what the reading needs (a port whose spans carry no card).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple

from .harness import ROOT, load_json
from .port_spans import _covered

BATCH = ("batch.h2d", "batch.draw", "batch.sync", "batch.readback")
#: Later than any ``perf_counter_ns`` reading: a flush's children are
#: looked up to its end, wherever the window ends.
_NEVER = 1 << 62


def flushes(rec) -> Optional[List[Tuple[object, list]]]:
    """Each ``serve.flush`` record that starts inside the window, with its
    direct children; None where there are none or a record was dropped."""
    try:
        from imagestitching_tpu_torch.runtime import spans
    except ImportError:          # a port that records no spans
        return None
    lo, hi = int(rec["t0"] * 1e9), int(rec["t_end"] * 1e9)
    records, dropped = spans.snapshot(lo, _NEVER)
    if dropped:
        return None
    out = {r.span: (r, []) for r in records
           if r.name == "serve.flush" and lo <= r.start_ns <= hi}
    for r in records:
        if r.parent in out:
            out[r.parent][1].append(r)
    return list(out.values()) or None


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def per_flush(rec, fn: Callable) -> Optional[float]:
    """Mean over the window's flushes of ``fn(flush, children)``; None
    where ``fn`` gives None for any of them."""
    found = flushes(rec)
    if found is None:
        return None
    vals = [fn(f, kids) for f, kids in found]
    if any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def stack_ms(flush, kids) -> Optional[float]:
    """Milliseconds of the flush's ``serve.stack``."""
    stacks = [_ms(r) for r in kids if r.name == "serve.stack"]
    return sum(stacks) if stacks else None


def card_spans(kids) -> Optional[Dict[int, list]]:
    """The flush's ``batch.*`` spans by their ``card``; None where there
    are none or one carries no card."""
    batch = [r for r in kids if r.name in BATCH]
    if not batch or any(not r.counts or "card" not in r.counts
                        for r in batch):
        return None
    by_card: Dict[int, list] = {}
    for r in batch:
        by_card.setdefault(r.counts["card"], []).append(r)
    return by_card


def card_ms(flush, kids) -> Optional[float]:
    """Mean over the flush's cards of each card's summed ``batch.*``
    milliseconds."""
    by_card = card_spans(kids)
    if by_card is None:
        return None
    return sum(sum(map(_ms, rs)) for rs in by_card.values()) / len(by_card)


def card_overlap(flush, kids) -> Optional[float]:
    """The flush's summed ``batch.*`` time over the union of those spans'
    intervals: 1.0 where the cards are served one after another, n where
    n cards are served all at once."""
    by_card = card_spans(kids)
    if by_card is None:
        return None
    batch = [r for rs in by_card.values() for r in rs]
    lo = min(r.start_ns for r in batch)
    hi = max(r.end_ns for r in batch)
    union = _covered(lo, hi, [(r.start_ns, r.end_ns) for r in batch])
    if not union:
        return None
    return sum(r.end_ns - r.start_ns for r in batch) / union


def cell_chips(metric: str) -> Optional[int]:
    """The chips of the cells that ``BENCHMARK.json`` lists for
    ``metric``, where they all ask for the same number."""
    spec = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = [m.get("workloads") for m in spec["per_layer"]
             if m["name"] == metric]
    chips = {w["chips"] for w in spec["workloads"]
             if cells and cells[0] and w["name"] in cells[0]}
    return chips.pop() if len(chips) == 1 else None
