"""The port's own spans (``imagestitching_tpu_torch.runtime.spans``) over
a run's measured window, for the per-layer metrics that read them.

Each function takes the run's record, whose ``t0`` and ``t_end`` are
``time.perf_counter`` seconds, the clock the port times its spans with.
Only spans that start inside the window count.  Each returns None, never a
partial number, where the port keeps no spans, where a span that met the
window was dropped from the port's ring, or where the window holds none of
the spans the metric reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def window(rec) -> Optional[list]:
    """The port's records that start inside the window, or None."""
    try:
        from imagestitching_tpu_torch.runtime import spans
    except ImportError:          # a port that records no spans
        return None
    lo, hi = int(rec["t0"] * 1e9), int(rec["t_end"] * 1e9)
    records, dropped = spans.snapshot(lo, hi)
    if dropped:
        return None
    return [r for r in records if lo <= r.start_ns <= hi]


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def _mean_sums(groups: Dict[int, float], found: int) -> Optional[float]:
    if not groups or not found:
        return None
    return sum(groups.values()) / len(groups)


def per_parent_ms(rec, parent: str, child: str) -> Optional[float]:
    """Mean over the window's ``parent`` spans of the summed milliseconds
    of their ``child`` spans."""
    records = window(rec)
    if records is None:
        return None
    sums = {r.span: 0.0 for r in records if r.name == parent}
    found = 0
    for r in records:
        if r.name == child and r.parent in sums:
            sums[r.parent] += _ms(r)
            found += 1
    return _mean_sums(sums, found)


def per_job_ms(rec, root: str, name: str) -> Optional[float]:
    """Mean over the window's root spans called ``root`` of the summed
    milliseconds of their job's spans called ``name``."""
    records = window(rec)
    if records is None:
        return None
    sums = {r.job: 0.0 for r in records if r.name == root and not r.parent}
    found = 0
    for r in records:
        if r.name == name and r.job in sums:
            sums[r.job] += _ms(r)
            found += 1
    return _mean_sums(sums, found)


def mean_count(rec, name: str, key: str) -> Optional[float]:
    """Mean of the count ``key`` over the window's spans called ``name``."""
    records = window(rec)
    if records is None:
        return None
    vals = [r.counts[key] for r in records
            if r.name == name and r.counts and key in r.counts]
    return sum(vals) / len(vals) if vals else None


def _covered(lo: int, hi: int, intervals: List[tuple]) -> int:
    """Nanoseconds of [lo, hi] that the union of ``intervals`` covers."""
    covered, cur = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, cur), min(b, hi)
        if b > a:
            covered += b - a
            cur = b
    return covered


def self_ms(rec, root: str) -> Optional[float]:
    """Mean over the window's root spans called ``root`` of their self
    time: the duration less the union of their direct children's
    intervals."""
    records = window(rec)
    if records is None:
        return None
    roots = [r for r in records if r.name == root and not r.parent]
    children: Dict[int, List[tuple]] = {r.span: [] for r in roots}
    for r in records:
        if r.parent in children:
            children[r.parent].append((r.start_ns, r.end_ns))
    if not roots or not any(children.values()):
        return None
    return sum((r.end_ns - r.start_ns
                - _covered(r.start_ns, r.end_ns, children[r.span])) / 1e6
               for r in roots) / len(roots)
