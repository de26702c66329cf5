"""The bytes a stitch must move on the device, and the peaks they are
held against.

Counted from the layout alone (the frozen reference's taps), never from
what a kernel reads.  A resampling rect: each source byte under a tap of
non-zero weight read once, each byte of the rect written once (a frozen
copy of ``chip_smoke.py``'s ``footprint_bytes`` / ``bound_ms``).  A
copying rect (rotated or not): its bytes read once and written once.  The
background around the rects: written once.
"""

from __future__ import annotations

import numpy as np

from .reference.layout import Layout
from .reference.stitch import is_copy, rect_taps

#: HBM bytes/s by the name ``torch.cuda.get_device_name()`` gives (NVIDIA's
#: data sheet, SXM part, at the full 700 W power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def _touched(t) -> int:
    i0, i1, w1 = t
    keep = np.concatenate([i0, i1[(w1 > 0) & (i1 > i0)]])
    return int(np.unique(keep).size)


def resample_bytes(layout: Layout, channels: int = 3) -> int:
    """Bytes one job's resampling rects need: tap footprint read once plus
    the rect written once."""
    total = 0
    for r in layout.rects:
        (r0, r1), (c0, c1) = r.row_span, r.col_span
        if r1 <= r0 or c1 <= c0 or is_copy(r):
            continue
        rows, cols = rect_taps(r)
        total += (_touched(rows) * _touched(cols) + (r1 - r0) * (c1 - c0)) \
            * channels
    return total


def job_bytes(layout: Layout, channels: int = 3) -> int:
    """Bytes of one job's whole device work: the resampling rects
    (:func:`resample_bytes`), each copying rect read once and written once,
    and the background around the rects written once."""
    total = resample_bytes(layout, channels)
    covered = 0
    for r in layout.rects:
        (r0, r1), (c0, c1) = r.row_span, r.col_span
        if r1 <= r0 or c1 <= c0:
            continue
        covered += (r1 - r0) * (c1 - c0)
        if is_copy(r):
            total += 2 * (r1 - r0) * (c1 - c0) * channels
    return total + (layout.canvas_h * layout.canvas_w - covered) * channels


def bound_s(nbytes: int, device_name: str):
    """The least seconds the card could take to move ``nbytes``, or None
    for a card without an entry in the table."""
    peak = HBM_BYTES_PER_S.get(device_name)
    return None if peak is None else nbytes / peak
