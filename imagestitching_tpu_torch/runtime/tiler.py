"""HBM budget governor: choose an execution strategy that bounds peak memory.

The port's own copy of ``imagestitching_tpu/runtime/tiler.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

TPU-native replacement for the reference's memory-peak machinery — the canvas
side/pixel caps with uniform ``scaleDown`` (pages/index/index.js:1323-1357),
the big-task mode that disables caches and frees bitmaps after every draw
(index.js:1210-1220,1560-1571), and the decoded-bitmap pixel budgets
(index.js:6-7).  Those all *shrink or serialize the user's job*; here the job
stays full-resolution and the governor picks how to schedule it:

* ``resident`` — all sources on device at once, one fused program.  Fastest;
  needs sources + canvas + scratch under budget.
* ``streamed`` — a bounded window of sources on device (the loop prefetches
  image i+1 while i composites, and the pipeline fences staged-but-unconsumed
  uploads against the budget headroom); the canvas persists and is donated
  between per-image updates (the big-task analog, but in-place and without
  flush hacks).  Peak ~= canvas + two sources + a region.
* ``banded``   — output row bands composited one at a time, each from
  host-cropped source bands, result streamed back to the host (the blockwise
  spatial-tiling answer to "canvas larger than HBM", SURVEY.md §5).

Byte accounting is deliberately conservative (canvas counted twice for the
non-donated resident path; padded planar copies counted per image).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from ..config import MemoryBudget
from ..core import geometry
from ..core.layout import LayoutPlan, Placement


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _src_bytes(p: Placement, channels: int) -> int:
    """Device bytes for one staged source: raw HWC + oriented padded CHW."""
    disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    padded = _round_up(disp_h, 8) * _round_up(disp_w, 128)
    return channels * (p.raw_w * p.raw_h + padded)


def _region_bytes(p: Placement, channels: int) -> int:
    nr = max(0, p.row_span[1] - p.row_span[0])
    nc = max(0, p.col_span[1] - p.col_span[0])
    return channels * _round_up(max(1, nr), 256) * _round_up(max(1, nc), 512)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    strategy: str                   # "resident" | "streamed" | "banded"
    est_peak_bytes: int
    budget_bytes: int
    band_rows: Optional[int] = None  # for "banded"


def resident_peak_bytes(plan: LayoutPlan, channels: int = 3) -> int:
    """Conservative device peak of one resident job (canvas counted twice:
    the program is not donated)."""
    canvas = channels * plan.canvas_w * plan.canvas_h
    srcs = [_src_bytes(p, channels) for p in plan.placements]
    regions = [_region_bytes(p, channels) for p in plan.placements]
    return 2 * canvas + sum(srcs) + (max(regions) if regions else 0)


def sharded_peak_bytes(plan: LayoutPlan, n_shards: int,
                       channels: int = 3) -> int:
    """Per-device peak of the space-sharded compose (parallel.sharding).

    Every source is replicated to every device — as raw uint8 AND (kernel
    engine) a lane-padded planar CHW staging copy (_stage_full_chw pads
    disp_w to 128, a large multiplier for narrow sources) — the xla engine
    additionally casts a full image to f32 per placement, and the band
    compose builds ~3 band-sized float32 temporaries (canvas, region,
    masked blend) plus the uint8 result.  An under-estimate here admits
    mesh jobs that OOM at runtime; pipeline._run_body now recovers those on
    the single-chip ladder, but the estimate should rarely need it.
    """
    band = _round_up(plan.canvas_h, n_shards) // n_shards
    srcs = 0
    f32_cast = 0
    for p in plan.placements:
        disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                               p.orientation)
        padded = channels * _round_up(disp_h, 8) * _round_up(disp_w, 128)
        srcs += channels * p.raw_w * p.raw_h + padded
        f32_cast = max(f32_cast, 4 * padded)
    band_f32 = 4 * channels * band * plan.canvas_w
    return srcs + f32_cast + 3 * band_f32 + band_f32 // 4


def plan_execution(plan: LayoutPlan, budget: MemoryBudget,
                   channels: int = 3) -> ExecutionPlan:
    """Pick the cheapest strategy whose conservative peak fits the budget."""
    limit = budget.hbm_bytes
    canvas = channels * plan.canvas_w * plan.canvas_h
    srcs = [_src_bytes(p, channels) for p in plan.placements]
    regions = [_region_bytes(p, channels) for p in plan.placements]

    resident_peak = resident_peak_bytes(plan, channels)
    if resident_peak <= limit:
        return ExecutionPlan("resident", resident_peak, limit)

    # canvas + the computing source + the i+1 prefetch + one region (the
    # pipeline's staging fence bounds any further pile-up to the budget
    # headroom, so two sources is the honest steady-state peak)
    streamed_peak = canvas + max(
        (s + r for s, r in zip(srcs, regions)), default=0) + (
            max(srcs) if srcs else 0)
    if streamed_peak <= limit:
        return ExecutionPlan("streamed", streamed_peak, limit)

    # banded: choose band height so band canvas + the worst per-image band
    # working set fits.  A band of B canvas rows needs, per overlapping image,
    # ~B/scale source rows (+2) of width disp_w.
    for band in _band_candidates(plan.canvas_h):
        peak = _banded_peak(plan, band, channels)
        if peak <= limit:
            return ExecutionPlan("banded", peak, limit, band_rows=band)
    raise MemoryError(
        f"stitch cannot fit in {limit / 1e9:.3f} GB HBM even with 8-row "
        f"bands (canvas {plan.canvas_w}x{plan.canvas_h}); raise the budget")


def min_feasible_bytes(plan: LayoutPlan, channels: int = 3) -> int:
    """Smallest budget ANY strategy can honor (the minimum banded peak).

    Budgets below this get the clean "raise the budget" MemoryError from
    :func:`plan_execution` — the correct product response, not a ladder gap
    (the tight-budget soak floors its randomized budgets here)."""
    return min(_banded_peak(plan, b, channels)
               for b in _band_candidates(plan.canvas_h))


def _band_candidates(rows: int) -> List[int]:
    out = []
    b = min(rows, 4096)
    while b >= 8:
        out.append(b)
        b //= 2
    if not out:
        out.append(max(1, rows))
    return out


def _tap_k(kind: str, scale: float) -> int:
    """Static tap count K of geometry.filter_taps at this dest/src scale."""
    if kind == "bilinear":
        return 2
    if kind == "box":
        return max(1, int(math.ceil(1.0 / max(scale, 1e-9))) + 1)
    support = geometry.filter_support(kind, max(scale, 1e-9))
    return max(2, int(math.ceil(2 * support)) + 1)


def _banded_peak(plan: LayoutPlan, band: int, channels: int) -> int:
    """Device peak of one _BandedExecutor band.

    The executor materializes real float32 intermediates (pipeline._compose):
    the crop cast (4x its uint8 bytes), a (band, disp_w, C) f32 row-pass
    result per image, and (band, canvas_w, C) f32 canvas/region buffers plus
    the uint8 band out — an earlier uint8-only model under-counted ~4-6x
    and picked bands that OOMed at runtime (r4s7 review).

    EVERY image's uint8 crop (zero-filled for non-intersecting pairs — the
    executor caches those device-resident) plus its row/column tap buffers
    are live jit args of each band call simultaneously, so those SUM over
    images; only the f32 cast/row-pass temporaries are sequential per image
    (XLA reuses them) and take the max (r4s9 review: the old max-only model
    under-counted multi-image bands by up to a factor of n).
    """
    band_canvas = channels * plan.canvas_w * band
    crops_sum = 0
    taps_sum = 0
    worst_tmp = 0
    for p in plan.placements:
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if r1 <= r0 or c1 <= c0:
            continue
        disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                               p.orientation)
        scale = p.h / max(1, disp_h)          # canvas rows per source row
        support = geometry.filter_support(plan.filter, max(scale, 1e-9))
        rows_needed = min(disp_h, int(math.ceil(
            band / max(scale, 1e-9) + 2 * support)) + 2)
        crop = channels * rows_needed * _round_up(disp_w, 128)
        row_pass = 4 * channels * band * _round_up(disp_w, 128)
        crops_sum += crop                     # uint8 input arg, all live
        k_rows = _tap_k(plan.filter, scale)
        k_cols = _tap_k(plan.filter, p.w / max(1, disp_w))
        # per band: (band, k_rows) f32 w + (band,) i32 i0 + (band,) f32 in;
        # band-invariant device-resident: (span, k_cols) f32 w + (span,) i32
        taps_sum += 4 * band * (k_rows + 2) + 4 * (c1 - c0) * (k_cols + 1)
        worst_tmp = max(worst_tmp, 4 * crop + row_pass)   # f32 cast + rows
    # f32 canvas carry + f32 region (DUS output) + mask + uint8 band out
    return 10 * band_canvas + crops_sum + taps_sum + worst_tmp


def band_ranges(plan: LayoutPlan, band_rows: int) -> List[Tuple[int, int]]:
    return [(lo, min(plan.canvas_h, lo + band_rows))
            for lo in range(0, plan.canvas_h, band_rows)]


def band_source_rows(p: Placement, band_lo: int, band_hi: int,
                     kind: str = "bilinear",
                     ) -> Optional[Tuple[int, int, int, int]]:
    """Source rows needed for canvas rows [band_lo, band_hi) of placement p.

    Returns (canvas_r0, canvas_r1, src_lo, src_hi) of the intersection, or
    None if the image doesn't touch the band.  Source rows are in *display*
    (oriented) space; ``kind`` must be the plan's filter (wider filters need
    wider crops — geometry.filter_support).
    """
    r0, r1 = p.row_span
    br0, br1 = max(r0, band_lo), min(r1, band_hi)
    if br1 <= br0:
        return None
    _, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    lo, hi = geometry.source_band(br0, br1, p.y0, p.h, disp_h, kind)
    return br0, br1, lo, hi
