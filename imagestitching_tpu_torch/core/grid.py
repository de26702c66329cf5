"""Grid-collage layout planner (framework extension).

The port's own copy of ``imagestitching_tpu/core/grid.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py`` and
``tests/test_torch_grid.py`` hold the two equal.

The reference app is literally named "优雅拼图" (elegant collage) yet only
produces 1-D strips (its draw loop advances one cursor, index.js:1526-1554).
``api.stitch_grid`` adds the collage: a masonry grid of ``cols`` columns
where every image is resized once to the common column width and columns
are stacked side by side.

Design: a grid is COMPOSED from the strip machinery rather than a new
engine feature.  Each column is an ordinary vertical-strip ``LayoutPlan``
(``core.layout.solve`` with ``forced_edge`` = the grid's column width), so
every engine, memory strategy, and parity property applies per column
unchanged; the grid adds only pure assignment/sizing math (this module)
and a write-once host assembly (api).  Identically-shaped columns share
compiled programs through the ordinary ``plan.signature()`` caches.

Sizing contract (self-defined — there is no reference behavior to match):

* ``mode="min"``/``"max"``  — column width = min/max display width over
  ALL images; every image scales to it (aspect preserved).
* ``mode="original"``       — column width = max display width; images
  keep their size, centered (strip semantics per column).
* ``gap`` applies both between rows within a column and between columns.
* Canvas caps (``CanvasLimits``) shrink the WHOLE grid uniformly with the
  reference's floor-applied ``scaleDown`` math before columns are solved.
* ``order="balance"`` assigns each image to the currently-shortest column
  (classic masonry, minimizes ragged bottom); ``order="preserve"`` deals
  row-major (image i -> column i mod cols), keeping input order readable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from ..config import CanvasLimits, StitchOptions
from . import layout as _layout
from .layout import ImageSpec, LayoutPlan, _js_round


@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Pure description of one grid-collage job."""

    cols: int
    col_width: int                      # final (scale_down-applied) px
    gap: float                          # final (scale_down-applied) gap
    scale_down: float
    columns: Tuple[Tuple[int, ...], ...]   # image indices per column
    col_plans: Tuple[LayoutPlan, ...]       # one strip plan per column
    canvas_w: int
    canvas_h: int
    background: Tuple[int, int, int]
    # NOTE: deliberately no grid-level signature() — compiled-program reuse
    # rides the per-column plan.signature() caches (see module docstring).
    # A grid-level key would have to cover gap/valign/order/background to be
    # sound (the r4s5 stale-key class), and nothing needs one.


def _assign(specs: Sequence[ImageSpec], cols: int, col_w: float,
            gap: float, order: str, mode: str) -> List[List[int]]:
    """Image index -> column assignment (unrounded height accounting)."""
    columns: List[List[int]] = [[] for _ in range(cols)]
    heights = [0.0] * cols
    for i, s in enumerate(specs):
        iw, ih = max(1, s.width), max(1, s.height)
        # original mode keeps images at natural size — balance on that
        hf = float(ih) if mode == "original" else ih * (col_w / iw)
        if order == "balance":
            c = min(range(cols), key=lambda k: (heights[k], k))
        else:                           # preserve: row-major deal
            c = i % cols
        columns[c].append(i)
        heights[c] += hf + (gap if len(columns[c]) > 1 else 0.0)
    return columns


def plan_grid(specs: Sequence[ImageSpec], cols: int,
              options: StitchOptions,
              limits: Optional[CanvasLimits] = None,
              order: str = "balance") -> GridPlan:
    """Solve the grid: column width, assignment, caps, per-column plans."""
    options = options.validate()
    if options.direction != "vertical":
        raise ValueError("grid collage flows images down columns; "
                         "direction must be 'vertical'")
    if options.supersample:
        raise ValueError("supersample is not supported for grid collage")
    if order not in ("balance", "preserve"):
        raise ValueError(f"order must be 'balance' or 'preserve', "
                         f"got {order!r}")
    if not specs:
        raise ValueError("no images to stitch")
    if cols < 1:
        raise ValueError(f"cols must be >= 1, got {cols}")
    if options.max_images is not None and len(specs) > options.max_images:
        raise ValueError(
            f"{len(specs)} images exceeds max_images={options.max_images}; "
            "raise max_images to override")
    cols = min(cols, len(specs))
    limits = limits or CanvasLimits()
    gap = float(options.gap)

    widths = [max(1, s.width) for s in specs]
    col_wf = float(min(widths) if options.mode == "min" else max(widths))

    # unrounded grid size -> reference scaleDown math on the whole canvas
    columns = _assign(specs, cols, col_wf, gap, order, options.mode)
    col_hf = []
    for idx_list in columns:
        h = 0.0
        for j, i in enumerate(idx_list):
            s = specs[i]
            iw, ih = max(1, s.width), max(1, s.height)
            h += ((ih * (col_wf / iw) if options.mode != "original"
                   else float(ih)) + (gap if j else 0.0))
        col_hf.append(h)
    grid_wf = cols * col_wf + (cols - 1) * gap
    grid_hf = max(col_hf) if col_hf else 1.0
    grid_w = max(1, _js_round(grid_wf))
    grid_h = max(1, _js_round(grid_hf))
    scale_down = _layout._scale_down(grid_w, grid_h, limits)

    def _solve_columns(sd: float):
        # each column is a plain strip plan; the UNSHRUNK column width and
        # the GRID-level scale_down go in as the forced overrides, so
        # every column shrinks identically (a per-column CanvasLimits cap
        # would shrink ragged columns unequally) and the reference's
        # rounding schedule (round edge -> floor shrink -> float gap
        # cursor) is reused verbatim
        plans = []
        for idx_list in columns:
            plans.append(_layout.solve(
                [specs[i] for i in idx_list],
                dataclasses.replace(options, max_images=None,
                                    merge_overlap=False),
                forced_edge=col_wf,
                forced_scale_down=sd))
        # inter-column gaps are integral (columns are assembled whole)
        w = cols * plans[0].canvas_w + (cols - 1) * _js_round(gap * sd)
        h = max(p.canvas_h for p in plans)
        return plans, w, h

    col_plans, canvas_w, canvas_h = _solve_columns(scale_down)
    # scale_down above came from the ROUNDED aggregate grid size, but the
    # assembled canvas sums per-column widths and per-gap half-up roundings,
    # which can land a few px over a cap the strip solver would have honored
    # exactly (e.g. 3x70 + 2*round(0.7) = 212 > round(211.4) = 211).  Shrink
    # until the assembled size fits (the grid analog of _supersample's 0.96
    # guard loop); the 1-px column floor can make a tiny cap unsatisfiable,
    # so the loop is bounded and returns best effort then.
    guard = 0
    while guard < 20 and (canvas_w > limits.max_side
                          or canvas_h > limits.max_side
                          or canvas_w * canvas_h > limits.max_pixels):
        ratio = _layout._scale_down(canvas_w, canvas_h, limits)
        next_sd = scale_down * min(ratio, 0.9995)
        nplans, nw, nh = _solve_columns(next_sd)
        if (nw, nh) == (canvas_w, canvas_h):   # rounding ate the shrink
            next_sd *= 0.99
            nplans, nw, nh = _solve_columns(next_sd)
        scale_down = next_sd
        col_plans, canvas_w, canvas_h = nplans, nw, nh
        guard += 1
    col_w = col_plans[0].canvas_w          # identical across columns
    scaled_gap = gap * scale_down
    return GridPlan(cols=cols, col_width=col_w, gap=scaled_gap,
                    scale_down=scale_down,
                    columns=tuple(tuple(c) for c in columns),
                    col_plans=tuple(col_plans),
                    canvas_w=canvas_w, canvas_h=canvas_h,
                    background=options.background)
