"""Pure layout solver: image metadata + options -> a complete LayoutPlan.

The port's own copy of ``imagestitching_tpu/core/layout.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

Reproduces the reference's output-geometry math *exactly*, including its mixed
rounding schedule (this is the part parity lives or dies on):

* vertical/min  : ``outW = min(widths)``; heights accumulate **unrounded** as
  ``ih * (outW/iw)`` plus gaps (index.js:1262-1270).
* vertical/max  : same with ``outW = max(widths)`` (index.js:1271-1279).
* vertical/orig : ``outW = max(widths)``, ``outH = sum(ih) + gaps``; images are
  centered later with ``Math.floor`` (index.js:1280-1287, 1527-1533).
* horizontal    : mirror of the above with W/H swapped (index.js:1288-1314).
* Final size    : ``max(1, round(out*))`` (index.js:1317-1320).
* Canvas caps   : uniform ``scaleDown`` = min(side ratio, sqrt(pixel ratio)),
  floor-applied (index.js:1323-1357).
* Supersample   : factor = min(cap, sqrt(maxPixels/basePixels), side headroom),
  only when ratio > 1.01; ``round`` then a ``*0.96`` guard loop with ``floor``
  (index.js:1360-1386).
* Draw loop     : per-image dest sizes are **rounded** (``Math.round``), the
  cursor advances by the rounded size plus ``gap * scaleDown`` (float), and
  original-mode centering uses ``Math.floor`` (index.js:1526-1554).  The draw
  happens under a ``ctx.scale(superSample)`` transform (index.js:1426-1428), so
  final dest rects in canvas pixels are the logical rects times supersample.

All arithmetic is float64 to match JS doubles.  This module is pure NumPy-free
Python; every other layer consumes its ``LayoutPlan``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

from ..config import CanvasLimits, StitchOptions
from . import geometry


def _js_round(x: float) -> int:
    """JS ``Math.round``: half-up toward +inf (Python ``round`` is banker's).

    NOT ``floor(x + 0.5)``: the ES spec defines the tie test on the exact
    value, while the float addition ``x + 0.5`` can carry a 1-ULP-below-half
    input over the boundary — ``Math.round(0.49999999999999994)`` is 0 in
    every real JS engine but ``floor(x + 0.5)`` gives 1 (r5 review).  The
    fractional part ``x - floor(x)`` is exact for finite nonnegative
    doubles (Sterbenz), so testing it against 0.5 matches the engine."""
    f = math.floor(x)
    return f + (1 if x - f >= 0.5 else 0)


@dataclasses.dataclass(frozen=True)
class ImageSpec:
    """Metadata of one input image (host-side; no pixels).

    ``raw_w/raw_h`` are the stored pixel dims; ``orientation`` the EXIF tag.
    Layout is computed on *display* dims (orientation-corrected), the
    framework's contract for "naturalWidth/Height".
    """

    raw_w: int
    raw_h: int
    orientation: int = 1

    @property
    def width(self) -> int:       # display width
        return geometry.display_size(self.raw_w, self.raw_h, self.orientation)[0]

    @property
    def height(self) -> int:      # display height
        return geometry.display_size(self.raw_w, self.raw_h, self.orientation)[1]


@dataclasses.dataclass(frozen=True)
class Placement:
    """One image's dest rect in final canvas pixels (floats, pre-raster).

    ``x0/y0/w/h`` are continuous canvas coordinates; pixel ownership follows
    pixel centers (see geometry.pixel_span).  ``col_span``/``row_span`` are the
    integer pixel ranges actually written, clipped to the canvas.
    """

    index: int
    x0: float
    y0: float
    w: float
    h: float
    col_span: Tuple[int, int]
    row_span: Tuple[int, int]
    raw_w: int
    raw_h: int
    orientation: int


@dataclasses.dataclass(frozen=True)
class LayoutPlan:
    """Everything shape-like about one stitch job (static; hashable)."""

    direction: str
    mode: str
    gap: float
    out_w: int                 # logical output size (pre-supersample)
    out_h: int
    scale_down: float
    supersample: float
    canvas_w: int              # physical canvas / final image size
    canvas_h: int
    placements: Tuple[Placement, ...]
    background: Tuple[int, int, int]
    filter: str

    @property
    def canvas_pixels(self) -> int:
        return self.canvas_w * self.canvas_h

    def shape_signature(self) -> tuple:
        """Key of the traced program SHAPE: everything a compiled stitch
        program depends on when tap weights arrive as runtime arguments
        (the XLA engine's design — xla_compose ships taps as tiny jit args
        precisely so same-shaped jobs share one compile).

        ``background`` belongs here even though it changes no array shape:
        assemble_canvas bakes the fill color in as a compile-time constant —
        omitting it handed same-geometry jobs another job's background
        (r4 serve review)."""
        return (
            self.canvas_w, self.canvas_h, self.filter, self.background,
            tuple((p.col_span, p.row_span, p.raw_w, p.raw_h, p.orientation)
                  for p in self.placements),
        )

    def signature(self) -> tuple:
        """Full compile-cache/bucketing key: shape_signature PLUS the
        fractional placement rects ``(x0, y0, w, h)``.

        Tap weights derive from the fractional rects, and several layers
        bake weights per key: the Pallas engine closes over the whole plan
        at trace time, and serve/BatchedStitch/CompiledStitch instances pin
        construction-plan params.  Integer pixel spans do NOT determine the
        weights: e.g. gap=0.51 vs gap=0.69 on the same specs yields
        identical spans but sub-pixel-shifted weights — collapsing those to
        one key ran the second job with the first job's weights, 45 uint8
        levels off its oracle (r4 review; regressions in tests/
        test_layout.py and tests/test_xla_compose.py)."""
        return self.shape_signature() + (
            tuple((p.x0, p.y0, p.w, p.h) for p in self.placements),
        )


def _out_size(specs: Sequence[ImageSpec], direction: str, mode: str,
              gap: float,
              forced_edge: Optional[float] = None) -> Tuple[float, float]:
    """Unrounded output size — exact reference accumulation (index.js:1251-1315).

    ``forced_edge`` (extension, used by the grid-collage planner) overrides
    the common edge the mode would derive (out_w for vertical, out_h for
    horizontal): a grid column must share the GRID's column width, not the
    min/max of the images that happen to land in that column.  The
    accumulation schedule is otherwise identical.
    """
    widths = [max(1, s.width) for s in specs]
    heights = [max(1, s.height) for s in specs]
    if forced_edge is not None:
        widths = heights = [forced_edge]
    # Accumulation grouping matters: the reference's reduce evaluates
    # ``(sum + draw) + gap`` left-to-right (index.js:1265-1269).  Float
    # addition is not associative, so ``sum += draw + gap`` — which groups
    # ``sum + (draw + gap)`` — can differ by an ULP and flip a Math.round
    # at an exact .5 boundary.  Keep every branch left-associated.
    if direction == "vertical":
        if mode == "min":
            out_w = float(min(widths))
            out_h = 0.0
            for idx, s in enumerate(specs):
                iw, ih = max(1, s.width), max(1, s.height)
                out_h = out_h + ih * (out_w / iw) + (gap if idx else 0.0)
        elif mode == "max":
            out_w = float(max(widths))
            out_h = 0.0
            for idx, s in enumerate(specs):
                iw, ih = max(1, s.width), max(1, s.height)
                out_h = out_h + ih * (out_w / iw) + (gap if idx else 0.0)
        else:  # original
            out_w = float(max(widths))
            out_h = 0.0
            for idx, s in enumerate(specs):
                out_h = out_h + max(1, s.height) + (gap if idx else 0.0)
    else:
        if mode == "min":
            out_h = float(min(heights))
            out_w = 0.0
            for idx, s in enumerate(specs):
                iw, ih = max(1, s.width), max(1, s.height)
                out_w = out_w + iw * (out_h / ih) + (gap if idx else 0.0)
        elif mode == "max":
            out_h = float(max(heights))
            out_w = 0.0
            for idx, s in enumerate(specs):
                iw, ih = max(1, s.width), max(1, s.height)
                out_w = out_w + iw * (out_h / ih) + (gap if idx else 0.0)
        else:  # original
            out_h = float(max(heights))
            out_w = 0.0
            for idx, s in enumerate(specs):
                out_w = out_w + max(1, s.width) + (gap if idx else 0.0)
    return out_w, out_h


def _scale_down(out_w: int, out_h: int, limits: CanvasLimits) -> float:
    """Uniform shrink factor from side & pixel caps (index.js:1337-1349)."""
    scale = 1.0
    if out_w > limits.max_side or out_h > limits.max_side:
        scale = min(limits.max_side / out_w, limits.max_side / out_h)
    total = out_w * out_h
    if total > limits.max_pixels:
        scale = min(scale, math.sqrt(limits.max_pixels / total))
    return scale


def _supersample(target_w: int, target_h: int, limits: CanvasLimits,
                 enabled: bool) -> Tuple[float, int, int]:
    """Supersample factor + physical canvas size (index.js:1360-1386)."""
    base = target_w * target_h
    ss = 1.0
    cap = limits.max_supersample if enabled else 1.0
    if 0 < base < limits.max_pixels and cap > 1.0:
        ratio = math.sqrt(limits.max_pixels / base)
        if ratio > 1.01:
            side_cap = min(limits.max_side / target_w, limits.max_side / target_h)
            ss = min(cap, ratio, side_cap)
    if not math.isfinite(ss) or ss < 1.0:
        ss = 1.0
    cw = max(1, _js_round(target_w * ss))
    ch = max(1, _js_round(target_h * ss))
    guard = 0
    while cw * ch > limits.max_pixels and guard < 20:
        ss *= 0.96
        if ss < 1.0:
            # DELIBERATE DEVIATION (PARITY.md #8): the reference breaks here
            # WITHOUT recomputing canvasOutW/H (index.js:1379), exporting a
            # canvas that exceeds its own pixel cap with background margins
            # beyond the content (e.g. target 1000x1000, cap 1,040,000,
            # max_supersample 2.2 -> reference canvas 1020x1020).  We reset
            # to the target size so the cap is honored and no dead margin is
            # emitted.  Reachable only with supersample enabled and
            # sqrt(max_pixels/base) in (1.01, ~1.042).  Pinned by
            # tests/test_layout_referee.py; fuzzed by soak --layout.
            ss = 1.0
            cw, ch = target_w, target_h
            break
        cw = max(1, math.floor(target_w * ss))
        ch = max(1, math.floor(target_h * ss))
        guard += 1
    return ss, cw, ch


def solve(specs: Sequence[ImageSpec], options: StitchOptions,
          limits: Optional[CanvasLimits] = None,
          forced_edge: Optional[float] = None,
          forced_scale_down: Optional[float] = None) -> LayoutPlan:
    """Compute the full layout plan for one stitch job.

    ``forced_edge`` overrides the mode-derived common edge (see
    :func:`_out_size`); ``forced_scale_down`` overrides the limits-derived
    uniform shrink.  Grid-collage columns pass the grid's (unshrunk)
    column width and the GRID-level scale_down so all columns shrink
    identically; plain strips never set either.
    """
    options = options.validate()
    limits = limits or CanvasLimits()
    if not specs:
        raise ValueError("no images to stitch")
    if options.max_images is not None and len(specs) > options.max_images:
        raise ValueError(
            f"{len(specs)} images exceeds max_images={options.max_images} "
            "(reference cap MAX_IMAGES=9, index.js:311); raise max_images to override")
    for s in specs:
        if not (1 <= s.orientation <= 8 or s.orientation == 0):
            raise ValueError(f"invalid EXIF orientation {s.orientation}")
        if s.raw_w < 1 or s.raw_h < 1:
            raise ValueError(f"invalid image dims {s.raw_w}x{s.raw_h}")

    direction, mode, gap = options.direction, options.mode, float(options.gap)

    out_wf, out_hf = _out_size(specs, direction, mode, gap, forced_edge)
    out_w = max(1, _js_round(out_wf))
    out_h = max(1, _js_round(out_hf))

    scale_down = (forced_scale_down if forced_scale_down is not None
                  else _scale_down(out_w, out_h, limits))
    if scale_down < 1.0:
        out_w = max(1, math.floor(out_w * scale_down))
        out_h = max(1, math.floor(out_h * scale_down))

    ss, canvas_w, canvas_h = _supersample(out_w, out_h, limits,
                                          options.supersample)

    # Draw-loop placement schedule (index.js:1430-1554).  Cursor is float and
    # never rounded; per-image dest sizes are rounded; everything is finally
    # scaled by the supersample transform.
    scaled_gap = gap * scale_down
    cursor = 0.0
    placements: List[Placement] = []
    for idx, s in enumerate(specs):
        nat_w, nat_h = max(1, s.width), max(1, s.height)
        if direction == "vertical":
            if mode == "original":
                dw = _js_round(nat_w * scale_down)
                dh = _js_round(nat_h * scale_down)
                dx = float(math.floor((out_w - dw) / 2))
                dy = cursor
                cursor += dh + scaled_gap
            else:
                dw = out_w
                dh = _js_round(nat_h * (out_w / nat_w))
                dx = 0.0
                dy = cursor
                cursor += dh + scaled_gap
        else:
            if mode == "original":
                dw = _js_round(nat_w * scale_down)
                dh = _js_round(nat_h * scale_down)
                dx = cursor
                dy = float(math.floor((out_h - dh) / 2))
                cursor += dw + scaled_gap
            else:
                dh = out_h
                dw = _js_round(nat_w * (out_h / nat_h))
                dx = cursor
                dy = 0.0
                cursor += dw + scaled_gap
        # Physical (canvas-pixel) rect under the supersample transform.
        x0, y0, w, h = dx * ss, dy * ss, dw * ss, dh * ss
        col = geometry.clipped_pixel_span(x0, w, canvas_w)
        row = geometry.clipped_pixel_span(y0, h, canvas_h)
        placements.append(Placement(
            index=idx, x0=x0, y0=y0, w=w, h=h,
            col_span=col, row_span=row,
            raw_w=s.raw_w, raw_h=s.raw_h, orientation=s.orientation or 1,
        ))

    return LayoutPlan(
        direction=direction, mode=mode, gap=gap,
        out_w=out_w, out_h=out_h, scale_down=scale_down,
        supersample=ss, canvas_w=canvas_w, canvas_h=canvas_h,
        placements=tuple(placements),
        background=options.background, filter=options.filter,
    )
