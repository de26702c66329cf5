"""Frozen layout of a plain strip: image sizes and options -> dest rects.

A copy of the port's layout solver (``imagestitching_tpu_torch/core/
layout.py`` ``solve`` with its ``_out_size``, ``_scale_down``,
``_supersample`` and ``_js_round``, and the rect rasterisation of
``core/geometry.py``), kept here so that a change to the port cannot move
what the benchmark holds it to.  It imports nothing of the port.

The reference app's geometry (pages/index/index.js:1251-1554): the common
edge of mode ``min``/``max``, unrounded accumulation of the other edge,
``Math.round`` of each dest size, a float cursor advanced by the rounded
size plus the gap, ``Math.floor`` centring in mode ``original``, the
canvas caps' uniform shrink and the optional supersample.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

TRANSPOSED = (5, 6, 7, 8)
MAX_SIDE = 65536
MAX_PIXELS = 1 << 30
MAX_SUPERSAMPLE = 2.2


def js_round(x: float) -> int:
    """JS ``Math.round``: ties go up, tested on the exact fraction."""
    f = math.floor(x)
    return f + (1 if x - f >= 0.5 else 0)


def display_size(raw_w: int, raw_h: int, orientation: int) -> Tuple[int, int]:
    if orientation in TRANSPOSED:
        return raw_h, raw_w
    return raw_w, raw_h


def clipped_span(a: float, length: float, limit: int) -> Tuple[int, int]:
    """Pixels whose centres lie in [a, a + length), clipped to [0, limit)."""
    lo = math.ceil(a - 0.5)
    hi = math.ceil(a + length - 0.5)
    return max(0, lo), max(max(0, lo), min(limit, hi))


@dataclasses.dataclass(frozen=True)
class Rect:
    """One image's dest rect: continuous ``x0, y0, w, h`` and the pixel
    spans written."""

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
class Layout:
    canvas_w: int
    canvas_h: int
    rects: Tuple[Rect, ...]
    background: Tuple[int, int, int]


def _out_size(sizes, direction, mode, gap):
    if direction == "vertical":
        if mode == "original":
            out_w = float(max(w for w, _ in sizes))
            out_h = 0.0
            for k, (_, h) in enumerate(sizes):
                out_h = out_h + h + (gap if k else 0.0)
            return out_w, out_h
        out_w = float((min if mode == "min" else max)(w for w, _ in sizes))
        out_h = 0.0
        for k, (w, h) in enumerate(sizes):
            out_h = out_h + h * (out_w / w) + (gap if k else 0.0)
        return out_w, out_h
    if mode == "original":
        out_h = float(max(h for _, h in sizes))
        out_w = 0.0
        for k, (w, _) in enumerate(sizes):
            out_w = out_w + w + (gap if k else 0.0)
        return out_w, out_h
    out_h = float((min if mode == "min" else max)(h for _, h in sizes))
    out_w = 0.0
    for k, (w, h) in enumerate(sizes):
        out_w = out_w + w * (out_h / h) + (gap if k else 0.0)
    return out_w, out_h


def _scale_down(out_w: int, out_h: int) -> float:
    scale = 1.0
    if out_w > MAX_SIDE or out_h > MAX_SIDE:
        scale = min(MAX_SIDE / out_w, MAX_SIDE / out_h)
    if out_w * out_h > MAX_PIXELS:
        scale = min(scale, math.sqrt(MAX_PIXELS / (out_w * out_h)))
    return scale


def _supersample(tw: int, th: int, enabled: bool):
    base = tw * th
    ss = 1.0
    cap = MAX_SUPERSAMPLE if enabled else 1.0
    if 0 < base < MAX_PIXELS and cap > 1.0:
        ratio = math.sqrt(MAX_PIXELS / base)
        if ratio > 1.01:
            ss = min(cap, ratio, min(MAX_SIDE / tw, MAX_SIDE / th))
    if not math.isfinite(ss) or ss < 1.0:
        ss = 1.0
    cw = max(1, js_round(tw * ss))
    ch = max(1, js_round(th * ss))
    guard = 0
    while cw * ch > MAX_PIXELS and guard < 20:
        ss *= 0.96
        if ss < 1.0:
            return 1.0, tw, th
        cw = max(1, math.floor(tw * ss))
        ch = max(1, math.floor(th * ss))
        guard += 1
    return ss, cw, ch


def solve(shapes: Sequence[Tuple[int, int, int]], direction: str = "vertical",
          mode: str = "min", gap: float = 0.0, supersample: bool = False,
          background=(255, 255, 255)) -> Layout:
    """The layout of images ``(raw_w, raw_h, orientation)`` with the
    default canvas limits."""
    gap = float(gap)
    sizes = [tuple(max(1, v) for v in display_size(w, h, o))
             for w, h, o in shapes]
    out_wf, out_hf = _out_size(sizes, direction, mode, gap)
    out_w = max(1, js_round(out_wf))
    out_h = max(1, js_round(out_hf))
    scale = _scale_down(out_w, out_h)
    if scale < 1.0:
        out_w = max(1, math.floor(out_w * scale))
        out_h = max(1, math.floor(out_h * scale))
    ss, canvas_w, canvas_h = _supersample(out_w, out_h, supersample)
    gap_s = gap * scale
    cursor = 0.0
    rects: List[Rect] = []
    for (w, h, o), (nat_w, nat_h) in zip(shapes, sizes):
        if mode == "original":
            dw = js_round(nat_w * scale)
            dh = js_round(nat_h * scale)
        elif direction == "vertical":
            dw, dh = out_w, js_round(nat_h * (out_w / nat_w))
        else:
            dw, dh = js_round(nat_w * (out_h / nat_h)), out_h
        if direction == "vertical":
            dx = float(math.floor((out_w - dw) / 2)) if mode == "original" \
                else 0.0
            dy = cursor
            cursor += dh + gap_s
        else:
            dx = cursor
            dy = float(math.floor((out_h - dh) / 2)) if mode == "original" \
                else 0.0
            cursor += dw + gap_s
        x0, y0, rw, rh = dx * ss, dy * ss, dw * ss, dh * ss
        rects.append(Rect(x0, y0, rw, rh, clipped_span(x0, rw, canvas_w),
                          clipped_span(y0, rh, canvas_h), w, h, o or 1))
    return Layout(canvas_w, canvas_h, tuple(rects),
                  tuple(int(v) for v in background))
