"""NumPy golden model of the Canvas-2D stitch (the parity referee).

The port's own copy of ``imagestitching_tpu/core/oracle.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

Implements, in plain vectorized NumPy with no JAX, exactly what the reference
asks of the platform canvas in its draw loop (pages/index/index.js:1423-1572):

1. allocate the output canvas and fill it with the background color
   (``fillRect`` white, index.js:1423-1424);
2. for each image, ``drawWithOrientation`` (utils/canvas.js:153-202) — i.e.
   EXIF-orient the source, then bilinearly resample it into its dest rect;
3. convert to uint8 (canvas stores 8-bit; we define rounding = half-up).

The oracle intentionally uses the *direct gather* formulation of bilinear
sampling (2 taps per axis) rather than the weight-matrix formulation used by
the device paths — so agreement between oracle and kernels is evidence, not
tautology.  Unit tests compare every device path to this module per tile.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import geometry
from .layout import LayoutPlan, Placement


def resample_axis(img: np.ndarray, axis: int, out_lo: int, out_hi: int,
                  a: float, length: float, kind: str = "bilinear") -> np.ndarray:
    """Resample ``img`` along ``axis`` onto dest pixels [out_lo, out_hi).

    ``a``/``length`` define the continuous dest span the source is mapped to
    (half-pixel-center contract, see geometry.source_coords).
    """
    m = img.shape[axis]
    if kind == "bilinear":
        i0, i1, w1 = geometry.bilinear_taps(out_lo, out_hi, a, length, m)
        t0 = np.take(img, i0, axis=axis).astype(np.float64)
        t1 = np.take(img, i1, axis=axis).astype(np.float64)
        shape = [1] * img.ndim
        shape[axis] = len(w1)
        w1 = w1.reshape(shape)
        return t0 * (1.0 - w1) + t1 * w1
    # General separable filter via its dense weight matrix.
    w = geometry.filter_matrix(out_lo, out_hi, a, length, m, kind=kind,
                               dtype=np.float64)
    return np.moveaxis(
        np.tensordot(w, np.moveaxis(img, axis, 0).astype(np.float64), axes=1),
        0, axis)


def draw_image(canvas: np.ndarray, raw: np.ndarray, placement: Placement,
               kind: str = "bilinear") -> None:
    """Draw one image into ``canvas`` (float64 HWC) per its placement.

    Equivalent of one ``drawWithOrientation`` call: orient raw pixels, then
    separable resample into the (possibly fractional) dest rect, writing only
    pixels whose centers fall inside the rect and the canvas.
    """
    r0, r1 = placement.row_span
    c0, c1 = placement.col_span
    if r1 <= r0 or c1 <= c0:
        return
    oriented = geometry.orient_array(raw, placement.orientation)
    rows = resample_axis(oriented, 0, r0, r1, placement.y0, placement.h, kind)
    full = resample_axis(rows, 1, c0, c1, placement.x0, placement.w, kind)
    canvas[r0:r1, c0:c1] = full


def stitch(plan: LayoutPlan, images: Sequence[np.ndarray]) -> np.ndarray:
    """Full golden stitch: uint8 HWC canvas of shape (canvas_h, canvas_w, C).

    ``images[i]`` must be the *raw* (un-oriented) uint8/float HWC pixels of
    the i-th input, matching ``plan.placements[i].raw_w/raw_h``.
    """
    if len(images) != len(plan.placements):
        raise ValueError("image count does not match plan")
    channels = images[0].shape[2] if images[0].ndim == 3 else 1
    canvas = np.empty((plan.canvas_h, plan.canvas_w, channels), np.float64)
    bg = np.asarray(plan.background[:channels], np.float64)
    canvas[...] = bg
    for raw, placement in zip(images, plan.placements):
        if raw.ndim == 2:
            raw = raw[:, :, None]
        if raw.shape[0] != placement.raw_h or raw.shape[1] != placement.raw_w:
            raise ValueError(
                f"image {placement.index}: got {raw.shape[1]}x{raw.shape[0]}, "
                f"plan says {placement.raw_w}x{placement.raw_h}")
        draw_image(canvas, raw, placement, plan.filter)
    return to_uint8(canvas)


def stitch_rows(plan: LayoutPlan, images: Sequence[np.ndarray],
                row_lo: int, row_hi: int) -> np.ndarray:
    """Golden stitch restricted to canvas rows [row_lo, row_hi).

    Bit-identical to ``stitch(plan, images)[row_lo:row_hi]`` (taps are
    per-output-row constants, so a row window is self-contained); exists so
    parity spot-checks on huge canvases don't pay the full float64 pass.
    """
    if len(images) != len(plan.placements):
        raise ValueError("image count does not match plan")
    row_lo = max(0, row_lo)
    row_hi = min(plan.canvas_h, row_hi)
    channels = images[0].shape[2] if images[0].ndim == 3 else 1
    band = np.empty((row_hi - row_lo, plan.canvas_w, channels), np.float64)
    band[...] = np.asarray(plan.background[:channels], np.float64)
    for raw, p in zip(images, plan.placements):
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        br0, br1 = max(r0, row_lo), min(r1, row_hi)
        if br1 <= br0 or c1 <= c0:
            continue
        if raw.ndim == 2:
            raw = raw[:, :, None]
        oriented = geometry.orient_array(raw, p.orientation)
        rows = resample_axis(oriented, 0, br0, br1, p.y0, p.h, plan.filter)
        full = resample_axis(rows, 1, c0, c1, p.x0, p.w, plan.filter)
        band[br0 - row_lo: br1 - row_lo, c0:c1] = full
    return to_uint8(band)


def to_uint8(x: np.ndarray) -> np.ndarray:
    """float -> uint8 with round-half-up then clamp (framework-wide contract)."""
    return np.clip(np.floor(x + 0.5), 0.0, 255.0).astype(np.uint8)
