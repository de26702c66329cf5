"""Pure geometry: EXIF orientation maps, sampling/filter math, rect raster.

The port's own copy of ``imagestitching_tpu/core/geometry.py``; it computes
what the original computes, and ``tests/test_torch_standalone.py``
holds the two equal.

This module is the shared mathematical ground truth for the NumPy oracle, the
XLA compositing path and the Pallas kernels.  Everything here is pure and
NumPy-only (no JAX import) so it can be property-tested cheaply.

Reference semantics being modelled
----------------------------------
* ``drawImage(img, sx,sy,sw,sh, dx,dy,dw,dh)`` with bilinear smoothing —
  reference invokes it through ``drawWithOrientation`` (utils/canvas.js:153-202)
  for every image in the stitch hot loop (pages/index/index.js:1526-1554).
* The 8 EXIF orientations are applied as a canvas transform stack around the
  draw (canvas.js:160-197).  Because all 8 are axis-aligned (flips/transposes),
  they reduce to *pure source-index swizzles*: orienting the raw pixel array
  first and then doing a plain axis-aligned resize is mathematically identical.
  That is how both the oracle and the TPU kernels implement it (no rotation in
  sampling space ⇒ separable filters stay separable).

  Note: the reference's case 7 (canvas.js:187-192) composes
  translate/rotate/scale such that the drawn quad lands *above* the dest rect
  (y ∈ (dy-dh, dy]) — an upstream bug.  We implement the standard EXIF-7
  ("transverse") placement inside the dest rect instead, and document the
  deviation here.
* Sampling model: half-pixel centers with clamp-to-edge, i.e. output pixel X
  inside a dest span [a, a+L) covering source extent m samples the continuous
  source coordinate ``s = (X + 0.5 - a) / L * m - 0.5`` and bilinearly blends
  ``floor(s)`` and ``floor(s)+1`` (each clamped to [0, m-1]).  This is the
  canonical GPU/canvas bilinear contract.
* Separable-filter-as-matrix: any separable linear resampler (bilinear /
  triangle-AA / box) is a pair of weight matrices ``W_rows (n_out, m_src)`` and
  ``W_cols``; resize = ``W_rows @ img @ W_cols.T``.  On TPU those matmuls ride
  the MXU — this identity is the core of the whole compute path.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Orientation
# ---------------------------------------------------------------------------

#: Orientations whose display dims are the transpose of the raw dims.
TRANSPOSED_ORIENTATIONS = (5, 6, 7, 8)


def display_size(raw_w: int, raw_h: int, orientation: int) -> Tuple[int, int]:
    """Display (oriented) dimensions for a raw ``raw_w x raw_h`` image."""
    if orientation in TRANSPOSED_ORIENTATIONS:
        return raw_h, raw_w
    return raw_w, raw_h


def orient_array(img: np.ndarray, orientation: int) -> np.ndarray:
    """Apply EXIF orientation to an HWC (or HW) array -> display-oriented array.

    Derived from the inverse of the canvas transform stack in
    canvas.js:160-197 (verified case-by-case; see module docstring for the
    case-7 deviation).  Index-permutation only — no resampling.
    """
    if orientation in (0, 1):
        return img
    if orientation == 2:      # mirror horizontal
        return img[:, ::-1]
    if orientation == 3:      # rotate 180
        return img[::-1, ::-1]
    if orientation == 4:      # mirror vertical
        return img[::-1, :]
    axes = (1, 0) + tuple(range(2, img.ndim))
    t = np.transpose(img, axes)
    if orientation == 5:      # transpose (main diagonal)
        return t
    if orientation == 6:      # rotate 90 CW
        return t[:, ::-1]
    if orientation == 7:      # transverse (anti-diagonal)
        return t[::-1, ::-1]
    if orientation == 8:      # rotate 90 CCW
        return t[::-1, :]
    raise ValueError(f"invalid EXIF orientation {orientation}")


# ---------------------------------------------------------------------------
# Dest-rect rasterization
# ---------------------------------------------------------------------------

def pixel_span(a: float, length: float) -> Tuple[int, int]:
    """Integer pixel index range [lo, hi) whose centers fall in [a, a+length).

    Pixel X has center X + 0.5; it is covered iff a <= X + 0.5 < a + length.
    """
    lo = math.ceil(a - 0.5)
    hi = math.ceil(a + length - 0.5)
    return lo, hi


def clipped_pixel_span(a: float, length: float, limit: int) -> Tuple[int, int]:
    """`pixel_span` additionally clipped to the canvas range [0, limit)."""
    lo, hi = pixel_span(a, length)
    return max(0, lo), max(max(0, lo), min(limit, hi))


# ---------------------------------------------------------------------------
# Sampling coordinates & filter weight matrices  (NumPy builders)
# ---------------------------------------------------------------------------

def source_coords(px: np.ndarray, a: float, length: float, m: int) -> np.ndarray:
    """Continuous source coords for integer dest pixels ``px`` (float64).

    ``s = (px + 0.5 - a) / length * m - 0.5`` — half-pixel-center mapping of a
    dest span [a, a+length) onto m source samples.

    Near-integer coordinates are snapped (1e-9): divide-then-multiply float
    noise (e.g. ``(px+0.5)/3000*3000``) otherwise turns exact identity
    placements into 2-tap resamples with weights like 1-1e-13 — defeating
    the copy fast path and perturbing nothing visible (the weight change is
    ~14 orders below the uint8 quantization step).  Every engine and the
    oracle share this function, so the contract stays single-sourced.
    """
    s = (np.asarray(px, np.float64) + 0.5 - a) / length * m - 0.5
    snapped = np.rint(s)
    return np.where(np.abs(s - snapped) < 1e-9, snapped, s)


def filter_matrix(px_lo: int, px_hi: int, a: float, length: float, m: int,
                  kind: str = "bilinear", dtype=np.float32) -> np.ndarray:
    """Dense (n_out, m) separable-filter weight matrix.

    kinds:
      * ``bilinear`` — plain 2-tap bilinear with clamp-to-edge (the canvas
        ``drawImage`` contract; exactly 2 taps regardless of scale).
      * ``triangle`` — scale-aware tent (antialiasing) filter: support widens
        by 1/scale on downscale (Pillow/`jax.image.resize` style).
      * ``box`` — area-average on downscale, nearest-ish tent on upscale.

    Rows always sum to 1 (clamp-to-edge accumulates boundary weight).
    """
    n = px_hi - px_lo
    if n <= 0:
        return np.zeros((0, m), dtype)
    px = np.arange(px_lo, px_hi, dtype=np.float64)
    s = source_coords(px, a, length, m)          # (n,)
    idx = np.arange(m, dtype=np.float64)         # (m,)
    scale = length / m                           # dest pixels per source pixel

    if kind == "bilinear":
        sc = np.clip(s, 0.0, m - 1.0)
        w = np.maximum(0.0, 1.0 - np.abs(sc[:, None] - idx[None, :]))
    elif kind == "triangle":
        support = max(1.0, 1.0 / scale)          # widen on downscale
        d = np.abs(s[:, None] - idx[None, :]) / support
        w = np.maximum(0.0, 1.0 - d)
        wsum = w.sum(axis=1, keepdims=True)
        # Degenerate rows (fully outside) fall back to nearest clamped tap.
        bad = (wsum <= 0.0).ravel()
        if bad.any():
            nearest = np.clip(np.rint(s[bad]), 0, m - 1).astype(np.int64)
            w[bad] = 0.0
            w[bad, nearest] = 1.0
            wsum = w.sum(axis=1, keepdims=True)
        w = w / wsum
    elif kind == "lanczos3":
        support = 3.0 * max(1.0, 1.0 / scale)    # widen on downscale
        d = (s[:, None] - idx[None, :]) * (3.0 / support)
        w = np.where(np.abs(d) < 3.0, np.sinc(d) * np.sinc(d / 3.0), 0.0)
        wsum = w.sum(axis=1, keepdims=True)
        bad = (np.abs(wsum) <= 1e-12).ravel()
        if bad.any():
            nearest = np.clip(np.rint(s[bad]), 0, m - 1).astype(np.int64)
            w[bad] = 0.0
            w[bad, nearest] = 1.0
            wsum = w.sum(axis=1, keepdims=True)
        w = w / wsum
    elif kind == "box":
        # Box filter: integrate source over the dest pixel's footprint
        # [ (px - a)/length*m , (px+1 - a)/length*m ).
        left = (px - a) / length * m
        right = (px + 1.0 - a) / length * m
        li = left[:, None]
        ri = right[:, None]
        cell_lo = idx[None, :]
        cell_hi = idx[None, :] + 1.0
        w = np.clip(np.minimum(ri, cell_hi) - np.maximum(li, cell_lo), 0.0, None)
        wsum = w.sum(axis=1, keepdims=True)
        bad = (wsum <= 0.0).ravel()
        if bad.any():   # footprint fully outside: nearest clamped tap
            nearest = np.clip(np.rint(s[bad]), 0, m - 1).astype(np.int64)
            w[bad] = 0.0
            w[bad, nearest] = 1.0
            wsum = w.sum(axis=1, keepdims=True)
        w = w / wsum
    else:
        raise ValueError(f"unknown filter kind {kind!r}")

    if kind == "bilinear":
        # Clamp-to-edge can leave row sums < 1 only if both taps collapse onto
        # the same clamped index; renormalize defensively (no-op in interior).
        wsum = w.sum(axis=1, keepdims=True)
        wsum[wsum <= 0] = 1.0
        w = w / wsum
    return w.astype(dtype)


def bilinear_taps(px_lo: int, px_hi: int, a: float, length: float, m: int):
    """2-tap form of the bilinear matrix: (idx0, idx1, w1) int32/int32/f64.

    ``out[X] = src[idx0[X]] * (1 - w1[X]) + src[idx1[X]] * w1[X]`` — the form
    the Pallas kernel materializes as a banded weight block on the fly.
    """
    px = np.arange(px_lo, px_hi, dtype=np.float64)
    s = np.clip(source_coords(px, a, length, m), 0.0, m - 1.0)
    i0 = np.floor(s).astype(np.int64)
    i0 = np.minimum(i0, m - 1)
    i1 = np.minimum(i0 + 1, m - 1)
    w1 = s - np.floor(s)
    return i0.astype(np.int32), i1.astype(np.int32), w1


def filter_taps(px_lo: int, px_hi: int, a: float, length: float, m: int,
                kind: str = "bilinear"):
    """K-tap form of any separable filter: (i0 (n,) int32, w (n, K) float64).

    ``out[X] = sum_k src[clip(i0[X] + k)] * w[X, k]`` with out-of-range taps
    carrying zero weight and rows renormalized — row-for-row identical to the
    dense :func:`filter_matrix` (each dense row restricted to its K-wide
    support window).  This is the form the Pallas kernel materializes as a
    banded weight block on the fly; K is static per (scale, kind).
    """
    n = px_hi - px_lo
    if n <= 0:
        return np.zeros((0,), np.int32), np.zeros((0, 1), np.float64)
    px = np.arange(px_lo, px_hi, dtype=np.float64)
    scale = length / m

    if kind == "bilinear":
        i0, i1, w1 = bilinear_taps(px_lo, px_hi, a, length, m)
        w = np.stack([1.0 - w1, np.where(i1 > i0, w1, 0.0)], axis=1)
        # clamp-collapsed rows carry all weight on tap 0
        w[:, 0] = np.where(i1 > i0, w[:, 0], 1.0)
        return i0, w

    if kind == "triangle":
        s = source_coords(px, a, length, m)
        support = max(1.0, 1.0 / scale)
        i0 = np.ceil(s - support)
        K = max(2, int(np.ceil(2 * support)) + 1)  # covers (s-sup, s+sup)
        idx = i0[:, None] + np.arange(K)[None, :]
        w = np.maximum(0.0, 1.0 - np.abs(idx - s[:, None]) / support)
    elif kind == "lanczos3":
        s = source_coords(px, a, length, m)
        support = 3.0 * max(1.0, 1.0 / scale)
        i0 = np.ceil(s - support)
        K = max(2, int(np.ceil(2 * support)) + 1)
        idx = i0[:, None] + np.arange(K)[None, :]
        d = (idx - s[:, None]) * (3.0 / support)
        w = np.where(np.abs(d) < 3.0, np.sinc(d) * np.sinc(d / 3.0), 0.0)
    elif kind == "box":
        left = (px - a) / length * m
        right = (px + 1.0 - a) / length * m
        i0 = np.floor(left)
        K = max(1, int(np.ceil(np.max(right - np.floor(left)))))
        idx = i0[:, None] + np.arange(K)[None, :]
        w = np.clip(np.minimum(right[:, None], idx + 1.0)
                    - np.maximum(left[:, None], idx), 0.0, None)
    else:
        raise ValueError(f"unknown filter kind {kind!r}")

    w = np.where((idx >= 0) & (idx <= m - 1), w, 0.0)
    wsum = w.sum(axis=1, keepdims=True)
    # <= eps (not < 0): a clipped lanczos row can leave a tiny or negative
    # sum whose reciprocal would explode — fall back to the nearest tap
    bad = (wsum <= 1e-9).ravel()
    if bad.any():
        s = source_coords(px, a, length, m)
        nearest = np.clip(np.rint(s[bad]), 0, m - 1)
        i0 = i0.astype(np.float64)
        i0[bad] = nearest
        w[bad] = 0.0
        w[bad, 0] = 1.0
        wsum = w.sum(axis=1, keepdims=True)
    w = w / wsum
    # windows starting left of the source: shift the window right and roll
    # the (zero) leading weights out so (i0 + k) -> weight mapping holds
    neg = i0 < 0
    if np.any(neg):
        K = w.shape[1]
        for r in np.nonzero(neg)[0]:
            shift = int(-i0[r])
            w[r] = np.concatenate([w[r, shift:], np.zeros(shift)])[:K]
            i0[r] = 0
    return i0.astype(np.int32), w


def source_band(px_lo: int, px_hi: int, a: float, length: float, m: int,
                kind: str = "bilinear") -> Tuple[int, int]:
    """Source index range [lo, hi) needed to produce dest pixels [px_lo, px_hi).

    Used by the tiler and the Pallas kernel to bound DMA bands.  Monotonic in
    the dest range, so bands of adjacent tiles are adjacent.
    """
    if px_hi <= px_lo:
        return 0, 0
    edges = source_coords(np.asarray([px_lo, px_hi - 1], np.float64), a, length, m)
    if kind == "bilinear":
        return (max(0, min(int(math.floor(edges[0])), m - 1)),
                max(1, min(m, int(math.floor(edges[1])) + 2)))
    r = filter_support(kind, length / m)
    lo = int(math.floor(min(edges) - (r - 1.0)))
    hi = int(math.ceil(max(edges) + r)) + 1
    return max(0, min(lo, m - 1)), max(1, min(m, hi))


def filter_support(kind: str, scale: float) -> float:
    """Half-width (source px) of a filter's footprint at this dest/src scale.

    Every consumer sizing crops/bands from dest spans must use this — a
    triangle widens by 1/scale on downscale and lanczos3 spans 3x that.
    """
    base = {"bilinear": 1.0, "triangle": 1.0, "box": 1.0,
            "lanczos3": 3.0}.get(kind)
    if base is None:
        raise ValueError(f"unknown filter kind {kind!r}")
    return base * max(1.0, 1.0 / scale)


# ---------------------------------------------------------------------------
# Pure-copy (blit) detection
# ---------------------------------------------------------------------------

def identity_axis(i0: np.ndarray, w1: np.ndarray) -> bool:
    """True when resampling this axis is a pure integer-offset copy."""
    if len(i0) == 0:
        return False
    return bool(np.all(w1 == 0.0) and np.all(np.diff(i0) == 1))


def placement_copy_offsets(p, filter_kind: str):
    """If this placement is a pure copy (identity taps both axes), return the
    (src_row0, src_col0) offsets into the *oriented* source; else None.

    The common case: equal-size images concatenated in min/max mode — the
    reference's own hot path degenerates to a blit there too
    (pages/index/index.js:1423-1431).  A copy needs no kernel at all; the
    caller places the oriented source directly.
    """
    if filter_kind != "bilinear":
        return None
    disp_w, disp_h = display_size(p.raw_w, p.raw_h, p.orientation)
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    if r1 <= r0 or c1 <= c0:
        return None
    ri0, _, rw1 = bilinear_taps(r0, r1, p.y0, p.h, disp_h)
    ci0, _, cw1 = bilinear_taps(c0, c1, p.x0, p.w, disp_w)
    if not (identity_axis(ri0, rw1) and identity_axis(ci0, cw1)):
        return None
    if r1 - r0 > disp_h or c1 - c0 > disp_w:
        return None
    return int(ri0[0]), int(ci0[0])


def plan_copy_offsets(plan):
    """``{placement index: (src_row0, src_col0)}`` when EVERY drawn placement
    is a pure blit, else None.  Zero-area placements draw nothing and are
    skipped.  A pure-blit plan needs no resampling anywhere — the canvas is
    sources + background, and export can stream straight from the decoded
    arrays (no device round-trip)."""
    offs = {}
    for p in plan.placements:
        if (p.row_span[1] <= p.row_span[0]
                or p.col_span[1] <= p.col_span[0]):
            continue
        o = placement_copy_offsets(p, plan.filter)
        if o is None:
            return None
        offs[p.index] = o
    return offs


def fill_background(arr: np.ndarray, bg) -> None:
    """Fill an HWC uint8 view with a background color, fast.

    Uniform colors (r==g==b — including the default white) go through
    ndarray.fill (memset, ~7x the broadcast assignment's throughput on
    big canvases); others broadcast the 3-vector.
    """
    bg = np.asarray(bg, np.uint8)
    if int(bg[0]) == int(bg[1]) == int(bg[2]):
        arr.fill(int(bg[0]))
    else:
        arr[:] = bg


def fill_uncovered(canvas: np.ndarray, plan, copies, bg) -> None:
    """Background-fill exactly the canvas regions no placement covers.

    Pure-blit assembly overwrites every covered pixel with a paste, so
    prefilling them is wasted bandwidth — on a gapless equal-size strip
    that is the WHOLE canvas.  Sweeps the elementary row bands between
    placement row boundaries and fills the column gaps in each.
    """
    h, w = canvas.shape[:2]
    drawn = [p for p in plan.placements if p.index in copies]
    breaks = sorted({0, h} | {p.row_span[0] for p in drawn}
                    | {p.row_span[1] for p in drawn})
    for rs, re in zip(breaks, breaks[1:]):
        if re <= rs:
            continue
        spans = sorted(p.col_span for p in drawn
                       if p.row_span[0] <= rs and re <= p.row_span[1])
        c = 0
        for c0, c1 in spans:
            if c0 > c:
                fill_background(canvas[rs:re, c:c0], bg)
            c = max(c, c1)
        if c < w:
            fill_background(canvas[rs:re, c:w], bg)


def normalize_rgb(raw: np.ndarray):
    """uint8 HWC with exactly 3 channels, or None if not representable
    (grayscale is replicated; RGBA callers must composite first)."""
    raw = np.asarray(raw)
    if raw.ndim == 2:
        raw = raw[:, :, None]
    if raw.ndim == 3 and raw.shape[2] == 1:
        raw = np.repeat(raw, 3, axis=2)
    if raw.ndim != 3 or raw.shape[2] != 3:
        return None
    return raw


def paste_blit(canvas: np.ndarray, p, img: np.ndarray, offs) -> None:
    """Copy the oriented source into its placement rect (identity taps)."""
    sr0, sc0 = offs
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    canvas[r0:r1, c0:c1] = img[sr0: sr0 + (r1 - r0),
                               sc0: sc0 + (c1 - c0)]
