"""The plain reference of a stitch, and the comparison that decides
``correct``.

Plain PyTorch, run after the measured window on whatever device the run
has.  It implements the stitch as the port's float64 NumPy oracle
(``imagestitching_tpu_torch/core/oracle.py``) defines it, without importing
it: fill the canvas with the background, EXIF-orient each raw source, then
resample it separably into its dest rect (rows, then columns) by the direct
two-tap bilinear gather with half-pixel centres and clamp-to-edge, and
round half up.  In float64 the arithmetic is the oracle's, operation for
operation.  ``dtype=torch.bfloat16`` computes the same in bfloat16: the
control, the lower precision that the configuration must reject.

Layout comes from the frozen :mod:`.layout`; only the bilinear filter is
implemented (every configuration of the benchmark uses it).
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .layout import Layout, Rect, display_size


def source_coords(lo: int, hi: int, a: float, length: float,
                  m: int) -> np.ndarray:
    """Continuous source coordinates of dest pixels [lo, hi): half-pixel
    centres of a dest span [a, a + length) mapped onto ``m`` samples,
    snapped to an integer within 1e-9."""
    s = (np.arange(lo, hi, dtype=np.float64) + 0.5 - a) / length * m - 0.5
    snapped = np.rint(s)
    return np.where(np.abs(s - snapped) < 1e-9, snapped, s)


def taps(lo: int, hi: int, a: float, length: float, m: int):
    """(i0, i1, w1): ``out[X] = src[i0] * (1 - w1) + src[i1] * w1``."""
    s = np.clip(source_coords(lo, hi, a, length, m), 0.0, m - 1.0)
    i0 = np.minimum(np.floor(s).astype(np.int64), m - 1)
    i1 = np.minimum(i0 + 1, m - 1)
    return i0, i1, s - np.floor(s)


def rect_taps(r: Rect):
    """Row and column taps of a rect against its oriented source."""
    disp_w, disp_h = display_size(r.raw_w, r.raw_h, r.orientation)
    return (taps(*r.row_span, r.y0, r.h, disp_h),
            taps(*r.col_span, r.x0, r.w, disp_w))


def is_copy(r: Rect) -> bool:
    """True when both axes are integer-offset copies (no resampling)."""
    def identity(t):
        i0, _, w1 = t
        return len(i0) > 0 and bool(np.all(w1 == 0.0)
                                    and np.all(np.diff(i0) == 1))
    if r.row_span[1] <= r.row_span[0] or r.col_span[1] <= r.col_span[0]:
        return False
    rows, cols = rect_taps(r)
    return identity(rows) and identity(cols)


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """EXIF orientation of an HWC tensor (a view where one suffices)."""
    if orientation in (0, 1):
        return img
    if orientation in (5, 6, 7, 8):
        img = img.transpose(0, 1)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 5: (), 6: (1,), 7: (0, 1),
             8: (0,)}[orientation]
    return img.flip(flips) if flips else img


def _axis(img: torch.Tensor, axis: int, t, dtype) -> torch.Tensor:
    i0, i1, w1 = (torch.from_numpy(np.ascontiguousarray(x)).to(img.device)
                  for x in t)
    shape = [1] * img.ndim
    shape[axis] = len(w1)
    w1 = w1.to(dtype).reshape(shape)
    t0 = img.index_select(axis, i0).to(dtype)
    t1 = img.index_select(axis, i1).to(dtype)
    return t0 * (1.0 - w1) + t1 * w1


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """Round half up, then clamp to [0, 255]."""
    return torch.floor(x + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def rect_pixels(r: Rect, raw, device, dtype=torch.float64) -> torch.Tensor:
    """The uint8 pixels of one rect, (rows, cols, C), on ``device``."""
    src = torch.as_tensor(np.ascontiguousarray(raw)).to(device)
    if src.ndim == 2:
        src = src[..., None]
    rows_t, cols_t = rect_taps(r)
    rows = _axis(orient(src, r.orientation), 0, rows_t, dtype)
    return to_uint8(_axis(rows, 1, cols_t, dtype))


def _drawn(layout: Layout, raws) -> Iterator[Tuple[Rect, object]]:
    if len(raws) != len(layout.rects):
        raise ValueError(f"{len(raws)} sources for {len(layout.rects)} rects")
    for r, raw in zip(layout.rects, raws):
        if raw.shape[0] != r.raw_h or raw.shape[1] != r.raw_w:
            raise ValueError(f"source {raw.shape[1]}x{raw.shape[0]}, rect "
                             f"says {r.raw_w}x{r.raw_h}")
        if r.row_span[1] > r.row_span[0] and r.col_span[1] > r.col_span[0]:
            yield r, raw


def render(layout: Layout, raws: Sequence, device="cpu",
           dtype=torch.float64, channels: int = 3) -> torch.Tensor:
    """The whole uint8 canvas (H, W, C) on ``device``."""
    bg = torch.tensor(layout.background[:channels], dtype=torch.uint8)
    canvas = bg.to(device).expand(layout.canvas_h, layout.canvas_w,
                                  channels).clone()
    for r, raw in _drawn(layout, raws):
        (r0, r1), (c0, c1) = r.row_span, r.col_span
        canvas[r0:r1, c0:c1] = rect_pixels(r, raw, device, dtype)
    return canvas


def compare(layout: Layout, raws: Sequence, out, device="cpu",
            channels: int = 3) -> Dict[str, float]:
    """Hold one canvas ``out`` (H, W, C uint8, numpy or tensor) to the
    float64 reference of ``raws``.  Returns

    * ``resampled_max_diff``: the largest |out - reference| over the rects
      that resample;
    * ``mismatch_ppm``: per million values of those rects, how many differ;
    * ``exact_max_diff``: the largest |out - reference| over everything
      else: the rects that copy (rotated or not) and the background.

    A canvas of another shape reads 255 / 1e6 / 255."""
    if tuple(out.shape) != (layout.canvas_h, layout.canvas_w, channels):
        return {"resampled_max_diff": 255.0, "mismatch_ppm": 1e6,
                "exact_max_diff": 255.0}
    got = torch.as_tensor(out).to(device)
    covered = torch.zeros(layout.canvas_h, layout.canvas_w, dtype=torch.bool,
                          device=device)
    res_max = exact_max = 0
    res_bad = res_n = 0
    for r, raw in _drawn(layout, raws):
        (r0, r1), (c0, c1) = r.row_span, r.col_span
        if bool(covered[r0:r1, c0:c1].any()):
            raise ValueError("overlapping rects: not a strip")
        covered[r0:r1, c0:c1] = True
        want = rect_pixels(r, raw, device)
        d = (got[r0:r1, c0:c1].int() - want.int()).abs()
        if is_copy(r):
            exact_max = max(exact_max, int(d.max()))
        else:
            res_max = max(res_max, int(d.max()))
            res_bad += int((d > 0).sum())
            res_n += d.numel()
    bg = torch.tensor(layout.background[:channels], dtype=torch.int32,
                      device=device)
    rest = got[~covered]
    if rest.numel():
        exact_max = max(exact_max, int((rest.int() - bg).abs().max()))
    return {"resampled_max_diff": float(res_max),
            "mismatch_ppm": res_bad / res_n * 1e6 if res_n else 0.0,
            "exact_max_diff": float(exact_max)}
