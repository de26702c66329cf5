"""Plain PyTorch compositing engine: orient -> K-tap resample -> place.

Port of ``imagestitching_tpu/ops/xla_compose.py``.  Its primitives are the
plain version of both CUDA resize-and-place kernels
(:func:`..ops.cuda_resize.resize_place_ref` and ``resize_place_batch_ref``),
and the cross-check engine (``RuntimeConfig(engine="torch")``,
``BatchedStitch(engine="torch")``) runs :func:`resample` for every drawn
placement through ``cuda_resize``'s placement loop.  Each works on one HWC
job or on a ``(B, H, W, C)`` batch:

* :func:`orient` -- EXIF orientation as ``flip``/``transpose``
  (``orient_jnp``, ``_orient_bhwc``);
* :func:`ktap_axis` -- the K-tap gather that clips ``i0 + k`` to ``[0, m-1]``;
* :func:`to_uint8` -- ``clamp(floor(x + 0.5), 0, 255)``, the framework-wide
  rounding contract (never ``torch.round``, which rounds half to even);
* :func:`placement_taps` -- f64 taps from ``geometry.filter_taps``, cast to
  f32 on the host, element for element ``xla_compose.placement_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import geometry
from ..core.layout import Placement


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """Apply EXIF orientation to the H, W axes of an HWC tensor or of a
    ``(B, H, W, C)`` batch (twin of ``orient_jnp`` and ``_orient_bhwc``)."""
    if orientation in (0, 1):
        return img
    if orientation == 2:
        return img.flip(-2)
    if orientation == 3:
        return img.flip(-3, -2)
    if orientation == 4:
        return img.flip(-3)
    t = img.transpose(-3, -2)
    if orientation == 5:
        return t
    if orientation == 6:
        return t.flip(-2)
    if orientation == 7:
        return t.flip(-3, -2)
    if orientation == 8:
        return t.flip(-3)
    raise ValueError(f"invalid EXIF orientation {orientation}")


def _axis_taps(lo: int, hi: int, a: float, length: float, m: int,
               kind: str) -> dict:
    i0, w = geometry.filter_taps(lo, hi, a, length, m, kind)
    return {"i0": i0, "w": w.astype(np.float32)}


def placement_taps(p: Placement, kind: str) -> dict:
    """Host resample taps of one placement:
    ``{"rows": {"i0", "w"}, "cols": {"i0", "w"}}`` (int32 / float32)."""
    disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    return {
        "rows": _axis_taps(r0, r1, p.y0, p.h, disp_h, kind),
        "cols": _axis_taps(c0, c1, p.x0, p.w, disp_w, kind),
    }


def ktap_axis(img: torch.Tensor, i0: torch.Tensor, w: torch.Tensor,
              axis: int) -> torch.Tensor:
    """K-tap separable resample of float ``img`` along ``axis`` (negative
    axes count from the end, so a leading batch dimension passes through).

    ``i0 (n,)`` window starts, ``w (n, K)`` weights.  Indices are clipped to
    ``[0, m-1]``; out-of-range taps carry zero weight.  Terms are summed in
    k order as separate multiply and add, the order the CUDA kernel keeps.
    """
    axis %= img.ndim
    m = img.shape[axis]
    i0 = i0.to(device=img.device, dtype=torch.int64)
    w = w.to(device=img.device, dtype=img.dtype)
    shape = [1] * img.ndim
    shape[axis] = w.shape[0]
    acc = None
    for k in range(w.shape[1]):
        idx = (i0 + k).clamp(0, m - 1)
        term = img.index_select(axis, idx) * w[:, k].reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """float -> uint8 with round-half-up then clamp (``oracle.to_uint8``)."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0).to(torch.uint8)


def resample(raw: torch.Tensor, orientation: int, ri0: torch.Tensor,
             rw: torch.Tensor, ci0: torch.Tensor,
             cw: torch.Tensor) -> torch.Tensor:
    """Orient, resample rows then cols, quantize: the uint8 region of an
    HWC source, or the ``(B, n_rows, n_cols, C)`` regions of a batch."""
    img = orient(raw, orientation).to(torch.float32)
    img = ktap_axis(img, ri0, rw, -3)
    img = ktap_axis(img, ci0, cw, -2)
    return to_uint8(img)
