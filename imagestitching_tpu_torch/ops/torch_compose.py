"""Plain PyTorch compositing engine: orient -> K-tap resample -> place.

Port of ``imagestitching_tpu/ops/xla_compose.py``.  It is the cross-check
engine (``RuntimeConfig(engine="torch")``) on either device, and its
primitives are the plain version of the CUDA resize-and-place kernel
(:func:`..ops.cuda_resize.resize_place_ref`):

* :func:`orient` -- EXIF orientation as ``flip``/``permute`` (``orient_jnp``);
* :func:`ktap_axis` -- the K-tap gather that clips ``i0 + k`` to ``[0, m-1]``;
* :func:`to_uint8` -- ``clamp(floor(x + 0.5), 0, 255)``, the framework-wide
  rounding contract (never ``torch.round``, which rounds half to even);
* :func:`placement_taps` -- f64 taps from ``geometry.filter_taps``, cast to
  f32 on the host, element for element ``xla_compose.placement_params``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from imagestitching_tpu.core import geometry
from imagestitching_tpu.core.layout import LayoutPlan, Placement


def orient(img: torch.Tensor, orientation: int) -> torch.Tensor:
    """Apply EXIF orientation to an HWC tensor (twin of ``orient_jnp``)."""
    if orientation in (0, 1):
        return img
    if orientation == 2:
        return img.flip(1)
    if orientation == 3:
        return img.flip(0, 1)
    if orientation == 4:
        return img.flip(0)
    t = img.transpose(0, 1)
    if orientation == 5:
        return t
    if orientation == 6:
        return t.flip(1)
    if orientation == 7:
        return t.flip(0, 1)
    if orientation == 8:
        return t.flip(0)
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
    """K-tap separable resample of float ``img`` along ``axis``.

    ``i0 (n,)`` window starts, ``w (n, K)`` weights.  Indices are clipped to
    ``[0, m-1]``; out-of-range taps carry zero weight.  Terms are summed in
    k order as separate multiply and add, the order the CUDA kernel keeps.
    """
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
    """Orient, resample rows then cols, quantize: the uint8 region."""
    img = orient(raw, orientation).to(torch.float32)
    img = ktap_axis(img, ri0, rw, 0)
    img = ktap_axis(img, ci0, cw, 1)
    return to_uint8(img)


def stitch(plan: LayoutPlan, images: Sequence[np.ndarray],
           device) -> torch.Tensor:
    """Whole job on ``device``: every drawn placement resampled (no copy
    shortcut, as in ``xla_compose._stitch_impl``).  Returns the uint8 HWC
    canvas tensor."""
    from .assemble import job_channels, new_canvas, source_tensor

    channels = job_channels(plan, images)
    canvas = new_canvas(plan, channels, device)
    for raw, p in zip(images, plan.placements):
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if r1 <= r0 or c1 <= c0:
            continue
        src = source_tensor(raw, p, channels, device)
        t = placement_taps(p, plan.filter)
        canvas[r0:r1, c0:c1] = resample(
            src, p.orientation,
            *(torch.from_numpy(a) for a in (t["rows"]["i0"], t["rows"]["w"],
                                            t["cols"]["i0"], t["cols"]["w"])))
    return canvas
