"""Canvas assembly: one preallocated canvas, regions written as slices.

Port of ``imagestitching_tpu/ops/assemble.py``.  JAX arrays are immutable,
so the JAX package builds the canvas as one concatenation tree to write each
byte once.  A torch tensor can be updated in place: the canvas is allocated
once with ``torch.empty``, filled with the background, and every placement
writes its region (a copy slice, or the kernel's store) straight into it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.layout import LayoutPlan, Placement


def job_channels(plan: LayoutPlan, images: Sequence[np.ndarray]) -> int:
    """Channel count of a job (1 or 3; ``api._unify_channels`` makes a job
    uniform)."""
    if len(images) != len(plan.placements):
        raise ValueError("image count does not match plan")
    a0 = np.asarray(images[0])
    return a0.shape[2] if a0.ndim == 3 else 1


def new_canvas(plan: LayoutPlan, channels: int, device,
               batch_shape: Tuple[int, ...] = (),
               rows: Optional[int] = None) -> torch.Tensor:
    """``(*batch_shape, canvas_h, canvas_w, channels)`` uint8 on ``device``,
    background filled (twin of ``assemble_canvas(batch_shape=)``); with
    ``rows``, a band of that many canvas rows instead."""
    h = plan.canvas_h if rows is None else rows
    canvas = torch.empty((*batch_shape, h, plan.canvas_w, channels),
                         dtype=torch.uint8, device=device)
    bg = plan.background[:channels]
    if len(set(bg)) == 1:
        canvas.fill_(int(bg[0]))
    else:
        canvas.copy_(torch.tensor(bg, dtype=torch.uint8).expand_as(canvas))
    return canvas


def source_array(raw: np.ndarray, p: Placement,
                 channels: int) -> np.ndarray:
    """Raw (un-oriented) uint8 source as an HWC array, checked against its
    placement."""
    arr = np.asarray(raw)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.dtype != np.uint8:
        raise ValueError(f"image {p.index}: expected uint8, got {arr.dtype}")
    if arr.shape[:2] != (p.raw_h, p.raw_w):
        raise ValueError(
            f"image {p.index}: got {arr.shape[1]}x{arr.shape[0]}, "
            f"plan says {p.raw_w}x{p.raw_h}")
    if arr.shape[2] != channels:
        raise ValueError(f"image {p.index}: {arr.shape[2]} channels, "
                         f"expected {channels}")
    return arr


def source_tensor(raw: np.ndarray, p: Placement, channels: int,
                  device) -> torch.Tensor:
    """Raw (un-oriented) uint8 HWC source as a contiguous tensor on
    ``device``, checked against its placement."""
    return torch.from_numpy(
        np.ascontiguousarray(source_array(raw, p, channels))).to(device)
