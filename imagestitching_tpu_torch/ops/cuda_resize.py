"""Fused resize-and-place on the card: the CUDA kernel, its plain version, and
the whole-job engine.

Port of ``imagestitching_tpu/ops/pallas_resize.py:882-1015`` (``_orient_chw``,
``_stitch_jit``, ``CompiledPallasStitch``, ``get_compiled``, ``stitch``).  The
kernel itself is ``csrc/resize_place.cu``; it replaces
``pallas_resize._make_kernel`` as launched by ``resize_place_one``.

* :func:`resize_place` is the kernel's wrapper.  For tensors on the CPU it
  runs the plain version, :func:`resize_place_ref`; for CUDA tensors it
  launches the kernel or raises.  There is no fallback between the two.
* ``launches`` counts kernel launches, so a run can show that its main path
  went through the kernel.
* :func:`stitch` runs one job: identity placements are slices of the
  oriented source (as at ``_stitch_jit``), every other drawn placement is
  resampled by :func:`resize_place` straight into the canvas.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from imagestitching_tpu.core import geometry
from imagestitching_tpu.core.layout import LayoutPlan

from . import torch_compose
from .assemble import job_channels, new_canvas, source_tensor

#: Kernel launches by :func:`resize_place` in this process.
launches = 0

Taps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _Step(NamedTuple):
    """How one drawn placement is made: a copy slice at ``copy`` (source
    row, col offsets into the oriented source), or a kernel launch with
    device ``taps`` (ri0, rw, ci0, cw)."""

    copy: Optional[Tuple[int, int]]
    taps: Optional[Taps]


def resize_place_ref(src: torch.Tensor, orientation: int, ri0: torch.Tensor,
                     rw: torch.Tensor, ci0: torch.Tensor,
                     cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the uint8 ``(n_rows, n_cols, C)``
    region that the kernel stores into the canvas."""
    return torch_compose.resample(src, orientation, ri0, rw, ci0, cw)


def _check(src: torch.Tensor, ri0: torch.Tensor, rw: torch.Tensor,
           ci0: torch.Tensor, cw: torch.Tensor, canvas: torch.Tensor,
           r0: int, c0: int) -> None:
    if src.dtype != torch.uint8 or canvas.dtype != torch.uint8:
        raise ValueError("src and canvas must be uint8")
    if src.ndim != 3 or canvas.ndim != 3:
        raise ValueError("src and canvas must be HWC")
    if src.shape[2] != canvas.shape[2] or src.shape[2] not in (1, 3):
        raise ValueError(f"channels: src {src.shape[2]}, canvas "
                         f"{canvas.shape[2]} (1 or 3, equal)")
    if not (src.is_contiguous() and canvas.is_contiguous()):
        raise ValueError("src and canvas must be contiguous")
    for name, t, dt, nd in (("ri0", ri0, torch.int32, 1),
                            ("rw", rw, torch.float32, 2),
                            ("ci0", ci0, torch.int32, 1),
                            ("cw", cw, torch.float32, 2)):
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d {dt}")
        if t.device != src.device:
            raise ValueError(f"{name} on {t.device}, src on {src.device}")
    if canvas.device != src.device:
        raise ValueError(f"canvas on {canvas.device}, src on {src.device}")
    if rw.shape[0] != ri0.shape[0] or cw.shape[0] != ci0.shape[0]:
        raise ValueError("tap starts and weights differ in length")
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    if (r0 < 0 or c0 < 0 or r0 + n_rows > canvas.shape[0]
            or c0 + n_cols > canvas.shape[1]):
        raise ValueError(f"region {n_rows}x{n_cols} at ({r0}, {c0}) leaves "
                         f"the {canvas.shape[0]}x{canvas.shape[1]} canvas")


def resize_place(src: torch.Tensor, orientation: int, ri0: torch.Tensor,
                 rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                 canvas: torch.Tensor, r0: int, c0: int) -> None:
    """Resample the raw HWC uint8 ``src`` (EXIF ``orientation``) with the
    K-tap row taps ``(ri0, rw)`` and column taps ``(ci0, cw)`` and store the
    uint8 result into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place."""
    global launches
    _check(src, ri0, rw, ci0, cw, canvas, r0, c0)
    if orientation not in range(9):
        raise ValueError(f"invalid EXIF orientation {orientation}")
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    if n_rows == 0 or n_cols == 0:
        return
    if src.device.type == "cpu":
        canvas[r0:r0 + n_rows, c0:c0 + n_cols] = resize_place_ref(
            src, orientation, ri0, rw, ci0, cw)
        return
    if src.device.type != "cuda":
        raise ValueError(f"resize_place runs on cpu or cuda, not {src.device}")
    from . import _build

    lib = _build.load()
    ptr = ctypes.c_void_p
    # the launch goes to the current device; the context restores the
    # caller's device afterwards
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.resize_place_launch(
            ptr(src.data_ptr()), src.shape[0], src.shape[1], src.shape[2],
            orientation,
            ptr(ri0.data_ptr()), ptr(rw.data_ptr()), n_rows, rw.shape[1],
            ptr(ci0.data_ptr()), ptr(cw.data_ptr()), n_cols, cw.shape[1],
            ptr(canvas.data_ptr()), canvas.shape[0], canvas.shape[1], r0, c0,
            ptr(stream))
    if err != 0:
        raise RuntimeError("resize_place kernel launch failed: "
                           + lib.resize_place_error_string(err).decode())
    launches += 1


# ---------------------------------------------------------------------------
# Whole-job engine
# ---------------------------------------------------------------------------

#: Steps of recent plans, keyed on ``(plan.signature(), device)``, never on
#: ``shape_signature()``: taps follow the fractional rects, and plans that
#: share spans but not sub-pixel phase must not share taps.  The oldest
#: entry goes once there are ``_STEPS_MAX``.
_steps_cache: Dict[tuple, List[Optional[_Step]]] = {}
_STEPS_MAX = 16


def _steps(plan: LayoutPlan, device: torch.device) -> List[Optional[_Step]]:
    """Per placement: None (zero area, draws nothing), a copy, or the
    kernel's taps on ``device``."""
    key = (plan.signature(), device)
    steps = _steps_cache.get(key)
    if steps is None:
        steps = _make_steps(plan, device)
        _steps_cache[key] = steps
        if len(_steps_cache) > _STEPS_MAX:
            del _steps_cache[next(iter(_steps_cache))]
    return steps


def _make_steps(plan: LayoutPlan,
                device: torch.device) -> List[Optional[_Step]]:
    steps: List[Optional[_Step]] = []
    for p in plan.placements:
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if r1 <= r0 or c1 <= c0:
            steps.append(None)
            continue
        copy = geometry.placement_copy_offsets(p, plan.filter)
        if copy is not None:
            steps.append(_Step(copy, None))
            continue
        t = torch_compose.placement_taps(p, plan.filter)
        steps.append(_Step(None, tuple(
            torch.from_numpy(a).to(device)
            for a in (t["rows"]["i0"], t["rows"]["w"],
                      t["cols"]["i0"], t["cols"]["w"]))))
    return steps


def stitch(plan: LayoutPlan, images: Sequence[np.ndarray],
           device) -> torch.Tensor:
    """One job on ``device``: the uint8 HWC canvas tensor.  Work is enqueued
    on the current stream; the caller synchronises."""
    device = torch.device(device)
    channels = job_channels(plan, images)
    canvas = new_canvas(plan, channels, device)
    for raw, p, step in zip(images, plan.placements,
                            _steps(plan, device)):
        if step is None:
            continue
        src = source_tensor(raw, p, channels, device)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if step.copy is not None:
            # identity taps on both axes: the resample IS a slice of the
            # oriented source -- no kernel
            sr, sc = step.copy
            oriented = torch_compose.orient(src, p.orientation)
            canvas[r0:r1, c0:c1] = oriented[sr:sr + r1 - r0,
                                            sc:sc + c1 - c0]
            continue
        resize_place(src, p.orientation, *step.taps, canvas, r0, c0)
    return canvas
