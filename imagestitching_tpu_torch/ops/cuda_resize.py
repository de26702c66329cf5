"""Fused resize-and-place on the card: the CUDA kernels, their plain version,
and the placement step that serves one job, a batch of jobs and the streamed
strategy.

Port of ``imagestitching_tpu/ops/pallas_resize.py:882-1015`` (``_orient_chw``,
``_stitch_jit``, ``CompiledPallasStitch``, ``get_compiled``, ``stitch``), of
the batched engine ``parallel/batch._batched_pallas`` (:33-57) and of the
windowed call ``_WindowPlan.run_chunk`` (:868-875).  The kernels are
``csrc/resize_place.cu``; they replace ``pallas_resize._make_kernel`` as
launched by ``resize_place_one`` (#1), ``resize_place_batch`` (#2) and
``_jitted_call_static`` (#3).

* :func:`resize_place` (one job), :func:`resize_place_batch` (B stacked jobs
  sharing one placement's taps, one launch) and :func:`resize_place_window`
  (one row chunk of a placement from a cropped, oriented source window) are
  the kernels' wrappers.  For tensors on the CPU they run the plain version,
  :func:`resize_place_ref`; for CUDA tensors they launch the kernel or raise.
  There is no fallback between the two.
* ``launches``, ``batch_launches`` and ``window_launches`` count kernel
  launches, so a run can show that its main path went through the kernels.
* :func:`draw_placement` is the one placement step: identity placements are
  slices of the oriented source (as at ``_stitch_jit`` and
  ``batch.py:44-50``), every other drawn placement is resampled by the kernel
  straight into the canvas.  With ``plain=True`` it is the cross-check
  engine's step instead: every drawn placement goes through the plain
  version, with no copy shortcut (the twin of ``xla_compose._stitch_impl``
  and ``batch._batched_xla``).  :func:`stitch` runs it over one job,
  :func:`stitch_batch` over B jobs of one plan, and the pipeline's streamed
  strategy one uploaded source at a time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from imagestitching_tpu.core import geometry
from imagestitching_tpu.core.layout import LayoutPlan, Placement

from . import torch_compose
from .assemble import job_channels, new_canvas, source_tensor

#: Kernel launches by :func:`resize_place` in this process.
launches = 0
#: Kernel launches by :func:`resize_place_batch` in this process.
batch_launches = 0
#: Kernel launches by :func:`resize_place_window` in this process.
window_launches = 0

#: The batched kernel's z-grid bound (``gridDim.z``).
MAX_BATCH = 65535

Taps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _Step(NamedTuple):
    """How one drawn placement is made: device ``taps`` (ri0, rw, ci0, cw)
    for the resample, and for an identity placement ``copy``, the source
    row and col offsets into the oriented source of its slice."""

    copy: Optional[Tuple[int, int]]
    taps: Taps


def resize_place_ref(src: torch.Tensor, orientation: int, ri0: torch.Tensor,
                     rw: torch.Tensor, ci0: torch.Tensor,
                     cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of both kernels: the uint8 ``(n_rows, n_cols,
    C)`` region that the kernel stores into the canvas, or for a ``(B, H, W,
    C)`` batch the ``(B, n_rows, n_cols, C)`` regions."""
    return torch_compose.resample(src, orientation, ri0, rw, ci0, cw)


#: The batched kernel's plain version: the same function on a batch.
resize_place_batch_ref = resize_place_ref


def resize_place_window_ref(crop: torch.Tensor, ri0: torch.Tensor,
                            rw: torch.Tensor, ci0: torch.Tensor,
                            cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the windowed kernel: the uint8 ``(n_rows,
    n_cols, C)`` chunk region of an oriented HWC crop."""
    return torch_compose.resample(crop, 1, ri0, rw, ci0, cw)


def _check(batched: bool, src: torch.Tensor, ri0: torch.Tensor,
           rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
           canvas: torch.Tensor, r0: int, c0: int) -> None:
    if src.dtype != torch.uint8 or canvas.dtype != torch.uint8:
        raise ValueError("src and canvas must be uint8")
    ndim, layout = (4, "BHWC") if batched else (3, "HWC")
    if src.ndim != ndim or canvas.ndim != ndim:
        raise ValueError(f"src and canvas must be {layout}")
    if batched and (src.shape[0] != canvas.shape[0]
                    or not 1 <= src.shape[0] <= MAX_BATCH):
        raise ValueError(f"batch: src {src.shape[0]}, canvas "
                         f"{canvas.shape[0]} (equal, 1 to {MAX_BATCH})")
    if src.shape[-1] != canvas.shape[-1] or src.shape[-1] not in (1, 3):
        raise ValueError(f"channels: src {src.shape[-1]}, canvas "
                         f"{canvas.shape[-1]} (1 or 3, equal)")
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
    canvas_h, canvas_w = canvas.shape[-3], canvas.shape[-2]
    if r0 < 0 or c0 < 0 or r0 + n_rows > canvas_h or c0 + n_cols > canvas_w:
        raise ValueError(f"region {n_rows}x{n_cols} at ({r0}, {c0}) leaves "
                         f"the {canvas_h}x{canvas_w} canvas")


def _place(entry: str, src: torch.Tensor, orientation: int,
           ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
           cw: torch.Tensor, canvas: torch.Tensor, r0: int, c0: int) -> bool:
    """The body of the three wrappers (``entry`` is ``one``, ``batch`` or
    ``window``); True when it launched a kernel."""
    _check(entry == "batch", src, ri0, rw, ci0, cw, canvas, r0, c0)
    if orientation not in range(9):
        raise ValueError(f"invalid EXIF orientation {orientation}")
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    if n_rows == 0 or n_cols == 0:
        return False
    if src.device.type == "cpu":
        canvas[..., r0:r0 + n_rows, c0:c0 + n_cols, :] = resize_place_ref(
            src, orientation, ri0, rw, ci0, cw)
        return False
    if src.device.type != "cuda":
        raise ValueError(f"resize_place runs on cpu or cuda, not {src.device}")
    from . import _build

    lib = _build.load()
    ptr = ctypes.c_void_p
    h, w, c = src.shape[-3:]
    taps = (ptr(ri0.data_ptr()), ptr(rw.data_ptr()), n_rows, rw.shape[1],
            ptr(ci0.data_ptr()), ptr(cw.data_ptr()), n_cols, cw.shape[1])
    canvas_hw = (canvas.shape[-3], canvas.shape[-2], r0, c0)
    # the launch goes to the current device; the context restores the
    # caller's device afterwards
    with torch.cuda.device(src.device):
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        if entry == "batch":
            err = lib.resize_place_batch_launch(
                ptr(src.data_ptr()), src.shape[0], src.stride(0), h, w, c,
                orientation, *taps, ptr(canvas.data_ptr()), canvas.stride(0),
                *canvas_hw, stream)
        elif entry == "window":
            err = lib.resize_place_window_launch(
                ptr(src.data_ptr()), h, w, c, *taps, ptr(canvas.data_ptr()),
                canvas.shape[0], stream)
        else:
            err = lib.resize_place_launch(
                ptr(src.data_ptr()), h, w, c, orientation, *taps,
                ptr(canvas.data_ptr()), *canvas_hw, stream)
    if err != 0:
        raise RuntimeError("resize_place kernel launch failed: "
                           + lib.resize_place_error_string(err).decode())
    return True


def resize_place(src: torch.Tensor, orientation: int, ri0: torch.Tensor,
                 rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                 canvas: torch.Tensor, r0: int, c0: int) -> None:
    """Resample the raw HWC uint8 ``src`` (EXIF ``orientation``) with the
    K-tap row taps ``(ri0, rw)`` and column taps ``(ci0, cw)`` and store the
    uint8 result into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place."""
    global launches
    if _place("one", src, orientation, ri0, rw, ci0, cw, canvas, r0, c0):
        launches += 1


def resize_place_batch(src_bhwc: torch.Tensor, orientation: int,
                       ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
                       cw: torch.Tensor, canvas_bhwc: torch.Tensor, r0: int,
                       c0: int) -> None:
    """:func:`resize_place` for B stacked jobs that share the placement:
    ``src_bhwc (B, H, W, C)``, ``canvas_bhwc (B, canvas_h, canvas_w, C)``,
    one kernel launch for the whole batch."""
    global batch_launches
    if _place("batch", src_bhwc, orientation, ri0, rw, ci0, cw, canvas_bhwc,
              r0, c0):
        batch_launches += 1


def resize_place_window(crop: torch.Tensor, ri0: torch.Tensor,
                        rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                        region: torch.Tensor) -> None:
    """Resample one row chunk of a placement: ``crop`` is the oriented HWC
    uint8 source row window, ``(ri0, rw)`` the chunk's row taps rebased to
    it, ``(ci0, cw)`` the placement's column taps.  The uint8 result goes to
    ``region[:n_rows]`` of the ``(rows, n_cols, C)`` region buffer, in
    place."""
    global window_launches
    if region.ndim != 3 or region.shape[1] != ci0.shape[0]:
        raise ValueError(f"region {tuple(region.shape)} must be (rows, "
                         f"{ci0.shape[0]}, C)")
    if _place("window", crop, 1, ri0, rw, ci0, cw, region, 0, 0):
        window_launches += 1


# ---------------------------------------------------------------------------
# The placement loop: one job, or a batch of jobs of one plan
# ---------------------------------------------------------------------------

#: Steps of recent plans, keyed on ``(plan.signature(), device)``, never on
#: ``shape_signature()``: taps follow the fractional rects, and plans that
#: share spans but not sub-pixel phase must not share taps.  The oldest
#: entry goes once there are ``_STEPS_MAX``.  The lock keeps the server's
#: worker thread and callers of :func:`stitch` on other threads apart.
_steps_cache: Dict[tuple, List[Optional[_Step]]] = {}
_steps_lock = threading.Lock()
_STEPS_MAX = 16


def plan_steps(plan: LayoutPlan,
               device: torch.device) -> List[Optional[_Step]]:
    """Per placement: None (zero area, draws nothing) or its step, with the
    taps on ``device``."""
    key = (plan.signature(), device)
    with _steps_lock:
        steps = _steps_cache.get(key)
    if steps is None:
        steps = _make_steps(plan, device)
        with _steps_lock:
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
        t = torch_compose.placement_taps(p, plan.filter)
        steps.append(_Step(
            geometry.placement_copy_offsets(p, plan.filter),
            tuple(torch.from_numpy(a).to(device)
                  for a in (t["rows"]["i0"], t["rows"]["w"],
                            t["cols"]["i0"], t["cols"]["w"]))))
    return steps


def draw_placement(src: torch.Tensor, p: Placement, step: _Step,
                   canvas: torch.Tensor, plain: bool) -> None:
    """Draw placement ``p`` from its raw source into ``canvas`` in place: an
    HWC source and canvas for one job (kernel #1), ``(B, H, W, C)`` ones for
    a batch (kernel #2)."""
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    if plain:
        canvas[..., r0:r1, c0:c1, :] = resize_place_ref(
            src, p.orientation, *step.taps)
    elif step.copy is not None:
        # identity taps on both axes: the resample IS a slice of the
        # oriented source -- no kernel
        sr, sc = step.copy
        oriented = torch_compose.orient(src, p.orientation)
        canvas[..., r0:r1, c0:c1, :] = oriented[
            ..., sr:sr + r1 - r0, sc:sc + c1 - c0, :]
    elif canvas.ndim == 4:
        resize_place_batch(src, p.orientation, *step.taps, canvas, r0, c0)
    else:
        resize_place(src, p.orientation, *step.taps, canvas, r0, c0)


def _compose(plan: LayoutPlan, srcs: Sequence[torch.Tensor],
             canvas: torch.Tensor, steps: Sequence[Optional[_Step]],
             plain: bool) -> None:
    """Draw every placement into ``canvas``."""
    for src, p, step in zip(srcs, plan.placements, steps):
        if step is not None:
            draw_placement(src, p, step, canvas, plain)


def stitch(plan: LayoutPlan, images: Sequence[np.ndarray], device,
           plain: bool = False) -> torch.Tensor:
    """One job on ``device``: the uint8 HWC canvas tensor.  Work is enqueued
    on the current stream; the caller synchronises."""
    device = torch.device(device)
    channels = job_channels(plan, images)
    srcs = [source_tensor(raw, p, channels, device)
            for raw, p in zip(images, plan.placements)]
    canvas = new_canvas(plan, channels, device)
    _compose(plan, srcs, canvas, plan_steps(plan, device), plain)
    return canvas


def _stack_tensors(plan: LayoutPlan, stacks: Sequence,
                  device: torch.device) -> List[torch.Tensor]:
    """Slot stacks (numpy arrays or tensors, slot i ``(B, H_i, W_i, C)``
    uint8) as contiguous tensors on ``device``, checked against the plan
    (the JAX ``BatchedStitch.__call__``'s checks and messages)."""
    if len(stacks) != len(plan.placements):
        raise ValueError("image-slot count does not match plan")
    out, batch, channels = [], None, None
    for arr, p in zip(stacks, plan.placements):
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if batch is None and arr.ndim == 4:
            batch, channels = arr.shape[0], arr.shape[3]
        if arr.ndim != 4 or arr.shape[0] != batch:
            raise ValueError(f"slot {p.index}: expected (B={batch}, H, W, C),"
                             f" got {tuple(arr.shape)}")
        if tuple(arr.shape[1:3]) != (p.raw_h, p.raw_w):
            raise ValueError(
                f"slot {p.index}: got {arr.shape[2]}x{arr.shape[1]}, "
                f"plan says {p.raw_w}x{p.raw_h}")
        if arr.dtype != torch.uint8:
            raise ValueError("batched stitch expects uint8")
        if arr.shape[3] != channels or channels not in (1, 3):
            raise ValueError(f"slot {p.index}: {arr.shape[3]} channels, "
                             f"slot 0 has {channels} (1 or 3, equal)")
        out.append(arr.to(device).contiguous())
    return out


def stitch_batch(plan: LayoutPlan, stacks: Sequence, device,
                 plain: bool = False,
                 steps: Optional[Sequence[Optional[_Step]]] = None,
                 ) -> torch.Tensor:
    """B jobs of one plan on ``device``: ``stacks[i]`` is image slot i's
    ``(B, H_i, W_i, C)`` uint8 stack (numpy or tensor); returns the
    ``(B, canvas_h, canvas_w, C)`` uint8 canvas tensor.  One kernel launch
    per resampled placement for the whole batch.  ``steps`` (from
    :func:`plan_steps`) lets a caller hold its taps; work is enqueued on the
    current stream and the caller synchronises."""
    device = torch.device(device)
    srcs = _stack_tensors(plan, stacks, device)
    canvas = new_canvas(plan, srcs[0].shape[3], device, (srcs[0].shape[0],))
    _compose(plan, srcs, canvas,
             plan_steps(plan, device) if steps is None else steps, plain)
    return canvas
