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
* :class:`WindowLauncher` is kernel #3 for the many chunks of one placement:
  it checks once what the chunks share (the placement's taps, the region
  buffer, the crop shape), binds the entry and the stream, and per chunk
  passes only the crop, the chunk's first tap row and the crop's start.
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

from ..core import geometry
from ..core.layout import LayoutPlan, Placement
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
                            cw: torch.Tensor, row_start: int = 0,
                            row_shift: int = 0,
                            n_rows: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of the windowed kernel: the uint8 ``(n_rows,
    n_cols, C)`` chunk region of an oriented HWC crop, from rows
    ``[row_start, row_start + n_rows)`` of the row taps with ``row_shift``
    subtracted from their starts."""
    if n_rows is None:
        n_rows = ri0.shape[0] - row_start
    rows = slice(row_start, row_start + n_rows)
    return resize_place_ref(crop, 1, ri0[rows] - row_shift, rw[rows], ci0,
                            cw)


def _check_taps(ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
                cw: torch.Tensor, device: torch.device) -> None:
    for name, t, dt, nd in (("ri0", ri0, torch.int32, 1),
                            ("rw", rw, torch.float32, 2),
                            ("ci0", ci0, torch.int32, 1),
                            ("cw", cw, torch.float32, 2)):
        if t.dtype != dt or t.ndim != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d {dt}")
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, src on {device}")
    if rw.shape[0] != ri0.shape[0] or cw.shape[0] != ci0.shape[0]:
        raise ValueError("tap starts and weights differ in length")


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
    _check_taps(ri0, rw, ci0, cw, src.device)
    if canvas.device != src.device:
        raise ValueError(f"canvas on {canvas.device}, src on {src.device}")
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    canvas_h, canvas_w = canvas.shape[-3], canvas.shape[-2]
    if r0 < 0 or c0 < 0 or r0 + n_rows > canvas_h or c0 + n_cols > canvas_w:
        raise ValueError(f"region {n_rows}x{n_cols} at ({r0}, {c0}) leaves "
                         f"the {canvas_h}x{canvas_w} canvas")


def _place(entry: str, src: torch.Tensor, orientation: int,
           ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
           cw: torch.Tensor, canvas: torch.Tensor, r0: int, c0: int) -> bool:
    """The body of kernels #1 and #2 (``entry`` is ``one`` or ``batch``);
    True when it launched a kernel."""
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

    def start():
        stream = ptr(torch.cuda.current_stream().cuda_stream)
        if entry == "batch":
            return lib.resize_place_batch_launch(
                ptr(src.data_ptr()), src.shape[0], src.stride(0), h, w, c,
                orientation, *taps, ptr(canvas.data_ptr()), canvas.stride(0),
                *canvas_hw, stream)
        return lib.resize_place_launch(
            ptr(src.data_ptr()), h, w, c, orientation, *taps,
            ptr(canvas.data_ptr()), *canvas_hw, stream)

    # the launch goes to the current device: make it the tensors' for the
    # call where it is not
    if torch.cuda.current_device() == src.device.index:
        err = start()
    else:
        with torch.cuda.device(src.device):
            err = start()
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


class WindowLauncher:
    """Kernel #3 for the row chunks of one placement.

    ``(ri0, rw)`` are the placement's row taps and ``(ci0, cw)`` its column
    taps, ``region`` the ``(rows, n_cols, C)`` uint8 region buffer and
    ``crop_shape`` the ``(crop_rows, width, C)`` of every chunk's crop.
    What the chunks share is checked here, once, and on a CUDA device the
    library entry, the pointers and the stream current now are bound; a
    call checks only the crop and the chunk's rows, then launches."""

    def __init__(self, ri0: torch.Tensor, rw: torch.Tensor,
                 ci0: torch.Tensor, cw: torch.Tensor, region: torch.Tensor,
                 crop_shape: Sequence[int]):
        if region.dtype != torch.uint8 or region.ndim != 3 \
                or not region.is_contiguous():
            raise ValueError("region must be a contiguous uint8 (rows, "
                             "n_cols, C) tensor")
        if region.shape[1] != ci0.shape[0]:
            raise ValueError(f"region {tuple(region.shape)} must be (rows, "
                             f"{ci0.shape[0]}, C)")
        if region.shape[2] not in (1, 3):
            raise ValueError(f"channels: {region.shape[2]} (1 or 3)")
        self.crop_shape = tuple(int(s) for s in crop_shape)
        if len(self.crop_shape) != 3 or self.crop_shape[2] != region.shape[2] \
                or min(self.crop_shape) < 1:
            raise ValueError(f"crop shape {self.crop_shape} must be (rows, "
                             f"width, {region.shape[2]})")
        device = region.device
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"resize_place runs on cpu or cuda, not {device}")
        _check_taps(ri0, rw, ci0, cw, device)
        self.taps, self.region = (ri0, rw, ci0, cw), region
        self.device = device
        self._fn = None
        if device.type == "cuda":
            from . import _build

            lib = _build.load()
            ptr = ctypes.c_void_p
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream().cuda_stream
            self._fn, self._error = (lib.resize_place_window_launch,
                                     lib.resize_place_error_string)
            self._ri0, self._rw = ri0.data_ptr(), rw.data_ptr()
            self._k = rw.shape[1]
            self._cols = (ptr(ci0.data_ptr()), ptr(cw.data_ptr()),
                          ci0.shape[0], cw.shape[1], ptr(region.data_ptr()),
                          region.shape[0], ptr(stream))

    def __call__(self, crop: torch.Tensor, row_start: int = 0,
                 row_shift: int = 0, n_rows: Optional[int] = None) -> None:
        """Resample rows ``[row_start, row_start + n_rows)`` of the
        placement (default: to the last) from ``crop``, whose first row is
        row ``row_shift`` of the oriented source, into
        ``region[:n_rows]``, in place."""
        global window_launches
        ri0 = self.taps[0]
        if n_rows is None:
            n_rows = ri0.shape[0] - row_start
        if tuple(crop.shape) != self.crop_shape or crop.dtype != torch.uint8 \
                or crop.device != self.device or not crop.is_contiguous():
            raise ValueError(f"crop {tuple(crop.shape)} {crop.dtype} on "
                             f"{crop.device} must be a contiguous uint8 "
                             f"{self.crop_shape} on {self.device}")
        if row_start < 0 or n_rows < 0 or row_start + n_rows > ri0.shape[0] \
                or n_rows > self.region.shape[0]:
            raise ValueError(f"rows [{row_start}, {row_start + n_rows}) of "
                             f"{ri0.shape[0]} into a region of "
                             f"{self.region.shape[0]}")
        if n_rows == 0:
            return
        if self._fn is None:
            self.region[:n_rows] = resize_place_window_ref(
                crop, *self.taps, row_start, row_shift, n_rows)
            return
        args = (ctypes.c_void_p(crop.data_ptr()), *self.crop_shape,
                ctypes.c_void_p(self._ri0 + 4 * row_start),
                ctypes.c_void_p(self._rw + 4 * row_start * self._k),
                row_shift, n_rows, self._k, *self._cols)
        if torch.cuda.current_device() == self.device.index:
            err = self._fn(*args)
        else:       # the launch goes to the current device
            with torch.cuda.device(self.device):
                err = self._fn(*args)
        if err != 0:
            raise RuntimeError("resize_place kernel launch failed: "
                               + self._error(err).decode())
        window_launches += 1


def resize_place_window(crop: torch.Tensor, ri0: torch.Tensor,
                        rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                        region: torch.Tensor, row_start: int = 0,
                        row_shift: int = 0,
                        n_rows: Optional[int] = None) -> None:
    """Resample one row chunk of a placement: ``crop`` is the oriented HWC
    uint8 source row window, whose first row is row ``row_shift`` of the
    oriented source; ``(ri0, rw)`` the row taps, of which rows
    ``[row_start, row_start + n_rows)`` are the chunk's (default: all from
    ``row_start``); ``(ci0, cw)`` the placement's column taps.  The uint8
    result goes to ``region[:n_rows]`` of the ``(rows, n_cols, C)`` region
    buffer, in place.  One chunk of :class:`WindowLauncher`."""
    if crop.ndim != 3:
        raise ValueError(f"crop {tuple(crop.shape)} must be HWC")
    WindowLauncher(ri0, rw, ci0, cw, region, crop.shape)(
        crop, row_start, row_shift, n_rows)


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
