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

* The kernels launch prepared, as kernel #4's
  ``staged_resize.StagedLaunch`` does: the checks, the packing of a
  :class:`PlaceArgs` and the tile choice (``resize_place_prepare``) happen
  once, and each launch checks its tensors with a few compares and makes
  one ``ctypes`` call.  :class:`PlaceLaunch` is #1 or #2 for one placement
  and one pair of source and canvas shapes, :class:`PlacementLauncher`
  holds one per pair seen, and :class:`WindowLauncher` is #3 for the many
  chunks of one placement (per chunk the crop, the chunk's first tap row
  and the crop's start).  For tensors on the CPU they run the plain
  version, :func:`resize_place_ref`; for CUDA tensors they launch the
  kernel or raise.  There is no fallback between the two.
* :func:`resize_place` (one job), :func:`resize_place_batch` (B stacked jobs
  sharing one placement's taps, one launch) and :func:`resize_place_window`
  (one row chunk of a placement from a cropped, oriented source window)
  make such a launch and call it once, as
  ``staged_resize.resize_place_staged`` does for #4.
* ``launches``, ``batch_launches`` and ``window_launches`` count kernel
  launches, so a run can show that its main path went through the kernels.
* :func:`draw_placement` is the one placement step: identity placements are
  slices of the oriented source (as at ``_stitch_jit`` and
  ``batch.py:44-50``), every other drawn placement is resampled by the
  step's prepared kernel straight into the canvas.  With ``plain=True`` it
  is the cross-check engine's step instead: every drawn placement goes
  through the plain version, with no copy shortcut (the twin of
  ``xla_compose._stitch_impl`` and ``batch._batched_xla``).  :func:`stitch`
  runs it over one job, :func:`stitch_batch` over B jobs of one plan (its
  ``batch.h2d`` and ``batch.draw`` spans), and the pipeline's streamed
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
from ..runtime import spans
from . import torch_compose
from .assemble import job_channels, new_canvas, source_tensor

#: Launches of kernel #1 (one job) in this process.
launches = 0
#: Launches of kernel #2 (a batch of jobs) in this process.
batch_launches = 0
#: Launches of kernel #3 (a row chunk of a placement) in this process.
window_launches = 0
# the cards of a jobs-mesh flush launch #2 from their own threads
_count_lock = threading.Lock()

#: The batched kernel's z-grid bound (``gridDim.z``).
MAX_BATCH = 65535

Taps = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class _Step(NamedTuple):
    """How one drawn placement is made: device ``taps`` (ri0, rw, ci0, cw)
    for the resample, for an identity placement ``copy``, the source row
    and col offsets into the oriented source of its slice, and ``launch``,
    its prepared kernel (a :class:`PlacementLauncher`)."""

    copy: Optional[Tuple[int, int]]
    taps: Taps
    launch: "PlacementLauncher"


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


def _launch_error(lib, what: str, err: int) -> RuntimeError:
    return RuntimeError(f"resize_place {what} failed: "
                        + lib.resize_place_error_string(err).decode())


def _window_checks(ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
                   cw: torch.Tensor, region: torch.Tensor,
                   crop_shape: Sequence[int]) -> Tuple[int, int, int]:
    """What every chunk of kernel #3 shares: the taps, the ``(rows, n_cols,
    C)`` region buffer and the crop shape, returned as a tuple."""
    if region.dtype != torch.uint8 or region.ndim != 3 \
            or not region.is_contiguous():
        raise ValueError("region must be a contiguous uint8 (rows, "
                         "n_cols, C) tensor")
    if region.shape[1] != ci0.shape[0]:
        raise ValueError(f"region {tuple(region.shape)} must be (rows, "
                         f"{ci0.shape[0]}, C)")
    if region.shape[2] not in (1, 3):
        raise ValueError(f"channels: {region.shape[2]} (1 or 3)")
    shape = tuple(int(s) for s in crop_shape)
    if len(shape) != 3 or shape[2] != region.shape[2] or min(shape) < 1:
        raise ValueError(f"crop shape {shape} must be (rows, width, "
                         f"{region.shape[2]})")
    if region.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resize_place runs on cpu or cuda, not "
                         f"{region.device}")
    _check_taps(ri0, rw, ci0, cw, region.device)
    return shape


def _window_rows(ri0: torch.Tensor, region: torch.Tensor, row_start: int,
                 n_rows: Optional[int]) -> int:
    """A chunk's row count (default: to the last row), checked against the
    taps and the region."""
    if n_rows is None:
        n_rows = ri0.shape[0] - row_start
    if row_start < 0 or n_rows < 0 or row_start + n_rows > ri0.shape[0] \
            or n_rows > region.shape[0]:
        raise ValueError(f"rows [{row_start}, {row_start + n_rows}) of "
                         f"{ri0.shape[0]} into a region of "
                         f"{region.shape[0]}")
    return n_rows


# ---------------------------------------------------------------------------
# Prepared launches: checked and packed once, one ctypes call a launch
# ---------------------------------------------------------------------------

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class PlaceArgs(ctypes.Structure):
    """The C struct ``PlaceArgs`` of ``csrc/resize_place.cu``, field by field
    in its order: a launch's fixed arguments, then what
    ``resize_place_prepare`` derives from them (the orientation map, the
    tile, the grid's columns, the shared memory, the kernel)."""

    _fields_ = [
        ("ri0", _p), ("rw", _p), ("ci0", _p), ("cw", _p), ("canvas", _p),
        ("src_h", _i64), ("src_w", _i64), ("src_stride", _i64),
        ("canvas_h", _i64), ("canvas_w", _i64), ("canvas_stride", _i64),
        ("r0", _i64), ("c0", _i64),
        ("channels", _i32), ("orientation", _i32), ("batch", _i32),
        ("n_rows", _i32), ("tap_rows", _i32), ("k_rows", _i32),
        ("n_cols", _i32), ("k_cols", _i32),
        # filled by resize_place_prepare
        ("base", _i64), ("sy", _i64), ("sx", _i64),
        ("m_h", _i32), ("m_w", _i32), ("tile_r", _i32), ("tile_c", _i32),
        ("tiles_c", _i32), ("smem_bytes", _i32), ("kernel", _p)]


def _prepare(args: PlaceArgs, index: int):
    """``resize_place_prepare`` of ``args`` on card ``index``: the library,
    or ``RuntimeError``."""
    from . import _build

    lib = _build.load()
    with torch.cuda.device(index):
        err = lib.resize_place_prepare(ctypes.byref(args))
    if err != 0:
        raise _launch_error(lib, "prepare", err)
    return lib


def _raw_stream():
    """The current stream's handle as an int, without a Stream object."""
    return getattr(torch._C, "_cuda_getCurrentRawStream", None) \
        or (lambda i: torch.cuda.current_stream(i).cuda_stream)


class PlaceLaunch:
    """Kernel #1 (HWC ``src`` and ``canvas``) or #2 (``(B, H, W, C)`` ones)
    prepared for one placement: resample with the row taps ``(ri0, rw)``
    and column taps ``(ci0, cw)`` into ``canvas[..., r0:r0+n_rows,
    c0:c0+n_cols, :]`` in place, once per call, for any source and canvas
    of the shapes, dtype and device of ``src`` and ``canvas``, contiguous.

    The launch's arguments are checked here, once.  On the card the
    launch is packed into :class:`PlaceArgs`, whose tile
    ``resize_place_prepare`` picks (:attr:`args`); a call compares its
    tensors with what was prepared and makes one ``ctypes`` call.  On the
    CPU a call runs the plain version.  The launch holds references to the
    taps."""

    def __init__(self, src: torch.Tensor, orientation: int,
                 ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
                 cw: torch.Tensor, canvas: torch.Tensor, r0: int, c0: int):
        self.batched = canvas.ndim == 4
        _check(self.batched, src, ri0, rw, ci0, cw, canvas, r0, c0)
        if orientation not in range(9):
            raise ValueError(f"invalid EXIF orientation {orientation}")
        if src.device.type not in ("cpu", "cuda"):
            raise ValueError(f"resize_place runs on cpu or cuda, not "
                             f"{src.device}")
        self.orientation, self.taps = orientation, (ri0, rw, ci0, cw)
        self.r0, self.c0 = r0, c0
        self._shapes = (src.shape, canvas.shape)
        self._device, self._index = src.device, src.get_device()
        n_rows, n_cols = ri0.shape[0], ci0.shape[0]
        self._empty = n_rows == 0 or n_cols == 0
        self.args: Optional[PlaceArgs] = None
        if self._index < 0 or self._empty:
            return
        h, w, c = src.shape[-3:]
        canvas_h, canvas_w = canvas.shape[-3:-1]
        self.args = a = PlaceArgs(
            ri0.data_ptr(), rw.data_ptr(), ci0.data_ptr(), cw.data_ptr(),
            None, h, w, h * w * c, canvas_h, canvas_w,
            canvas_h * canvas_w * c, r0, c0, c, orientation,
            src.shape[0] if self.batched else 1, n_rows, n_rows,
            rw.shape[1], n_cols, cw.shape[1])
        self._lib = _prepare(a, self._index)
        self._ref = ctypes.addressof(a)
        self._run = self._lib.resize_place_run
        self._stream = _raw_stream()

    def __call__(self, src: torch.Tensor, canvas: torch.Tensor) -> None:
        global launches, batch_launches
        if (src.shape, canvas.shape) != self._shapes \
                or src.dtype is not torch.uint8 \
                or canvas.dtype is not torch.uint8 \
                or src.device != self._device \
                or canvas.device != self._device \
                or not (src.is_contiguous() and canvas.is_contiguous()):
            raise ValueError(
                f"src {tuple(src.shape)} {src.dtype} and canvas "
                f"{tuple(canvas.shape)} {canvas.dtype} on {src.device} / "
                f"{canvas.device}: prepared for contiguous uint8 "
                f"{tuple(self._shapes[0])} and {tuple(self._shapes[1])} on "
                f"{self._device}")
        if self._empty:
            return
        if self._index < 0:
            n_rows, n_cols = self.taps[0].shape[0], self.taps[2].shape[0]
            canvas[..., self.r0:self.r0 + n_rows, self.c0:self.c0 + n_cols,
                   :] = resize_place_ref(src, self.orientation, *self.taps)
            return
        # the launch goes to the current device: make it the tensors' for
        # the call where it is not
        if torch.cuda.current_device() == self._index:
            err = self._run(self._ref, src.data_ptr(), canvas.data_ptr(),
                            self._stream(self._index))
        else:
            with torch.cuda.device(self._index):
                err = self._run(self._ref, src.data_ptr(), canvas.data_ptr(),
                                self._stream(self._index))
        if err != 0:
            raise _launch_error(self._lib, "kernel launch", err)
        with _count_lock:
            if self.batched:
                batch_launches += 1
            else:
                launches += 1


class PlacementLauncher:
    """The prepared kernel of one drawn placement (``orientation``, its
    ``taps`` and the region's corner ``(r0, c0)``): #1 for an HWC source
    and canvas, #2 for ``(B, H, W, C)`` ones.  It holds one
    :class:`PlaceLaunch` per pair of source and canvas shapes (a job's
    channel count, a batch's size), made at the pair's first call; the
    oldest goes once there are ``_LAUNCHES_MAX``."""

    _LAUNCHES_MAX = 8

    def __init__(self, orientation: int, taps: Taps, r0: int, c0: int):
        self.orientation, self.taps = orientation, taps
        self.r0, self.c0 = r0, c0
        self._launches: Dict[tuple, PlaceLaunch] = {}
        self._lock = threading.Lock()

    def __call__(self, src: torch.Tensor, canvas: torch.Tensor) -> None:
        key = (src.shape, canvas.shape)
        launch = self._launches.get(key)
        if launch is None:
            launch = PlaceLaunch(src, self.orientation, *self.taps, canvas,
                                 self.r0, self.c0)
            with self._lock:
                self._launches[key] = launch
                if len(self._launches) > self._LAUNCHES_MAX:
                    del self._launches[next(iter(self._launches))]
        launch(src, canvas)


class WindowLauncher:
    """Kernel #3 for the row chunks of one placement, prepared.

    ``(ri0, rw)`` are the placement's row taps and ``(ci0, cw)`` its column
    taps, ``region`` the ``(rows, n_cols, C)`` uint8 region buffer and
    ``crop_shape`` the ``(crop_rows, width, C)`` of every chunk's crop.
    What the chunks share is checked here, once; on a CUDA device the
    launch is packed into :class:`PlaceArgs` and ``resize_place_prepare``
    picks its tile for the region's rows.  A call checks only the crop and
    the chunk's rows and makes one ``ctypes`` call; a chunk of fewer rows
    launches fewer row tiles of the same tile.  On the CPU a call runs the
    plain version."""

    def __init__(self, ri0: torch.Tensor, rw: torch.Tensor,
                 ci0: torch.Tensor, cw: torch.Tensor, region: torch.Tensor,
                 crop_shape: Sequence[int]):
        self.crop_shape = torch.Size(_window_checks(ri0, rw, ci0, cw, region,
                                                    crop_shape))
        self.taps, self.region = (ri0, rw, ci0, cw), region
        self.device, self._index = region.device, region.get_device()
        self.args: Optional[PlaceArgs] = None
        if self._index < 0:
            return
        crop_rows, width, c = self.crop_shape
        n_cols = ci0.shape[0]
        self.args = a = PlaceArgs(
            ri0.data_ptr(), rw.data_ptr(), ci0.data_ptr(), cw.data_ptr(),
            region.data_ptr(), crop_rows, width, 0, region.shape[0], n_cols,
            0, 0, 0, c, 1, 1, min(region.shape[0], ri0.shape[0]),
            ri0.shape[0], rw.shape[1], n_cols, cw.shape[1])
        self._lib = _prepare(a, self._index)
        self._ref = ctypes.addressof(a)
        self._run = self._lib.resize_place_window_run
        self._stream = _raw_stream()

    def __call__(self, crop: torch.Tensor, row_start: int = 0,
                 row_shift: int = 0, n_rows: Optional[int] = None) -> None:
        """Resample rows ``[row_start, row_start + n_rows)`` of the
        placement (default: to the last) from ``crop``, whose first row is
        row ``row_shift`` of the oriented source, into
        ``region[:n_rows]``, in place."""
        global window_launches
        if crop.shape != self.crop_shape or crop.dtype is not torch.uint8 \
                or crop.device != self.device or not crop.is_contiguous():
            raise ValueError(f"crop {tuple(crop.shape)} {crop.dtype} on "
                             f"{crop.device} must be a contiguous uint8 "
                             f"{tuple(self.crop_shape)} on {self.device}")
        n_rows = _window_rows(self.taps[0], self.region, row_start, n_rows)
        if n_rows == 0 or self.region.shape[1] == 0:
            return
        if self._index < 0:
            self.region[:n_rows] = resize_place_window_ref(
                crop, *self.taps, row_start, row_shift, n_rows)
            return
        if torch.cuda.current_device() == self._index:
            err = self._run(self._ref, crop.data_ptr(), row_start, row_shift,
                            n_rows, self._stream(self._index))
        else:       # the launch goes to the current device
            with torch.cuda.device(self._index):
                err = self._run(self._ref, crop.data_ptr(), row_start,
                                row_shift, n_rows, self._stream(self._index))
        if err != 0:
            raise _launch_error(self._lib, "kernel launch", err)
        window_launches += 1


def resize_place(src: torch.Tensor, orientation: int, ri0: torch.Tensor,
                 rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                 canvas: torch.Tensor, r0: int, c0: int) -> None:
    """Resample the raw HWC uint8 ``src`` (EXIF ``orientation``) with the
    K-tap row taps ``(ri0, rw)`` and column taps ``(ci0, cw)`` and store the
    uint8 result into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place: a
    :class:`PlaceLaunch` made and called once."""
    if canvas.ndim != 3:
        raise ValueError("src and canvas must be HWC")
    PlaceLaunch(src, orientation, ri0, rw, ci0, cw, canvas, r0,
                c0)(src, canvas)


def resize_place_batch(src_bhwc: torch.Tensor, orientation: int,
                       ri0: torch.Tensor, rw: torch.Tensor, ci0: torch.Tensor,
                       cw: torch.Tensor, canvas_bhwc: torch.Tensor, r0: int,
                       c0: int) -> None:
    """:func:`resize_place` for B stacked jobs that share the placement:
    ``src_bhwc (B, H, W, C)``, ``canvas_bhwc (B, canvas_h, canvas_w, C)``,
    one kernel launch for the whole batch."""
    if canvas_bhwc.ndim != 4:
        raise ValueError("src and canvas must be BHWC")
    PlaceLaunch(src_bhwc, orientation, ri0, rw, ci0, cw, canvas_bhwc, r0,
                c0)(src_bhwc, canvas_bhwc)


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
    buffer, in place: a :class:`WindowLauncher` made and called once."""
    WindowLauncher(ri0, rw, ci0, cw, region, crop.shape)(crop, row_start,
                                                         row_shift, n_rows)


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
        taps = tuple(torch.from_numpy(a).to(device)
                     for a in (t["rows"]["i0"], t["rows"]["w"],
                               t["cols"]["i0"], t["cols"]["w"]))
        steps.append(_Step(geometry.placement_copy_offsets(p, plan.filter),
                           taps,
                           PlacementLauncher(p.orientation, taps, r0, c0)))
    return steps


def draw_placement(src: torch.Tensor, p: Placement, step: _Step,
                   canvas: torch.Tensor, plain: bool) -> None:
    """Draw placement ``p`` from its raw source into ``canvas`` in place: an
    HWC source and canvas for one job (kernel #1), ``(B, H, W, C)`` ones for
    a batch (kernel #2), launched prepared (``step.launch``)."""
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
    else:
        step.launch(src, canvas)


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


def _stack_tensors(plan: LayoutPlan, slots: Sequence[Sequence[torch.Tensor]],
                   device: torch.device, rows: int,
                   channels: int) -> List[torch.Tensor]:
    """Each slot's jobs' ``(H_i, W_i, C)`` uint8 tensors, as the caller
    checked them, copied from where they lie into their rows of a ``(rows,
    H_i, W_i, C)`` stack made on ``device``.  The rows past the jobs (a
    mesh's padding, every row of a warm-up) are zero jobs."""
    out = []
    for jobs, p in zip(slots, plan.placements):
        dst = torch.empty((rows, p.raw_h, p.raw_w, channels),
                          dtype=torch.uint8, device=device)
        for i, arr in enumerate(jobs):
            dst[i].copy_(arr)
        dst[len(jobs):].zero_()
        out.append(dst)
    return out


def stitch_batch(plan: LayoutPlan, slots: Sequence[Sequence[torch.Tensor]],
                 device, rows: int, channels: int, plain: bool = False,
                 steps: Optional[Sequence[Optional[_Step]]] = None,
                 card: int = 0) -> torch.Tensor:
    """Up to ``rows`` jobs of one plan on ``device``: ``slots[i]`` is image
    slot i's jobs' ``(H_i, W_i, C)`` uint8 tensors, ``C = channels``, as
    ``parallel.batch.BatchedStitch`` checked them, copied into a stack of
    ``rows`` rows on ``device`` (:func:`_stack_tensors`); returns the
    ``(rows, canvas_h, canvas_w, C)`` uint8 canvas tensor.  One kernel
    launch per resampled placement for the whole batch.  ``steps`` (from
    :func:`plan_steps`) lets a caller hold its taps; work is enqueued on the
    current stream and the caller synchronises.  ``card``, the batch's
    index on a mesh's ``jobs`` axis, is counted on its spans."""
    device = torch.device(device)
    with spans.span("batch.h2d") as s:
        s.counts = {"card": card}
        srcs = _stack_tensors(plan, slots, device, rows, channels)
    with spans.span("batch.draw", start_ns=s.end_ns) as draw:
        draw.counts = {"card": card}
        canvas = new_canvas(plan, channels, device, (rows,))
        _compose(plan, srcs, canvas,
                 plan_steps(plan, device) if steps is None else steps, plain)
    return canvas
