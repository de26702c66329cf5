"""Kernel #4: a placement resampled from a ring of staged source bands.

Port of the TPU kernel of ``benchmarks/profile_bf16_stage.py:29-100``
(``make_kernel``, ``build``): BASELINE config 5's slot 0 (a 1920x1080
source into a 1024x576 min-mode slot), each output tile computed from a
band of the source that a ring of three copies staged two tiles ahead,
with the band kept as uint8 or as bf16.  The kernel is
``csrc/resize_place_staged.cu``; :class:`StagedLaunch` is its prepared
launch, :func:`resize_place_staged` the one-shot wrapper and
:func:`resize_place_staged_ref` its plain version.

* The **band source** (:func:`stage_source`) is the oriented HWC source,
  uint8 or bf16 (a uint8 value is exact in bf16, so both give the same
  bits), a view of a buffer whose rows are padded to a multiple of
  :data:`ALIGN_C` pixels, so that its pitch is a multiple of 16 bytes, as
  the kernel's tensor map needs.
* The **schedule** (:func:`band_schedule`, the port's copy of the logic of
  ``pallas_resize._Schedule._band_size`` / ``_band_starts``,
  ``imagestitching_tpu/ops/pallas_resize.py:358-385``): one band size for
  every tile, sized from the actual taps, and a band start per tile row and
  per tile column (neither aligned: the kernel starts a column's TMA boxes
  on the 16-byte boundary at or before it; the TPU's (8, 128) is left
  behind).  :func:`staged_schedule`
  picks the largest tile whose ring of bf16 bands leaves room for
  :data:`CTAS_PER_SM` CTAs on an SM, since the kernel's default grid is
  as many CTAs as the SMs hold, and holds the starts on the device.
* **Prepare once, launch many** (:class:`StagedLaunch`, the twin of the JAX
  script's ``build``): the checks and the packing of the launch's fixed
  arguments into :class:`StagedArgs` happen once; each call checks the band
  source against what was prepared with a few integer compares and makes
  one ``ctypes`` call.
* For tensors on the CPU the launch runs the plain version; for CUDA
  tensors it launches the kernel or raises.  There is no fallback between
  the two.  ``staged_launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import torch_compose
from .cuda_resize import _check_taps

#: Kernel launches by :class:`StagedLaunch` in this process.
staged_launches = 0

#: Row padding of a band source in pixels: 16 pixels of 1 or 3 channels of
#: 1 or 2 bytes make a pitch of a whole number of 16 bytes.
ALIGN_C = 16
#: Band column alignment in pixels: none, the kernel's TMA boxes start on
#: the 16-byte boundary at or before a band.
BAND_ALIGN_C = 1
#: Bands in a CTA's ring: the one it computes and the two ahead, as in the
#: TPU kernel's ring.
SLOTS = 3
#: Dynamic shared memory a CTA may take on Hopper (227 KB).
SMEM_CAP = 227 * 1024
#: Shared memory of a Hopper SM (228 KB); each resident CTA takes
#: :data:`CTA_RESERVED` bytes of it beyond its own.
SM_SMEM = 228 * 1024
CTA_RESERVED = 1024
#: CTAs with bf16 bands that an SM should hold at the picked tile (uint8
#: bands take less): on config 5's slot more resident CTAs, one or two
#: tiles each, ran faster than one CTA an SM walking four or five.
CTAS_PER_SM = 2
#: Output tiles (rows, cols) the picker tries, largest first.
TILES = ((32, 64), (16, 64), (32, 32), (8, 64), (16, 32), (8, 32), (4, 32),
         (4, 16), (2, 16), (1, 16))
#: A TMA box: at most this many bytes wide and rows tall.
BOX_MAX = 256
#: Each box lands on a 128-byte boundary in shared memory.
BOX_ALIGN = 128

_DTYPES = {torch.uint8: 1, torch.bfloat16: 2}


class Bands(NamedTuple):
    """One placement's band schedule: the band start of each tile row and
    each tile column (int32), and the band size every tile shares."""

    row_starts: np.ndarray
    col_starts: np.ndarray
    band_h: int
    band_w: int


class StagedSchedule(NamedTuple):
    """What a launch of kernel #4 takes besides its tensors: the output tile,
    the band size and the band starts (int32 on the launch's device), and
    the shapes they were made for, ``(m_h, m_w, n_rows, n_cols, k_rows,
    k_cols)``."""

    tile_r: int
    tile_c: int
    band_h: int
    band_w: int
    row_starts: torch.Tensor
    col_starts: torch.Tensor
    shapes: Tuple[int, int, int, int, int, int]

    @property
    def grid(self) -> Tuple[int, int]:
        """Tiles (rows, cols)."""
        return len(self.row_starts), len(self.col_starts)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _axis(i0: np.ndarray, k: int, m: int, tile: int,
          align: int) -> Tuple[np.ndarray, int]:
    """Band starts and size along one axis: per group of ``tile`` outputs,
    the span of its taps clamped to ``[0, m - 1]``, as the kernel clamps
    them; the size covers the widest span after its start is aligned down,
    and every band ends inside the source padded to ``align``."""
    i0 = np.asarray(i0, np.int64)
    n = len(i0)
    groups = -(-n // tile)
    pad = np.pad(i0, (0, groups * tile - n), mode="edge")
    taps = np.clip(pad[:, None] + np.arange(k)[None, :], 0, m - 1)
    taps = taps.reshape(groups, tile * k)
    lo, hi = taps.min(axis=1), taps.max(axis=1) + 1
    m_pad = _round_up(m, align)
    band = min(m_pad, _round_up(int((hi - lo).max()) + align - 1, align))
    starts = np.minimum(lo // align * align, m_pad - band)
    if (starts > lo).any() or (hi - starts > band).any():
        raise ValueError("band schedule does not cover the taps of a tile")
    return starts.astype(np.int32), band


def band_schedule(ri0, ci0, k_rows: int, k_cols: int, m_h: int, m_w: int,
                  tile_r: int, tile_c: int,
                  align_c: int = BAND_ALIGN_C) -> Bands:
    """The band schedule of a placement's taps ``ri0`` / ``ci0`` (starts of
    ``k_rows`` / ``k_cols`` taps into an ``m_h x m_w`` oriented source) for
    ``tile_r x tile_c`` output tiles: rows aligned to 1, columns to
    ``align_c`` pixels.  Raises ``ValueError`` when a band does not cover
    the clamped taps of its tile."""
    if min(k_rows, k_cols, m_h, m_w, tile_r, tile_c, align_c) < 1:
        raise ValueError("taps, source, tile and alignment must be >= 1")
    if len(ri0) == 0 or len(ci0) == 0:
        raise ValueError("empty dest rect")
    rows, band_h = _axis(ri0, k_rows, m_h, tile_r, 1)
    cols, band_w = _axis(ci0, k_cols, m_w, tile_c, align_c)
    return Bands(rows, cols, band_h, band_w)


def box_geometry(band_h: int, band_w: int,
                 px_bytes: int) -> Tuple[int, int, int, int, int, int]:
    """How the kernel cuts a ``band_h x band_w`` band of ``px_bytes``-byte
    pixels into TMA boxes: ``(box_bytes, box_step, boxes, box_rows,
    row_boxes, box_stride)``.  The boxes of a band row start on the 16-byte
    boundary at or before it (the card takes no other box start), ``boxes``
    of them ``box_step`` bytes apart (a whole number of 16 bytes, as even as
    they can be) cover the row and the up to 15 bytes before it, and each is
    16 bytes longer than its step, at most :data:`BOX_MAX` bytes, so that no
    pixel straddles two boxes.  ``row_boxes`` equal boxes of ``box_rows``
    rows cover the band's height; a column of boxes takes ``box_stride``
    bytes of shared memory, a multiple of :data:`BOX_ALIGN`."""
    row = band_w * px_bytes + 15
    boxes = -(-row // (BOX_MAX - 16))
    step = _round_up(-(-row // boxes), 16)
    row_boxes = -(-band_h // BOX_MAX)
    box_rows = -(-band_h // row_boxes)
    return (step + 16, step, boxes, box_rows, row_boxes,
            _round_up(row_boxes * box_rows * (step + 16), BOX_ALIGN))


def smem_bytes(tile_r: int, tile_c: int, band_h: int, band_w: int,
               channels: int, elt: int, k_rows: int, k_cols: int) -> int:
    """Dynamic shared memory of one CTA, as the kernel lays it out: slack to
    align its base to :data:`BOX_ALIGN`, the ring of :data:`SLOTS` bands of
    ``elt``-byte values cut into boxes, two uint8 output tiles with rows
    padded to 4 bytes, two buffers of the tile's taps (an offset and a
    weight per tap), and an mbarrier per slot."""
    _, _, boxes, _, _, stride = box_geometry(band_h, band_w, channels * elt)
    return (BOX_ALIGN + SLOTS * boxes * stride
            + _round_up(2 * tile_r * _round_up(tile_c * channels, 4), 16)
            + 16 * (tile_r * k_rows + tile_c * k_cols) + 8 * SLOTS)


def staged_schedule(ri0: torch.Tensor, ci0: torch.Tensor, k_rows: int,
                    k_cols: int, m_h: int, m_w: int,
                    channels: int) -> StagedSchedule:
    """The schedule of kernel #4 for a placement's taps, on the taps'
    device: the first tile of :data:`TILES` whose ring of bf16 bands leaves
    room for :data:`CTAS_PER_SM` CTAs on an SM's :data:`SM_SMEM`, else the
    first whose ring fits :data:`SMEM_CAP`.  Both band dtypes share it (a
    ring of uint8 bands is smaller).  The kernel's default grid is as many
    CTAs as the SMs hold at its occupancy, at most one a tile, so the
    picker plans for occupancy, not for tiles a CTA: on config 5's slot 0
    (576 tiles of 16x64 on an H100) 480 of the 528 CTAs of uint8 bands walk
    one tile, and the 264 of bf16 bands two or three.  Raises
    ``ValueError`` when no tile fits (a wide filter at a deep downscale)."""
    ri0_h = ri0.cpu().numpy()
    ci0_h = ci0.cpu().numpy()
    n_rows, n_cols = len(ri0_h), len(ci0_h)
    best = None
    for tr, tc in TILES:
        tr, tc = min(tr, n_rows), min(tc, n_cols)
        b = band_schedule(ri0_h, ci0_h, k_rows, k_cols, m_h, m_w, tr, tc)
        smem = smem_bytes(tr, tc, b.band_h, b.band_w, channels, 2, k_rows,
                          k_cols)
        if smem > SMEM_CAP:
            continue
        shared = CTAS_PER_SM * (smem + CTA_RESERVED) <= SM_SMEM
        if best is None or shared:
            best = (tr, tc, b)
        if shared:
            break
    if best is None:
        raise ValueError(
            f"no output tile of {list(TILES)} fits {SLOTS} bf16 bands in "
            f"{SMEM_CAP} bytes of shared memory (K = {k_rows} x {k_cols}, "
            f"source {m_h}x{m_w})")
    tr, tc, b = best
    return StagedSchedule(
        tr, tc, b.band_h, b.band_w,
        torch.from_numpy(b.row_starts).to(ri0.device),
        torch.from_numpy(b.col_starts).to(ri0.device),
        (m_h, m_w, n_rows, n_cols, k_rows, k_cols))


def stage_source(src_hwc: torch.Tensor,
                 dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """The band source of an oriented uint8 HWC source: a ``(H, W, C)``
    view, as ``dtype`` (uint8, or bf16 by ``src.to(torch.bfloat16)``), of a
    zeroed buffer whose rows are padded to a multiple of :data:`ALIGN_C`
    pixels, on the source's device."""
    if src_hwc.dtype != torch.uint8 or src_hwc.ndim != 3:
        raise ValueError("src must be an HWC uint8 tensor")
    if dtype not in _DTYPES:
        raise ValueError(f"band dtype {dtype} (uint8 or bfloat16)")
    h, w, c = src_hwc.shape
    buf = torch.zeros((h, _round_up(w, ALIGN_C), c), dtype=dtype,
                      device=src_hwc.device)
    buf[:, :w] = src_hwc.to(dtype)
    return buf[:, :w]


def resize_place_staged_ref(band_src: torch.Tensor, ri0: torch.Tensor,
                            rw: torch.Tensor, ci0: torch.Tensor,
                            cw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel #4: the uint8 ``(n_rows, n_cols, C)``
    region of a band source (either dtype), resampled as
    ``torch_compose.resample`` does."""
    return torch_compose.resample(band_src.to(torch.float32), 1, ri0, rw,
                                  ci0, cw)


def _storage_end(band_src: torch.Tensor) -> int:
    """Bytes of storage the kernel may read: through the last row's padded
    width."""
    h, w, c = band_src.shape
    return (band_src.storage_offset() + (h - 1) * band_src.stride(0)
            + _round_up(w, ALIGN_C) * c) * _DTYPES[band_src.dtype]


def _check(band_src: torch.Tensor, ri0: torch.Tensor, rw: torch.Tensor,
           ci0: torch.Tensor, cw: torch.Tensor, canvas: torch.Tensor,
           r0: int, c0: int) -> None:
    if band_src.dtype not in _DTYPES:
        raise ValueError(f"band source {band_src.dtype} (uint8 or bfloat16)")
    if canvas.dtype != torch.uint8:
        raise ValueError("canvas must be uint8")
    if band_src.ndim != 3 or canvas.ndim != 3:
        raise ValueError("band source and canvas must be HWC")
    h, w, c = band_src.shape
    if c not in (1, 3) or canvas.shape[2] != c:
        raise ValueError(f"channels: band source {c}, canvas "
                         f"{canvas.shape[2]} (1 or 3, equal)")
    if band_src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"resize_place_staged runs on cpu or cuda, not "
                         f"{band_src.device}")
    if canvas.device != band_src.device:
        raise ValueError(f"canvas on {canvas.device}, band source on "
                         f"{band_src.device}")
    if not canvas.is_contiguous():
        raise ValueError("canvas must be contiguous")
    # rows dense inside, their pitch padded: every band lies in the buffer
    elt = _DTYPES[band_src.dtype]
    pitch = band_src.stride(0)
    if band_src.stride(2) != 1 or band_src.stride(1) != c:
        raise ValueError("band source rows must be dense (stride (., C, 1)): "
                         "make it with stage_source")
    if (pitch * elt) % 16 or pitch < _round_up(w, ALIGN_C) * c \
            or band_src.data_ptr() % 16 \
            or band_src.untyped_storage().nbytes() < _storage_end(band_src):
        raise ValueError(
            f"band source pitch {pitch * elt} bytes: rows must start on 16 "
            f"bytes and hold {_round_up(w, ALIGN_C)} pixels (stage_source)")
    _check_taps(ri0, rw, ci0, cw, band_src.device)
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    canvas_h, canvas_w = canvas.shape[:2]
    if r0 < 0 or c0 < 0 or r0 + n_rows > canvas_h or c0 + n_cols > canvas_w:
        raise ValueError(f"region {n_rows}x{n_cols} at ({r0}, {c0}) leaves "
                         f"the {canvas_h}x{canvas_w} canvas")


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64


class StagedArgs(ctypes.Structure):
    """The C struct ``StagedArgs`` of ``csrc/resize_place_staged.cu``, field
    by field in its order: the launch's fixed arguments, then what
    ``resize_place_staged_prepare`` derives from them."""

    _fields_ = [
        ("ri0", _p), ("rw", _p), ("ci0", _p), ("cw", _p),
        ("row_starts", _p), ("col_starts", _p), ("canvas", _p),
        ("pitch", _i64), ("canvas_h", _i64), ("canvas_w", _i64),
        ("r0", _i64), ("c0", _i64),
        ("elt_bytes", _i32), ("channels", _i32), ("m_h", _i32),
        ("m_w", _i32), ("n_rows", _i32), ("k_rows", _i32), ("n_cols", _i32),
        ("k_cols", _i32), ("band_h", _i32), ("band_w", _i32),
        ("tile_r", _i32), ("tile_c", _i32), ("ctas", _i32),
        # filled by resize_place_staged_prepare
        ("px_bytes", _i32), ("tiles_c", _i32), ("tiles", _i32),
        ("box_bytes", _i32), ("box_step", _i32), ("boxes", _i32),
        ("box_rows", _i32),
        ("row_boxes", _i32), ("box_stride", _i32), ("slot_bytes", _i32),
        ("out_pitch", _i32), ("smem_bytes", _i32), ("per_sm", _i32),
        ("grid", _i32), ("device", _i32), ("kernel", _p)]


def _error(lib, what: str, err: int) -> RuntimeError:
    return RuntimeError(f"resize_place_staged {what} failed: "
                        + lib.resize_place_error_string(err).decode())


class StagedLaunch:
    """Kernel #4 prepared for one placement: resample a band source
    (:func:`stage_source`) with the row taps ``(ri0, rw)`` and column taps
    ``(ci0, cw)`` into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place, once
    per call, for any band source of the shape, dtype, device and strides
    of ``band_src``.

    Everything :func:`resize_place_staged` checks is checked here, once;
    ``schedule`` (:func:`staged_schedule` of these taps) is made here when
    not given.  ``ctas`` is the kernel's grid (each CTA walks tiles
    ``blockIdx.x + k * ctas`` in order); 0 takes the persistent default, as
    many CTAs as the SMs hold at the kernel's occupancy.  On the card the
    fixed arguments are packed into :class:`StagedArgs` and checked by
    ``resize_place_staged_prepare``; :attr:`args` shows what it derived
    (grid, shared memory, boxes).  The launch holds references to the taps,
    the schedule and the canvas."""

    def __init__(self, band_src: torch.Tensor, ri0: torch.Tensor,
                 rw: torch.Tensor, ci0: torch.Tensor, cw: torch.Tensor,
                 canvas: torch.Tensor, r0: int, c0: int, *,
                 schedule: Optional[StagedSchedule] = None, ctas: int = 0):
        _check(band_src, ri0, rw, ci0, cw, canvas, r0, c0)
        m_h, m_w, c = band_src.shape
        n_rows, n_cols = ri0.shape[0], ci0.shape[0]
        k_rows, k_cols = rw.shape[1], cw.shape[1]
        if ctas < 0:
            raise ValueError(f"ctas {ctas} (0 for the default)")
        self._empty = n_rows == 0 or n_cols == 0
        if schedule is None and not self._empty:
            schedule = staged_schedule(ri0, ci0, k_rows, k_cols, m_h, m_w, c)
        if schedule is not None:
            want = (m_h, m_w, n_rows, n_cols, k_rows, k_cols)
            if schedule.shapes != want:
                raise ValueError(
                    f"schedule made for {schedule.shapes}, call is {want} "
                    "(m_h, m_w, n_rows, n_cols, k_rows, k_cols)")
            if schedule.row_starts.device != band_src.device:
                raise ValueError(f"schedule on {schedule.row_starts.device}, "
                                 f"band source on {band_src.device}")
        self.schedule = schedule
        self._taps = (ri0, rw, ci0, cw)
        self._canvas, self._r0, self._c0 = canvas, r0, c0
        self._shape, self._stride = band_src.shape, band_src.stride()
        self._dtype = band_src.dtype
        self._device = band_src.device
        self._index = band_src.get_device()      # -1 on the CPU
        # bytes the kernel may read past a source's first element: a call's
        # source must hold them past its own storage offset
        self._span = _storage_end(band_src) \
            - band_src.storage_offset() * _DTYPES[band_src.dtype]
        self.args: Optional[StagedArgs] = None
        if self._index < 0 or self._empty:
            return
        from . import _build

        self._lib = lib = _build.load()
        s, elt = schedule, _DTYPES[band_src.dtype]
        self.args = a = StagedArgs(
            ri0.data_ptr(), rw.data_ptr(), ci0.data_ptr(), cw.data_ptr(),
            s.row_starts.data_ptr(), s.col_starts.data_ptr(),
            canvas.data_ptr(), band_src.stride(0) * elt, canvas.shape[0],
            canvas.shape[1], r0, c0, elt, c, m_h, m_w, n_rows, k_rows,
            n_cols, k_cols, s.band_h, s.band_w, s.tile_r, s.tile_c, ctas)
        with torch.cuda.device(self._index):
            err = lib.resize_place_staged_prepare(ctypes.byref(a))
        if err != 0:
            raise _error(lib, "prepare", err)
        self._ref = ctypes.addressof(a)
        self._run = lib.resize_place_staged_run
        # the current stream's handle as an int, without a Stream object
        self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)

    def __call__(self, band_src: torch.Tensor) -> None:
        global staged_launches
        if band_src.shape != self._shape or band_src.dtype is not self._dtype \
                or band_src.device != self._device \
                or band_src.stride() != self._stride:
            raise ValueError(
                f"band source {tuple(band_src.shape)} {band_src.dtype} on "
                f"{band_src.device} strides {band_src.stride()}: prepared for "
                f"{tuple(self._shape)} {self._dtype} on {self._device} "
                f"strides {self._stride}")
        ptr = band_src.data_ptr()
        if ptr % 16 or band_src.untyped_storage().nbytes() \
                < band_src.storage_offset() * band_src.element_size() \
                + self._span:
            raise ValueError("band source must start on 16 bytes and hold "
                             "its last row's padded width (stage_source)")
        if self._empty:
            return
        if self._index < 0:
            r0, c0 = self._r0, self._c0
            n_rows, n_cols = self._taps[0].shape[0], self._taps[2].shape[0]
            self._canvas[r0:r0 + n_rows, c0:c0 + n_cols] = \
                resize_place_staged_ref(band_src, *self._taps)
            return
        # the launch goes to the current device: make it the tensors' for
        # the call where it is not
        if torch.cuda.current_device() == self._index:
            err = self._run(self._ref, ptr, self._stream(self._index))
        else:
            with torch.cuda.device(self._index):
                err = self._run(self._ref, ptr, self._stream(self._index))
        if err != 0:
            raise _error(self._lib, "kernel launch", err)
        staged_launches += 1


def resize_place_staged(band_src: torch.Tensor, ri0: torch.Tensor,
                        rw: torch.Tensor, ci0: torch.Tensor,
                        cw: torch.Tensor, canvas: torch.Tensor, r0: int,
                        c0: int, *, schedule: Optional[StagedSchedule] = None,
                        ctas: int = 0) -> None:
    """Resample the band source ``band_src`` (:func:`stage_source`) with the
    row taps ``(ri0, rw)`` and column taps ``(ci0, cw)`` and store the uint8
    result into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place: a
    :class:`StagedLaunch` made and called once."""
    StagedLaunch(band_src, ri0, rw, ci0, cw, canvas, r0, c0,
                 schedule=schedule, ctas=ctas)(band_src)


def moved_bytes(shape: Sequence[int], n_rows: int, n_cols: int,
                dtype: torch.dtype) -> int:
    """The bytes kernel #4 must move for one slot: the ``(H, W, C)`` source
    read once at the band dtype's width, the uint8 slot written once."""
    h, w, c = shape
    return h * w * c * _DTYPES[dtype] + n_rows * n_cols * c
