"""Kernel #4: a placement resampled from a ring of staged source bands.

Port of the TPU kernel of ``benchmarks/profile_bf16_stage.py:29-100``
(``make_kernel``, ``build``): BASELINE config 5's slot 0 (a 1920x1080
source into a 1024x576 min-mode slot), each output tile computed from a
band of the source that a ring of three copies staged two tiles ahead,
with the band kept as uint8 or as bf16.  The kernel is
``csrc/resize_place_staged.cu``; :func:`resize_place_staged` is its wrapper
and :func:`resize_place_staged_ref` its plain version.

* The **band source** (:func:`stage_source`) is the oriented HWC source,
  uint8 or bf16 (a uint8 value is exact in bf16, so both give the same
  bits), a view of a buffer whose rows are padded to a multiple of
  :data:`ALIGN_C` pixels: every band row then starts and ends on 16 bytes,
  which the kernel's 16-byte copies need.
* The **schedule** (:func:`band_schedule`, the port's copy of the logic of
  ``pallas_resize._Schedule._band_size`` / ``_band_starts``,
  ``imagestitching_tpu/ops/pallas_resize.py:358-385``): one band size for
  every tile, sized from the actual taps, and a band start per tile row and
  per tile column, aligned down to 1 row and :data:`ALIGN_C` columns (the
  TPU's (8, 128) is left behind).  :func:`staged_schedule` picks the tile so
  that three bf16 bands and the output tile fit a CTA's shared memory, and
  holds the starts on the device.
* For tensors on the CPU the wrapper runs the plain version; for CUDA
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

#: Kernel launches by :func:`resize_place_staged` in this process.
staged_launches = 0

#: Band column alignment in pixels: 16 pixels of 1 or 3 channels of 1 or 2
#: bytes are a whole number of 16-byte copies.
ALIGN_C = 16
#: Bands in a CTA's ring: the one it computes and the two ahead.
SLOTS = 3
#: Dynamic shared memory a CTA may take on Hopper (227 KB).
SMEM_CAP = 227 * 1024
#: Output tiles (rows, cols) the picker tries, largest first.
TILES = ((32, 64), (32, 32), (16, 64), (16, 32), (8, 64), (8, 32), (4, 32),
         (4, 16), (2, 16), (1, 16))

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
                  tile_r: int, tile_c: int, align_c: int = ALIGN_C) -> Bands:
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


def smem_bytes(tile_r: int, tile_c: int, band_h: int, band_w: int,
               channels: int, elt: int) -> int:
    """Dynamic shared memory of one CTA, as the kernel lays it out: the ring
    of ``SLOTS`` bands of ``elt``-byte values, then the uint8 output tile
    with rows padded to 4 bytes."""
    return (SLOTS * band_h * band_w * channels * elt
            + tile_r * _round_up(tile_c * channels, 4))


def staged_schedule(ri0: torch.Tensor, ci0: torch.Tensor, k_rows: int,
                    k_cols: int, m_h: int, m_w: int,
                    channels: int) -> StagedSchedule:
    """The schedule of kernel #4 for a placement's taps, on the taps'
    device.  The tile is the first of :data:`TILES` whose three bf16 bands
    and output tile fit :data:`SMEM_CAP`, so that both band dtypes share
    one schedule.  Raises ``ValueError`` when none fits (a wide filter at a
    deep downscale)."""
    ri0_h = ri0.cpu().numpy()
    ci0_h = ci0.cpu().numpy()
    n_rows, n_cols = len(ri0_h), len(ci0_h)
    for tr, tc in TILES:
        tr, tc = min(tr, n_rows), min(tc, n_cols)
        b = band_schedule(ri0_h, ci0_h, k_rows, k_cols, m_h, m_w, tr, tc)
        if smem_bytes(tr, tc, b.band_h, b.band_w, channels, 2) <= SMEM_CAP:
            return StagedSchedule(
                tr, tc, b.band_h, b.band_w,
                torch.from_numpy(b.row_starts).to(ri0.device),
                torch.from_numpy(b.col_starts).to(ri0.device),
                (m_h, m_w, n_rows, n_cols, k_rows, k_cols))
    raise ValueError(
        f"no output tile of {list(TILES)} fits {SLOTS} bf16 bands in "
        f"{SMEM_CAP} bytes of shared memory (K = {k_rows} x {k_cols}, "
        f"source {m_h}x{m_w})")


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
    end = band_src.storage_offset() + (h - 1) * pitch \
        + _round_up(w, ALIGN_C) * c
    if band_src.stride(2) != 1 or band_src.stride(1) != c:
        raise ValueError("band source rows must be dense (stride (., C, 1)): "
                         "make it with stage_source")
    if (pitch * elt) % 16 or pitch < _round_up(w, ALIGN_C) * c \
            or band_src.data_ptr() % 16 \
            or band_src.untyped_storage().nbytes() < end * elt:
        raise ValueError(
            f"band source pitch {pitch * elt} bytes: rows must start on 16 "
            f"bytes and hold {_round_up(w, ALIGN_C)} pixels (stage_source)")
    _check_taps(ri0, rw, ci0, cw, band_src.device)
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    canvas_h, canvas_w = canvas.shape[:2]
    if r0 < 0 or c0 < 0 or r0 + n_rows > canvas_h or c0 + n_cols > canvas_w:
        raise ValueError(f"region {n_rows}x{n_cols} at ({r0}, {c0}) leaves "
                         f"the {canvas_h}x{canvas_w} canvas")


def resize_place_staged(band_src: torch.Tensor, ri0: torch.Tensor,
                        rw: torch.Tensor, ci0: torch.Tensor,
                        cw: torch.Tensor, canvas: torch.Tensor, r0: int,
                        c0: int, *, schedule: Optional[StagedSchedule] = None,
                        ctas: int = 0) -> None:
    """Resample the band source ``band_src`` (:func:`stage_source`) with the
    row taps ``(ri0, rw)`` and column taps ``(ci0, cw)`` and store the uint8
    result into ``canvas[r0:r0+n_rows, c0:c0+n_cols]`` in place.

    ``schedule`` (:func:`staged_schedule` of these taps) is made here when
    not given.  ``ctas`` is the kernel's grid (each CTA walks tiles
    ``blockIdx.x + k * ctas`` in order); 0 takes ``min(tiles, 2 x SMs)``."""
    global staged_launches
    _check(band_src, ri0, rw, ci0, cw, canvas, r0, c0)
    m_h, m_w, c = band_src.shape
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    if n_rows == 0 or n_cols == 0:
        return
    k_rows, k_cols = rw.shape[1], cw.shape[1]
    if schedule is None:
        schedule = staged_schedule(ri0, ci0, k_rows, k_cols, m_h, m_w, c)
    want = (m_h, m_w, n_rows, n_cols, k_rows, k_cols)
    if schedule.shapes != want:
        raise ValueError(f"schedule made for {schedule.shapes}, call is "
                         f"{want} (m_h, m_w, n_rows, n_cols, k_rows, k_cols)")
    if schedule.row_starts.device != band_src.device:
        raise ValueError(f"schedule on {schedule.row_starts.device}, band "
                         f"source on {band_src.device}")
    if ctas < 0:
        raise ValueError(f"ctas {ctas} (0 for the default)")
    if band_src.device.type == "cpu":
        canvas[r0:r0 + n_rows, c0:c0 + n_cols] = resize_place_staged_ref(
            band_src, ri0, rw, ci0, cw)
        return
    from . import _build

    lib = _build.load()
    ptr = ctypes.c_void_p
    elt = _DTYPES[band_src.dtype]
    s = schedule

    def start():
        return lib.resize_place_staged_launch(
            ptr(band_src.data_ptr()), elt, band_src.stride(0) * elt, m_h,
            m_w, c, ptr(ri0.data_ptr()), ptr(rw.data_ptr()), n_rows, k_rows,
            ptr(ci0.data_ptr()), ptr(cw.data_ptr()), n_cols, k_cols,
            ptr(s.row_starts.data_ptr()), ptr(s.col_starts.data_ptr()),
            s.band_h, s.band_w, s.tile_r, s.tile_c, ptr(canvas.data_ptr()),
            canvas.shape[0], canvas.shape[1], r0, c0, ctas,
            ptr(torch.cuda.current_stream().cuda_stream))

    # the launch goes to the current device: make it the tensors' for the
    # call where it is not
    if torch.cuda.current_device() == band_src.device.index:
        err = start()
    else:
        with torch.cuda.device(band_src.device):
            err = start()
    if err != 0:
        raise RuntimeError("resize_place_staged kernel launch failed: "
                           + lib.resize_place_error_string(err).decode())
    staged_launches += 1


def moved_bytes(shape: Sequence[int], n_rows: int, n_cols: int,
                dtype: torch.dtype) -> int:
    """The bytes kernel #4 must move for one slot: the ``(H, W, C)`` source
    read once at the band dtype's width, the uint8 slot written once."""
    h, w, c = shape
    return h * w * c * _DTYPES[dtype] + n_rows * n_cols * c
