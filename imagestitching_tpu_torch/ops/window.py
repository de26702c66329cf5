"""The chunked row-window schedule of one placement: the operands of kernel #3.

Port of ``imagestitching_tpu/ops/pallas_resize.py:727-875`` (``_WindowPlan``).
The banded strategy resamples a placement's dest rows in chunks of
``chunk_rows``, each from a host-cropped window of the oriented source with
row taps rebased to the window, so the device holds one crop and one chunk
region at a time, never the canvas.

What is kept: the r0-aligned windows (:772-777), the data-driven crop height
(:790-796), the crop start pinned to the image bottom (:840-849) and the
rebased taps (:851-856).  What is left behind, as answers to the TPU: the
K-cap ``Infeasible``, the (8, 128) padding, the column-tile search and the
VMEM chunk shrink (:800-822), the ``_SchedStatic`` key and its ``ints``; and
the explicit ``windows=`` of the space-sharded compose, which has no caller
in the port yet.

Why a chunk equals the same rows of the whole-image resample bit for bit:
the kernel clamps a tap to ``[0, crop_rows - 1]`` where the whole-image
resample clamps it to ``[0, disp_h - 1]``.  ``crop_rows`` covers every tap a
chunk reads, so no tap inside the image is clamped, and a crop that would
run past the image is moved up to end on its last row, where both clamps
agree.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from imagestitching_tpu.core import geometry
from imagestitching_tpu.core.layout import Placement

from . import torch_compose


class WindowPlan:
    """Chunks of ``chunk_rows`` dest rows of placement ``p`` (the last may be
    shorter), each with its source row window and rebased row taps.  Column
    taps are the placement's and the same for every chunk."""

    def __init__(self, p: Placement, filter_kind: str, chunk_rows: int):
        if chunk_rows < 1:
            raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
        self.disp_w, self.disp_h = geometry.display_size(
            p.raw_w, p.raw_h, p.orientation)
        self.n_rows = p.row_span[1] - p.row_span[0]
        self.n_cols = p.col_span[1] - p.col_span[0]
        if self.n_rows <= 0 or self.n_cols <= 0:
            raise ValueError("empty dest rect")
        taps = torch_compose.placement_taps(p, filter_kind)
        self.ri0, self.rw = taps["rows"]["i0"], taps["rows"]["w"]
        self.ci0, self.cw = taps["cols"]["i0"], taps["cols"]["w"]
        k_rows = self.rw.shape[1]
        self.chunk = min(chunk_rows, self.n_rows)
        self.windows: List[Tuple[int, int]] = [
            (a, min(self.n_rows, a + self.chunk))
            for a in range(0, self.n_rows, self.chunk)]
        # the widest source window any chunk reads
        need = k_rows
        for g0, g1 in self.windows:
            need = max(need, int(self.ri0[g1 - 1]) + k_rows
                       - int(self.ri0[g0]))
        self.crop_rows = min(self.disp_h, need)

    @property
    def n_chunks(self) -> int:
        return len(self.windows)

    def chunk_window(self, g: int) -> Tuple[int, int, int]:
        """``(dest row offset in the span, valid rows, crop start)`` of
        chunk ``g``."""
        a, b = self.windows[g]
        s_lo = max(0, min(int(self.ri0[a]), self.disp_h - self.crop_rows))
        return a, b - a, s_lo

    def chunk_taps(self, g: int) -> Tuple[np.ndarray, np.ndarray]:
        """Chunk ``g``'s row taps rebased to its crop: ``(ri0 (valid,)
        int32, rw (valid, K) float32)``."""
        a, valid, s_lo = self.chunk_window(g)
        return ((self.ri0[a:a + valid] - s_lo).astype(np.int32),
                np.ascontiguousarray(self.rw[a:a + valid]))

    def stage_crop(self, oriented_hwc: np.ndarray, g: int) -> np.ndarray:
        """Chunk ``g``'s source rows of the oriented HWC source, as a
        contiguous ``(crop_rows, disp_w, C)`` uint8 array (``orient_array``
        returns views with negative strides, which ``torch.from_numpy``
        refuses)."""
        _, _, s_lo = self.chunk_window(g)
        return np.ascontiguousarray(oriented_hwc[s_lo:s_lo + self.crop_rows])
