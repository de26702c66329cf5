"""Sharded single-job stitching: one job's canvas in row bands across a mesh.

Port of ``imagestitching_tpu/parallel/sharding.py`` (``ShardedStitch``,
:247-351).  The canvas is split into ``cdiv(canvas_h, n)``-row bands over
the mesh's ``space`` axis; shard k composes canvas rows ``[k*band,
min((k+1)*band, canvas_h))`` on its device.  Every output pixel depends only
on its own taps, so the bands are independent: the compose has no
collective, and the gather is host copies of disjoint bands.

Each band starts as the background.  An identity placement is a slice copy
of its oriented source (``geometry.placement_copy_offsets``).  Every other
placement that meets the band is resampled by kernel #3
(``cuda_resize.WindowLauncher``), the twin of ``_compose_band_pallas``
(:182-219): its window is the intersection of the placement's span with
the band (``ops.window.WindowPlan(windows=)``), its crop a row slice of the
oriented source.  ``crop_rows`` is sized over those real intersections and
the crop start is pinned to the image bottom, so no tap inside the image is
clamped and a band equals the same rows of the resident canvas bit for bit.
The kernel has no VMEM cap, so one window per (band, placement) pair does:
JAX's chunk shrink (:113-126) has no twin.  ``engine="torch"`` is the plain
version of the same compose (the twin of ``engine="xla"``,
``_compose_band_sub`` :222-244): every drawn placement resampled with the
band's rows of its taps, no copy shortcut.

Sources are uploaded once per *distinct* device of the axis (a mesh may
repeat a device) and oriented there into contiguous tensors, so a crop is a
view and costs no copy.  All shards are enqueued before any band is read
back; the bands are then gathered into one numpy canvas, and numpy is
returned, as JAX does (:351).

Dropped with the TPU: ``shard_map`` and ``check_vma``, the planar
lane-padded staging (``_stage_full_chw``), the VMEM chunk shrink and
``Infeasible``, ``ensure_compile_cache``, and the replicated jit arguments.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import geometry
from ..core.layout import LayoutPlan, Placement
from ..ops import cuda_resize, torch_compose
from ..ops.assemble import new_canvas, source_tensor
from ..ops.window import WindowPlan
from .mesh import DeviceMesh, replicated, row_sharding

ENGINES = ("auto", "cuda", "torch")


def _window(p: Placement, lo: int, hi: int) -> Tuple[int, int]:
    """The span-relative rows of ``p`` inside canvas rows ``[lo, hi)``;
    ``(0, 0)`` when they do not meet."""
    r0, r1 = p.row_span
    a0, a1 = max(r0, lo) - r0, min(r1, hi) - r0
    return (a0, a1) if a1 > a0 else (0, 0)


class ShardedStitch:
    """One job's canvas row-banded across the mesh's ``axis``.

    ``engine``: ``"auto"`` -- identity placements as slice copies, every
    other placement through kernel #3 on a CUDA device and its plain
    version on the CPU; ``"cuda"`` -- the same, CUDA devices only;
    ``"torch"`` -- the plain version of the whole compose.  After a call,
    ``split`` holds its host wall in ``upload_s``, ``compose_s`` (through
    the devices' synchronise) and ``gather_s``, and ``h2d_bytes`` the bytes
    it uploaded."""

    def __init__(self, plan: LayoutPlan, mesh: DeviceMesh, channels: int = 3,
                 axis: str = "space", engine: str = "auto"):
        if engine not in ENGINES:
            raise ValueError(f"unsupported sharded engine {engine!r}")
        if not isinstance(mesh, DeviceMesh):
            raise ValueError("mesh must be a parallel.mesh.DeviceMesh")
        self.plan = plan
        self.channels = channels
        self.engine = engine
        self.shards = row_sharding(mesh, plan.canvas_h, axis)
        self.devices = replicated(mesh, axis)
        if engine == "cuda" and any(d.type != "cuda" for d in self.devices):
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs CUDA devices")
        # per drawn placement: (placement, copy offsets or None, windows)
        self._work: List[Tuple[Placement, Optional[Tuple[int, int]],
                               WindowPlan]] = []
        for p in plan.placements:
            if p.row_span[1] <= p.row_span[0] \
                    or p.col_span[1] <= p.col_span[0]:
                continue
            copy = (None if engine == "torch"
                    else geometry.placement_copy_offsets(p, plan.filter))
            wp = WindowPlan(p, plan.filter, windows=[
                _window(p, lo, hi) for _, (lo, hi) in self.shards])
            self._work.append((p, copy, wp))
        self.split: Dict[str, float] = {}
        self.h2d_bytes = 0

    def _upload(self, images: Sequence[np.ndarray]
                ) -> Dict[torch.device, Dict[int, torch.Tensor]]:
        """Each drawn placement's source on every distinct device: oriented
        and contiguous for a kernel placement, raw otherwise."""
        self.h2d_bytes = 0
        srcs: Dict[torch.device, Dict[int, torch.Tensor]] = {}
        for dev in self.devices:
            srcs[dev] = {}
            for p, copy, _ in self._work:
                src = source_tensor(images[p.index], p, self.channels, dev)
                self.h2d_bytes += src.nbytes
                if copy is None and self.engine != "torch":
                    src = torch_compose.orient(src, p.orientation).contiguous()
                srcs[dev][p.index] = src
        return srcs

    def _compose(self, srcs, bands: List[torch.Tensor]) -> None:
        steps = {dev: cuda_resize.plan_steps(self.plan, dev)
                 for dev in self.devices}
        for p, copy, wp in self._work:
            r0 = p.row_span[0]
            c0, c1 = p.col_span
            launchers: Dict[torch.device, tuple] = {}
            for (dev, (lo, _)), band, g in zip(self.shards, bands,
                                               range(wp.n_chunks)):
                a, valid, s_lo = wp.chunk_window(g)
                if valid == 0:
                    continue
                rows = slice(r0 + a - lo, r0 + a - lo + valid)
                src = srcs[dev][p.index]
                if copy is not None:
                    sr, sc = copy
                    band[rows, c0:c1] = torch_compose.orient(
                        src, p.orientation)[sr + a:sr + a + valid,
                                            sc:sc + c1 - c0]
                    continue
                ri0, rw, ci0, cw = steps[dev][p.index].taps
                if self.engine == "torch":
                    band[rows, c0:c1] = cuda_resize.resize_place_ref(
                        src, p.orientation, ri0[a:a + valid],
                        rw[a:a + valid], ci0, cw)
                    continue
                if dev not in launchers:
                    # one region per device: the shards of a repeated
                    # device run in stream order, so each copy out of the
                    # region lands before the next launch writes it
                    region = torch.empty((wp.chunk, wp.n_cols,
                                          self.channels),
                                         dtype=torch.uint8, device=dev)
                    launchers[dev] = (cuda_resize.WindowLauncher(
                        ri0, rw, ci0, cw, region,
                        (wp.crop_rows, wp.disp_w, self.channels)), region)
                launch, region = launchers[dev]
                launch(src[s_lo:s_lo + wp.crop_rows], a, s_lo, valid)
                band[rows, c0:c1] = region[:valid]

    def __call__(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """The uint8 HWC canvas of ``images`` (one raw HWC or HW uint8 array
        per placement), as a numpy array."""
        plan = self.plan
        if len(images) != len(plan.placements):
            raise ValueError("image count does not match plan")
        t0 = time.perf_counter()
        srcs = self._upload(images)
        t1 = time.perf_counter()
        bands = [new_canvas(plan, self.channels, dev, rows=hi - lo)
                 for dev, (lo, hi) in self.shards]
        self._compose(srcs, bands)
        del srcs
        for dev in self.devices:
            if dev.type == "cuda":
                # a kernel fault surfaces here, before any readback
                torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        out = np.empty((plan.canvas_h, plan.canvas_w, self.channels),
                       np.uint8)
        host = torch.from_numpy(out)
        for (_, (lo, hi)), band in zip(self.shards, bands):
            host[lo:hi].copy_(band)
        self.split = {"upload_s": t1 - t0, "compose_s": t2 - t1,
                      "gather_s": time.perf_counter() - t2}
        return out
