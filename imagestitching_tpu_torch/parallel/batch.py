"""Batched multi-job stitching (BASELINE config 5: 64 concurrent 9-image jobs).

Port of ``imagestitching_tpu/parallel/batch.py``.  Jobs sharing a layout
signature stack into ``(B, H_i, W_i, C)`` tensors per image slot and run
through one placement loop (``ops.cuda_resize.stitch_batch``):

* ``engine="auto"`` -- the batched CUDA kernel on a CUDA device (one launch
  per resampled placement for the whole batch, taps shared by the batch), its
  plain PyTorch version on the CPU; the twin of ``_batched_pallas``;
* ``engine="cuda"`` -- the same, on a CUDA device only;
* ``engine="torch"`` -- the plain whole-job engine on either device, every
  drawn placement resampled; the twin of ``_batched_xla``.

With a ``parallel.mesh.DeviceMesh`` (the twin of the shard_map branch,
:135-160), the batch is split over the ``jobs`` axis: jobs row j takes jobs
``[j*b, (j+1)*b)`` (``b = batch / jobs``) and runs them on its first device,
one launch of kernel #2 per resampled placement.  Jobs are independent, so
there is no collective.  A 2D mesh replicates over ``space`` in JAX; the
port computes each jobs shard once.  Every shard is enqueued before any is
read back into one host array.

PyTorch runs eagerly, so there is nothing to compile per batch size: the
JAX class's ``jax.jit``, ``ensure_compile_cache`` and
``check_plan_feasible`` (the gather kernel has no ``Infeasible``) have no
twin.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.layout import LayoutPlan
from ..ops import cuda_resize
from ..runtime.pipeline import resolve_device
from .mesh import DeviceMesh, job_sharding

ENGINES = ("auto", "cuda", "torch")


class BatchedStitch:
    """Batched stitch for one layout signature x batch size.

    Jobs with mismatched shapes must be bucketed by ``plan.signature()``
    upstream (see serve.server).  The object holds the plan's device taps,
    so a cache of these objects holds their taps too.  ``device`` is where
    the batch runs without a mesh; with ``mesh``, each jobs row's first
    device runs its share (``batch_size`` must divide by the jobs axis).
    """

    def __init__(self, plan: LayoutPlan, batch_size: int, channels: int = 3,
                 engine: str = "auto", device="cuda",
                 mesh: Optional[DeviceMesh] = None):
        if engine not in ENGINES:
            raise ValueError(f"unsupported batch engine {engine!r}")
        if mesh is None:
            self.shards = [(resolve_device(device), (0, batch_size))]
        elif isinstance(mesh, DeviceMesh):
            self.shards = job_sharding(mesh, batch_size)
        else:
            raise ValueError("mesh must be a parallel.mesh.DeviceMesh")
        self.device = self.shards[0][0]
        if engine == "cuda" and any(d.type != "cuda" for d, _ in self.shards):
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs a CUDA device")
        self.plan = plan
        self.batch_size = batch_size
        self.channels = channels
        self.engine = engine
        self._steps = {d: cuda_resize.plan_steps(plan, d)
                       for d, _ in self.shards}

    def _shard(self, device: torch.device, stacks: Sequence) -> torch.Tensor:
        return cuda_resize.stitch_batch(self.plan, stacks, device,
                                        plain=self.engine == "torch",
                                        steps=self._steps[device])

    def run_shards(self, stacks: Sequence) -> List[torch.Tensor]:
        """Enqueue every jobs shard: the ``(b, canvas_h, canvas_w, C)``
        canvas tensor of each, on its own device, in shard order.  The
        caller synchronises."""
        return [self._shard(d, [s[lo:hi] for s in stacks])
                for d, (lo, hi) in self.shards]

    def warm(self) -> None:
        """Run once on zero inputs made on each shard's device, then fetch
        one element of each: no host-to-device staging of B copies of every
        input and no full-canvas readback."""
        outs = [self._shard(d, [torch.zeros((hi - lo, p.raw_h, p.raw_w,
                                             self.channels),
                                            dtype=torch.uint8, device=d)
                                for p in self.plan.placements])
                for d, (lo, hi) in self.shards]
        for out in outs:
            out[:1, :1, :1, :1].cpu()

    def __call__(self, stacked_images: Sequence[np.ndarray]) -> np.ndarray:
        """stacked_images[i]: (B, H_i, W_i, C) uint8 for image slot i;
        returns the (B, canvas_h, canvas_w, C) uint8 canvases."""
        if len(stacked_images) != len(self.plan.placements):
            raise ValueError("image-slot count does not match plan")
        for arr, p in zip(stacked_images, self.plan.placements):
            shape = tuple(arr.shape)
            if len(shape) != 4 or shape[0] != self.batch_size:
                raise ValueError(
                    f"slot {p.index}: expected (B={self.batch_size}, H, W, C),"
                    f" got {shape}")
        outs = self.run_shards(stacked_images)
        for d in {d for d, _ in self.shards if d.type == "cuda"}:
            # a kernel fault surfaces here, inside the caller's flush
            torch.cuda.synchronize(d)
        host = np.empty((self.batch_size, *outs[0].shape[1:]), np.uint8)
        for (_, (lo, hi)), out in zip(self.shards, outs):
            torch.from_numpy(host[lo:hi]).copy_(out)
        return host


def stitch_batch(plan: LayoutPlan, stacked_images: Sequence[np.ndarray],
                 engine: str = "auto", device="cuda",
                 mesh: Optional[DeviceMesh] = None) -> np.ndarray:
    """One-shot :class:`BatchedStitch` over ``stacked_images``."""
    shape = tuple(stacked_images[0].shape)
    if len(shape) != 4:
        raise ValueError(f"slot 0: expected (B, H, W, C), got {shape}")
    return BatchedStitch(plan, shape[0], shape[3], engine, device,
                         mesh)(stacked_images)
