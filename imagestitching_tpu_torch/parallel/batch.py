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

A slot comes as its whole ``(B, H, W, C)`` stack, uploaded in one copy, or
as its jobs' own ``(H, W, C)`` arrays, each copied straight into its row of
the shard's stack on the device, with rows past the jobs zero-filled there:
the server hands its jobs' arrays, so a flush builds no host stack.

A call is timed as spans (:mod:`..runtime.spans`): per shard ``batch.h2d``
(the upload of its stacks) and ``batch.draw`` (the enqueue of its canvas
and placements), then per device ``batch.sync`` (the wait for the kernels)
and per shard ``batch.readback`` (the copy into the host array).  Each
carries the count ``card``: the shard's index on the ``jobs`` axis (0
without a mesh); a device's ``batch.sync`` carries its first shard's.  A
``batch.h2d`` also counts ``direct``: 1 where its rows were copied from
per-job arrays, 0 where whole stacks were uploaded.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.layout import LayoutPlan
from ..ops import cuda_resize
from ..runtime import spans
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
        # each distinct device, in shard order, with its first shard's index
        self._first_card: Dict[torch.device, int] = {}
        for k, (d, _) in enumerate(self.shards):
            self._first_card.setdefault(d, k)
        self._steps = {d: cuda_resize.plan_steps(plan, d)
                       for d in self._first_card}

    @property
    def cards(self) -> int:
        """The distinct devices among the shards: the jobs axis on distinct
        cards, 1 on a mesh that repeats one device."""
        return len(self._first_card)

    def _shard(self, card: int, stacks: Sequence) -> torch.Tensor:
        device, (lo, hi) = self.shards[card]
        return cuda_resize.stitch_batch(self.plan, stacks, device,
                                        plain=self.engine == "torch",
                                        steps=self._steps[device], card=card,
                                        rows=hi - lo, channels=self.channels)

    def run_shards(self, stacks: Sequence) -> List[torch.Tensor]:
        """Enqueue every jobs shard: the ``(b, canvas_h, canvas_w, C)``
        canvas tensor of each, on its own device, in shard order.  A slot
        given as per-job arrays gives each shard the jobs in its rows,
        which may be fewer than its rows or none.  The caller
        synchronises."""
        return [self._shard(k, [s[lo:hi] for s in stacks])
                for k, (_, (lo, hi)) in enumerate(self.shards)]

    def warm(self) -> None:
        """Run once on zero inputs made on each shard's device, then fetch
        one element of each: no host-to-device staging of B copies of every
        input and no full-canvas readback."""
        outs = [self._shard(k, [torch.zeros((hi - lo, p.raw_h, p.raw_w,
                                             self.channels),
                                            dtype=torch.uint8, device=d)
                                for p in self.plan.placements])
                for k, (d, (lo, hi)) in enumerate(self.shards)]
        for out in outs:
            out[:1, :1, :1, :1].cpu()

    def __call__(self, stacked_images: Sequence) -> np.ndarray:
        """stacked_images[i], image slot i: its (B, H_i, W_i, C) uint8
        stack, or the sequence of its b <= B jobs' (H_i, W_i, C) uint8
        arrays, each copied straight into its row on the device (rows b to
        B are zero jobs); returns the (B, canvas_h, canvas_w, C) uint8
        canvases."""
        if len(stacked_images) != len(self.plan.placements):
            raise ValueError("image-slot count does not match plan")
        for arr, p in zip(stacked_images, self.plan.placements):
            if not isinstance(arr, (np.ndarray, torch.Tensor)):
                if len(arr) > self.batch_size:
                    raise ValueError(f"slot {p.index}: {len(arr)} jobs for "
                                     f"B={self.batch_size}")
                continue
            shape = tuple(arr.shape)
            if len(shape) != 4 or shape[0] != self.batch_size:
                raise ValueError(
                    f"slot {p.index}: expected (B={self.batch_size}, H, W, C),"
                    f" got {shape}")
        outs = self.run_shards(stacked_images)
        for d, card in self._first_card.items():
            with spans.span("batch.sync") as s:
                s.counts = {"card": card}
                if d.type == "cuda":
                    # a kernel fault surfaces here, inside the caller's flush
                    torch.cuda.synchronize(d)
        host = np.empty((self.batch_size, *outs[0].shape[1:]), np.uint8)
        for card, ((_, (lo, hi)), out) in enumerate(zip(self.shards, outs)):
            with spans.span("batch.readback") as s:
                s.counts = {"card": card}
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
