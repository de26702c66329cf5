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

A slot is the sequence of its jobs' own ``(H, W, C)`` uint8 arrays or
tensors (a ``(b, H, W, C)`` stack is one: indexing it gives the rows).
``BatchedStitch.__call__`` checks them once, before the batch is split into
shards; each job is copied straight into its row of the shard's stack on
the device, and rows past the jobs are zero-filled there.  The server hands
its jobs' arrays, so a flush builds no host stack.

A call is timed as spans (:mod:`..runtime.spans`): per shard ``batch.h2d``
(the upload of its stacks) and ``batch.draw`` (the enqueue of its canvas
and placements), then per device ``batch.sync`` (the wait for the kernels)
and per shard ``batch.readback`` (the copy into the host array).  Each
carries the count ``card``: the shard's index on the ``jobs`` axis (0
without a mesh); a device's ``batch.sync`` carries its first shard's.
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

    def _shard(self, card: int,
               slots: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
        device, (lo, hi) = self.shards[card]
        return cuda_resize.stitch_batch(self.plan, slots, device, hi - lo,
                                        self.channels,
                                        plain=self.engine == "torch",
                                        steps=self._steps[device], card=card)

    def run_shards(self, slots: Sequence[Sequence[torch.Tensor]]
                   ) -> List[torch.Tensor]:
        """Enqueue every jobs shard: the ``(b, canvas_h, canvas_w, C)``
        canvas tensor of each, on its own device, in shard order.  Each
        slot is its jobs' ``(H, W, C)`` tensors as :meth:`__call__` checks
        them; each shard takes the jobs in its rows, which may be fewer
        than its rows or none.  The caller synchronises."""
        return [self._shard(k, [s[lo:hi] for s in slots])
                for k, (_, (lo, hi)) in enumerate(self.shards)]

    def warm(self) -> None:
        """Run each shard once with no job, so that every row is a zero job
        filled on its device, then fetch one element of each: no
        host-to-device staging and no full-canvas readback."""
        outs = self.run_shards([[] for _ in self.plan.placements])
        for out in outs:
            out[:1, :1, :1, :1].cpu()

    def __call__(self, stacked_images: Sequence) -> np.ndarray:
        """stacked_images[i], image slot i: the sequence of its b <= B
        jobs' (H_i, W_i, C) uint8 arrays or tensors (a (b, H_i, W_i, C)
        stack is one), each copied straight into its row on the device
        (rows b to B are zero jobs); returns the (B, canvas_h, canvas_w, C)
        uint8 canvases.  Every check happens here, before the batch is
        split into shards (the JAX ``BatchedStitch.__call__``'s checks and
        messages)."""
        if len(stacked_images) != len(self.plan.placements):
            raise ValueError("image-slot count does not match plan")
        counts = sorted({len(s) for s in stacked_images})
        if len(counts) > 1 or counts[0] > self.batch_size:
            raise ValueError(f"slots hold {counts} jobs, expected one count "
                             f"of at most B={self.batch_size}")
        slots = []
        for seq, p in zip(stacked_images, self.plan.placements):
            jobs = [arr if isinstance(arr, torch.Tensor)
                    else torch.from_numpy(np.ascontiguousarray(arr))
                    for arr in seq]
            for i, arr in enumerate(jobs):
                where = f"slot {p.index}, job {i}"
                if arr.ndim != 3:
                    raise ValueError(f"{where}: expected (H, W, C), got "
                                     f"{tuple(arr.shape)}")
                if tuple(arr.shape[:2]) != (p.raw_h, p.raw_w):
                    raise ValueError(f"{where}: got {arr.shape[1]}x"
                                     f"{arr.shape[0]}, plan says "
                                     f"{p.raw_w}x{p.raw_h}")
                if arr.dtype != torch.uint8:
                    raise ValueError("batched stitch expects uint8")
                if arr.shape[2] != self.channels \
                        or self.channels not in (1, 3):
                    raise ValueError(f"{where}: {arr.shape[2]} channels, the "
                                     f"batch has {self.channels} (1 or 3, "
                                     f"equal)")
            slots.append(jobs)
        outs = self.run_shards(slots)
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
    """One-shot :class:`BatchedStitch` over ``stacked_images``, whose slot 0
    gives the batch size and the channels: ``(B, H, W, C)``."""
    first = stacked_images[0]
    return BatchedStitch(plan, len(first), first.shape[-1], engine, device,
                         mesh)(stacked_images)
