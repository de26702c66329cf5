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
port computes each jobs shard once.  A call is one unit of work per
distinct device among the shards: it enqueues that device's shards, waits
for the device, then reads each shard back into its own rows of the call's
one host array.  Where the shards lie on one device (no mesh, or a mesh
that repeats one device) the unit runs on the calling thread.  Where they
span several cards, each card's unit runs at once with the others on that
card's worker thread (one long-lived thread per card, shared by every
``BatchedStitch`` of the process), and the call returns when every card is
done.

Where every shard lies on a CUDA device, the call's host array is a block
of torch's caching pinned-host allocator (as ``runtime.pipeline._read_back``
takes one for a job's canvas): each shard's readback is a copy into
resident, locked pages, and the block (rounded up to a power of two) goes
back to torch's cache, not to the OS, once every canvas of the call is
dropped, so the next call of that size class reuses it.  A caller that
keeps one canvas keeps the whole call's block pinned (up to 2 GiB for 64
1080p jobs), and pinned memory is not swappable.  On the CPU the host array
is a fresh ``np.empty``.

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

A call is timed as spans (:mod:`..runtime.spans`), on the thread that runs
each unit and as children of the caller's innermost span: per shard
``batch.h2d`` (the upload of its stacks) and ``batch.draw`` (the enqueue of
its canvas and placements), then per device ``batch.sync`` (the wait for
the kernels) and per shard ``batch.readback`` (the copy into the host
array).  Each carries the count ``card``: the shard's index on the ``jobs``
axis (0 without a mesh); a device's ``batch.sync`` carries its first
shard's.  Before them, on the calling thread, ``batch.host`` takes the host
array and counts ``pinned_new``: the blocks by which torch's pinned-host
pool grew to hold it (its ``num_host_alloc``, counted over the whole
process; 0 on the CPU).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor, wait
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.layout import LayoutPlan
from ..ops import cuda_resize
from ..runtime import spans
from ..runtime.pipeline import resolve_device
from .mesh import DeviceMesh, job_sharding

ENGINES = ("auto", "cuda", "torch")

#: Each card's worker: one thread, made on the card's first call that spans
#: several cards and kept for the process, whichever ``BatchedStitch`` calls.
_workers: Dict[torch.device, ThreadPoolExecutor] = {}
_workers_lock = threading.Lock()


def _worker(device: torch.device) -> ThreadPoolExecutor:
    """``device``'s worker thread, named after the card."""
    with _workers_lock:
        pool = _workers.get(device)
        if pool is None:
            pool = _workers[device] = ThreadPoolExecutor(
                1, thread_name_prefix=f"batch.card {device}")
        return pool


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
        # each distinct device, in shard order, with its shards' indices
        self._cards_of: Dict[torch.device, List[int]] = {}
        for k, (d, _) in enumerate(self.shards):
            self._cards_of.setdefault(d, []).append(k)
        self._steps = {d: cuda_resize.plan_steps(plan, d)
                       for d in self._cards_of}
        self._pinned = all(d.type == "cuda" for d in self._cards_of)

    @property
    def cards(self) -> int:
        """The distinct devices among the shards: the jobs axis on distinct
        cards, 1 on a mesh that repeats one device."""
        return len(self._cards_of)

    def _shard(self, card: int,
               slots: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
        device, (lo, hi) = self.shards[card]
        return cuda_resize.stitch_batch(self.plan, slots, device, hi - lo,
                                        self.channels,
                                        plain=self.engine == "torch",
                                        steps=self._steps[device], card=card)

    def run_shards(self, slots: Sequence[Sequence[torch.Tensor]],
                   device: Optional[torch.device] = None
                   ) -> List[torch.Tensor]:
        """Enqueue the jobs shards on ``device`` (every shard without it),
        on the calling thread: the ``(b, canvas_h, canvas_w, C)`` canvas
        tensor of each, on its own device, in shard order.  Each slot is
        its jobs' ``(H, W, C)`` tensors as :meth:`__call__` checks them;
        each shard takes the jobs in its rows, which may be fewer than its
        rows or none.  The caller synchronises."""
        cards = range(len(self.shards)) if device is None \
            else self._cards_of[device]
        outs = []
        for k in cards:
            lo, hi = self.shards[k][1]
            outs.append(self._shard(k, [s[lo:hi] for s in slots]))
        return outs

    def _serve_card(self, device: torch.device,
                    slots: Sequence[Sequence[torch.Tensor]],
                    host: Optional[np.ndarray], ctx: spans.Context) -> None:
        """One device's unit of a call, its spans children of ``ctx``:
        enqueue its shards, wait for the device (``batch.sync``), then read
        each shard back into its rows of ``host`` (``batch.readback``).
        Without ``host`` (a warm-up) one element of each shard is fetched
        instead."""
        cards = self._cards_of[device]
        on_card = torch.cuda.device(device) if device.type == "cuda" \
            else contextlib.nullcontext()
        with spans.within(ctx), on_card:
            outs = self.run_shards(slots, device)
            if host is None:
                for out in outs:
                    out[:1, :1, :1, :1].cpu()
                return
            with spans.span("batch.sync") as s:
                s.counts = {"card": cards[0]}
                if device.type == "cuda":
                    # a kernel fault surfaces here, inside the caller's call
                    torch.cuda.synchronize(device)
            for card, out in zip(cards, outs):
                lo, hi = self.shards[card][1]
                with spans.span("batch.readback") as s:
                    s.counts = {"card": card}
                    torch.from_numpy(host[lo:hi]).copy_(out)

    def _serve(self, slots: Sequence[Sequence[torch.Tensor]],
               host: Optional[np.ndarray]) -> None:
        """Every device's unit: on the calling thread where the shards lie
        on one device, else each on its card's worker, all at once.  Every
        unit has stopped before this returns or raises; the first card's
        error is raised here."""
        ctx = spans.current()
        if self.cards == 1:
            self._serve_card(self.device, slots, host, ctx)
            return
        futs = []
        try:
            for d in self._cards_of:
                futs.append(_worker(d).submit(self._serve_card, d, slots,
                                              host, ctx))
        finally:
            wait(futs)
        for f in futs:
            f.result()

    def warm(self) -> None:
        """Run each shard once with no job, so that every row is a zero job
        filled on its device, then fetch one element of each: no
        host-to-device staging and no full-canvas readback.  It takes the
        path of a call, so a mesh of several cards starts their workers."""
        self._serve([[] for _ in self.plan.placements], None)

    def __call__(self, stacked_images: Sequence) -> np.ndarray:
        """stacked_images[i], image slot i: the sequence of its b <= B
        jobs' (H_i, W_i, C) uint8 arrays or tensors (a (b, H_i, W_i, C)
        stack is one), each copied straight into its row on the device
        (rows b to B are zero jobs); returns the (B, canvas_h, canvas_w, C)
        uint8 canvases.  Every check happens here, before the batch is
        split into shards (the JAX ``BatchedStitch.__call__``'s checks and
        messages).  The host array is made here (``batch.host``): on CUDA
        shards the numpy view of a block from torch's caching pinned-host
        allocator, which every returned canvas keeps pinned until the last
        of them is dropped; on the CPU a fresh array.  Each device's unit
        fills its shards' rows, the cards of a mesh at once on their
        workers, and every unit has stopped before this returns or
        raises."""
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
        shape = (self.batch_size, self.plan.canvas_h, self.plan.canvas_w,
                 self.channels)
        with spans.span("batch.host") as s:
            if self._pinned:
                allocs = torch.cuda.host_memory_stats()["num_host_alloc"]
                host = torch.empty(shape, dtype=torch.uint8,
                                   pin_memory=True).numpy()
                s.counts = {"pinned_new": torch.cuda.host_memory_stats()[
                    "num_host_alloc"] - allocs}
            else:
                host = np.empty(shape, np.uint8)
                s.counts = {"pinned_new": 0}
        self._serve(slots, host)
        return host


def stitch_batch(plan: LayoutPlan, stacked_images: Sequence[np.ndarray],
                 engine: str = "auto", device="cuda",
                 mesh: Optional[DeviceMesh] = None) -> np.ndarray:
    """One-shot :class:`BatchedStitch` over ``stacked_images``, whose slot 0
    gives the batch size and the channels: ``(B, H, W, C)``."""
    first = stacked_images[0]
    return BatchedStitch(plan, len(first), first.shape[-1], engine, device,
                         mesh)(stacked_images)
