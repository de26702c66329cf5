"""Batch stitch server: queue, signature bucketing, one batched run per flush
(BASELINE config 5: 64 concurrent 9-image jobs).

Port of ``imagestitching_tpu/serve/server.py``:

* jobs are grouped by ``(plan.signature(), channels)``: one bucket per
  geometry and channel count;
* a bucket flushes when it reaches ``max_batch`` or when ``max_wait_s``
  elapses with work pending (dynamic batching);
* each flush runs one :class:`..parallel.batch.BatchedStitch`: one kernel
  launch per resampled placement for the whole batch;
* per-job failure isolation: a failed batch splits and retries, so a bad job
  fails its own future, never its batch-mates.

What the JAX server did for XLA and the TPU has no twin here.  There is no
compile per batch size, so a flush runs exactly the jobs it has (the JAX
server padded to a power of two to bound recompiles).  There is no
``Infeasible``, so ``engine="auto"`` is never demoted per signature: every
placement, however deep its downscale, runs on the kernel.  A
``merge_overlap`` job is trimmed in the caller's thread, its overlaps scored
on the server's device, before it is keyed.

With ``use_mesh=True`` the batches run data-parallel over a mesh's ``jobs``
axis (``BatchedStitch(mesh=)``): the mesh is ``config.mesh`` when the caller
set one, else ``parallel.mesh.make_mesh()`` over every card.  The memory
cap multiplies by the jobs axis and rounds down to a multiple of it, and a
flush pads with zero jobs up to the next multiple and drops their canvases
(twins of ``_effective_cap``, ``_padded_batch`` and ``_batch_cap``).  On a
mesh of distinct cards a flush serves them at once: each card uploads,
draws, waits for and reads back its shard on its own worker thread, and the
flush goes on (to its jobs' results, or to the split-retry of a failed
batch) only once every card has stopped.  On one card, or a mesh that
repeats one device, the flush runs on the server's thread.

A flush builds no host stack: it hands ``BatchedStitch`` each slot's jobs'
own arrays, which the upload copies straight into their rows of the
device stack; the padded rows are zero-filled on the device.

Spans (:mod:`..runtime.spans`): each job is a root ``serve.submit`` on the
client's thread with a job id of its own, then a ``serve.queue`` (from its
enqueue to its flush's start) and a ``serve.resolve`` under its flush; each
flush is a ``serve.flush`` holding ``serve.stack`` (gathering each slot's
arrays from the jobs) and ``BatchedStitch``'s ``batch.*`` spans (its
direct children, on whichever thread each card ran).  A flush that ran
counts ``jobs`` (its real jobs), ``pad_jobs`` (the zero jobs it
padded with) and ``cards`` (the distinct devices its shards ran on).  The
timings of :meth:`StitchServer.stats` are sums of the same clock readings.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import api as _api
from ..config import CanvasLimits, RuntimeConfig, StitchOptions
from ..core.layout import ImageSpec, LayoutPlan, solve
from ..parallel.batch import ENGINES, BatchedStitch
from ..parallel.mesh import make_mesh
from ..runtime import spans, tiler
from ..runtime.logger import get_logger
from ..runtime.pipeline import resolve_device


class ServerOverloaded(RuntimeError):
    """Raised at admission when the pending-job bound is hit (backpressure);
    clients should retry after a short delay."""


@dataclasses.dataclass
class _Job:
    images: List[np.ndarray]
    plan: LayoutPlan
    future: Future
    job: int            # the span job id of its submit
    enqueued_ns: int


@dataclasses.dataclass
class _Warmup:
    """Warm-up request: run one zero batch of ``batch`` jobs of ``plan``."""
    plan: LayoutPlan
    batch: int
    channels: int
    future: Future


def _job_channels(job: "_Job") -> int:
    return (job.images[0].shape[2]
            if job.images and job.images[0].ndim == 3 else 3)


class StitchServer:
    """Dynamic-batching stitch service.

    >>> server = StitchServer(max_batch=64, max_wait_s=0.005)
    >>> fut = server.submit([img_a, img_b], StitchOptions(gap=4))
    >>> strip = fut.result()

    ``engine``: ``"auto"`` (default) runs the batched CUDA kernel on a CUDA
    device and its plain version on the CPU; ``"cuda"`` the kernel only;
    ``"torch"`` the plain whole-job engine.  The device is
    ``config.device``; a CUDA device on a host without CUDA raises here.
    ``use_mesh``: batches over the ``jobs`` axis of ``config.mesh``, or of
    a mesh of every card (which raises on a host without CUDA).
    """

    def __init__(self, max_batch: int = 64, max_wait_s: float = 0.005,
                 engine: str = "auto", use_mesh: bool = False,
                 config: Optional[RuntimeConfig] = None,
                 max_queue: int = 1024, max_signatures: int = 32):
        if engine not in ENGINES:
            raise ValueError(f"unsupported server engine {engine!r}")
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.engine = engine
        self.config = (config or RuntimeConfig()).validate()
        self.device = resolve_device(self.config.device)
        if engine == "cuda" and self.device.type != "cuda":
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs a CUDA device")
        self.mesh = None
        if use_mesh:
            self.mesh = (self.config.mesh if self.config.mesh is not None
                         else make_mesh())
        # bounded admission = explicit backpressure: reject at submit
        # instead of buffering without bound
        self.max_queue = max_queue
        # LRU over signatures: each BatchedStitch holds its plan's device
        # taps, so evicting a signature frees them
        self.max_signatures = max(1, max_signatures)
        self._pending = 0                  # submitted, future not yet set
        self._plock = threading.Lock()
        self._queue: "queue.Queue[Optional[_Job]]" = queue.Queue()
        # sig -> {(batch, channels): BatchedStitch}
        self._compiled: ("collections.OrderedDict[Tuple, "
                         "Dict[Tuple[int, int], BatchedStitch]]") = \
            collections.OrderedDict()
        self._log = get_logger()
        # worker-thread-only mutation.  queue_wait_* = submit -> flush
        # start per job (what a client pays for batching); flush = flush
        # wall, stacking included; stack = gathering the slots' arrays.
        # Timings in ns, summed from the spans' readings; stats() gives s.
        self._stats = {"jobs": 0, "batches": 0, "failed": 0, "warmups": 0}
        self._ns = {"queue_wait": 0, "queue_wait_max": 0, "flush": 0,
                    "stack": 0}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="stitch-server")
        self._closed = False
        self._thread.start()

    # ------------------------------------------------------------- client

    def submit(self, images: Sequence[np.ndarray],
               options: Optional[StitchOptions] = None,
               limits: Optional[CanvasLimits] = None,
               orientations: Optional[Sequence[int]] = None) -> Future:
        """Enqueue one stitch job; resolves to the uint8 HWC strip.

        ``orientations``: per-image EXIF orientation (1-8) applied on the
        device, as ``stitch`` does for decoded files.  With
        ``options.merge_overlap`` the duplicated strips are found (on the
        server's device) and trimmed here, in the caller's thread.
        """
        job = spans.new_job()
        with spans.span("serve.submit", job=job):
            return self._submit(job, images, options, limits, orientations)

    def _submit(self, job, images, options, limits, orientations) -> Future:
        if self._closed:
            raise RuntimeError("server is closed")
        options = (options or StitchOptions()).validate()
        if orientations is None:
            orientations = [1] * len(images)
        if len(orientations) != len(images):
            raise ValueError("orientations length must match images")
        # reserve the slot before any per-pixel work: backpressure bounds
        # what a rejected request costs, not just what is buffered
        self._admit()
        try:
            # api.stitch_arrays' normalization: LA/RGBA flatten onto white,
            # mixed gray + RGB promote to RGB, so a job has 1 or 3 channels
            imgs = _api._unify_channels(
                [np.ascontiguousarray(_api._as_uint8(a)) for a in images])
            specs = [ImageSpec(a.shape[1], a.shape[0], int(o))
                     for a, o in zip(imgs, orientations)]
            if options.merge_overlap:
                # pixel-derived trims change the specs, so merge runs in the
                # caller's thread before the job is keyed by signature
                from ..ops import overlap as _overlap
                imgs, specs, trims = _overlap.merge_arrays(
                    imgs, specs, options, self.device)
                if any(trims):
                    self._log.event("serve.merge", trims=trims)
            plan = solve(specs, options,
                         self.config.limits if limits is None else limits)
            with self._plock:
                fut: Future = Future()
                # under the lock, so close() cannot put its sentinel
                # between the _closed check and the enqueue
                if self._closed:
                    raise RuntimeError("server is closed")
                self._queue.put(_Job(imgs, plan, fut, job,
                                     time.perf_counter_ns()))
        except BaseException:
            self._release()
            raise
        return fut

    # -------------------------------------------------------- admission

    def _full_locked(self) -> None:
        # caller holds self._plock
        if self._pending >= self.max_queue:
            self._log.event("serve.queue_full", depth=self._pending)
            raise ServerOverloaded(
                f"server queue full ({self.max_queue} jobs pending); "
                "retry later")

    def _admit(self) -> None:
        """Reserve one queue slot; raises :class:`ServerOverloaded` when the
        pending-job bound is hit.  The slot is held until :meth:`_resolve`
        (batch jobs) or :meth:`_release` (errors / out-of-band jobs)."""
        with self._plock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._full_locked()
            self._pending += 1

    def _release(self) -> None:
        with self._plock:
            self._pending -= 1

    def ensure_capacity(self) -> None:
        """Overload pre-check that reserves no slot, for callers with
        expensive pre-submit work (the HTTP layer decodes first); the
        authoritative check is still :meth:`_admit` at submit."""
        with self._plock:
            self._full_locked()

    @contextlib.contextmanager
    def admission(self):
        """Hold one queue slot for an out-of-band job, so it counts against
        the same ``max_queue`` bound as batch jobs."""
        self._admit()
        try:
            yield
        finally:
            self._release()

    def warmup(self, shapes: Sequence, options: Optional[StitchOptions] = None,
               limits: Optional[CanvasLimits] = None,
               orientations: Optional[Sequence[int]] = None,
               batch_sizes: Sequence[int] = (1,),
               timeout: Optional[float] = 300.0) -> dict:
        """Run one zero batch at each of ``batch_sizes`` (each clamped to
        ``max_batch`` and the memory cap) for jobs of this geometry, so
        their taps are on the device and the allocator holds the batch's
        memory before real traffic.  ``shapes`` is one ``(height, width)``
        or ``(height, width, channels)`` per image.  Runs on the worker
        thread; blocks until done.  Returns ``{"engine": ..., "batches":
        [...], "signature_cached": True}``.
        """
        if self._closed:
            raise RuntimeError("server is closed")
        options = (options or StitchOptions()).validate()
        norm: List[Tuple[int, int, int]] = []
        for s in shapes:
            t = tuple(int(x) for x in s)
            if len(t) == 2:
                t = t + (3,)
            if len(t) != 3 or min(t) < 1:
                raise ValueError(f"bad warmup shape {s!r}: expected "
                                 "(height, width[, channels])")
            if t[2] not in (1, 3):
                raise ValueError(
                    f"warmup channels must be 1 or 3 (submit flattens "
                    f"alpha), got {t[2]}")
            norm.append(t)
        channels = max(shp[2] for shp in norm)   # mixed promotes to RGB
        if orientations is None:
            orientations = [1] * len(norm)
        if len(orientations) != len(norm):
            raise ValueError("orientations length must match shapes")
        specs = [ImageSpec(shp[1], shp[0], int(o))
                 for shp, o in zip(norm, orientations)]
        plan = solve(specs, options,
                     self.config.limits if limits is None else limits)
        try:
            sizes = [int(b) for b in batch_sizes]
        except TypeError as e:
            raise ValueError(
                f"batch_sizes must be a list of ints, got "
                f"{batch_sizes!r}") from e
        if not sizes:
            raise ValueError("batch_sizes must be non-empty")
        cap = self._effective_cap(plan, channels)
        targets = sorted({self._padded_batch(max(1, min(b, self.max_batch,
                                                         cap)))
                          for b in sizes})
        futs: List[Future] = []
        for b in targets:
            self._admit()
            fut: Future = Future()
            try:
                with self._plock:
                    if self._closed:
                        raise RuntimeError("server is closed")
                    self._queue.put(_Warmup(plan, b, channels, fut))
            except BaseException:
                self._release()
                raise
            futs.append(fut)
        for fut in futs:
            fut.result(timeout=timeout)
        return {"engine": self.engine, "batches": targets,
                "signature_cached": True}

    def _resolve(self, job, value=None, error=None) -> None:
        with self._plock:
            self._pending -= 1
        try:
            if error is not None:
                job.future.set_exception(error)
            else:
                job.future.set_result(value)
        except InvalidStateError:
            # _start_or_drop moved every dequeued future to RUNNING, so this
            # should not happen; it must not propagate either, or the flush
            # would split-retry and recompute batch-mates
            self._log.event("serve.resolve_dropped", cancelled=True)

    def _start_or_drop(self, job) -> bool:
        """Move a dequeued job's future to RUNNING, or, when the client
        cancelled it while it sat queued, notify its waiters and release
        its slot.  ``Future.cancel()`` alone leaves ``wait()`` and
        ``as_completed()`` hanging: only ``set_running_or_notify_cancel()``
        wakes them."""
        if job.future.set_running_or_notify_cancel():
            return True
        with self._plock:
            self._pending -= 1
        self._log.event("serve.job_cancelled")
        return False

    def stats(self) -> dict:
        with self._plock:
            pending = self._pending
        return {**self._stats,
                **{f"{k}_s": v / 1e9 for k, v in self._ns.items()},
                "pending": pending,
                "max_queue": self.max_queue,
                "signatures": len(self._compiled)}

    def close(self, timeout: float = 10.0) -> None:
        if not self._closed:
            with self._plock:
                self._closed = True
                self._queue.put(None)
            self._thread.join(timeout)
            # fail anything that still slipped in behind the sentinel
            while True:
                try:
                    job = self._queue.get_nowait()
                except queue.Empty:
                    break
                if job is not None and self._start_or_drop(job):
                    self._resolve(job, error=RuntimeError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------- worker

    def _loop(self) -> None:
        buckets: Dict[Tuple, List[_Job]] = {}
        deadline: Optional[float] = None
        while True:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.perf_counter())
            try:
                job = self._queue.get(timeout=timeout)
            except queue.Empty:
                job = False       # timer fired: flush everything pending
            if job is None:
                for jobs in buckets.values():
                    self._flush(jobs)
                return
            if isinstance(job, _Warmup):
                self._warm(job)
                continue
            if job is not False:
                # channels joins the key: same-geometry gray and RGB jobs
                # cannot share one stack
                sig = (job.plan.signature(), _job_channels(job))
                buckets.setdefault(sig, []).append(job)
                if len(buckets[sig]) >= self.max_batch:
                    self._flush(buckets.pop(sig))
                if buckets and deadline is None:
                    deadline = time.perf_counter() + self.max_wait_s
                continue
            # flush on deadline
            for sig in list(buckets):
                self._flush(buckets.pop(sig))
            deadline = None

    def _warm(self, wj: "_Warmup") -> None:
        """Worker-thread half of :meth:`warmup`."""
        if not self._start_or_drop(wj):
            return
        try:
            t0 = time.perf_counter()
            self._get_compiled(wj.plan, wj.batch, wj.channels).warm()
            self._stats["warmups"] += 1
            self._log.event("serve.warmup", batch=wj.batch,
                            engine=self.engine,
                            canvas=(wj.plan.canvas_w, wj.plan.canvas_h),
                            wall_s=round(time.perf_counter() - t0, 3))
            self._resolve(wj, value={"engine": self.engine,
                                     "batch": wj.batch})
        except Exception as e:  # noqa: BLE001 — isolation boundary
            self._log.event("serve.warmup_fail", batch=wj.batch,
                            error=repr(e))
            self._resolve(wj, error=e)

    def _get_compiled(self, plan: LayoutPlan, batch: int,
                      channels: int = 3) -> BatchedStitch:
        sig = plan.signature()
        per_size = self._compiled.setdefault(sig, {})
        self._compiled.move_to_end(sig)
        while len(self._compiled) > self.max_signatures:
            _, old_sizes = self._compiled.popitem(last=False)
            self._log.event("serve.signature_evicted",
                            sizes=sorted(old_sizes), kept=len(self._compiled))
        key = (batch, channels)
        if key not in per_size:
            per_size[key] = BatchedStitch(plan, batch, channels,
                                          engine=self.engine,
                                          device=self.device, mesh=self.mesh)
        return per_size[key]

    def _effective_cap(self, plan: LayoutPlan, channels: int) -> int:
        """The memory cap, rounded down to a jobs-axis multiple under a
        mesh.  Shared by :meth:`_flush_started` and :meth:`warmup`, so a
        warmed size is one a real flush can select."""
        cap = self._batch_cap(plan, channels)
        if self.mesh is not None:
            unit = self.mesh.shape["jobs"]
            cap = max(unit, (cap // unit) * unit)
        return cap

    def _padded_batch(self, b: int) -> int:
        """The batch a flush of ``b`` jobs runs: ``b``, or under a mesh the
        next multiple of the jobs axis (the flush pads with zero jobs)."""
        if self.mesh is None:
            return b
        unit = self.mesh.shape["jobs"]
        return -(-b // unit) * unit

    def _batch_cap(self, plan: LayoutPlan, channels: int) -> int:
        """Most jobs per flush under ``config.budget``: bounds the batch's
        estimated device peak (``tiler.resident_peak_bytes`` per job)
        before launch instead of relying on an OOM.  A mesh multiplies it:
        each jobs row holds batch / jobs of the jobs."""
        per_job = max(1, tiler.resident_peak_bytes(plan, channels))
        cap = max(1, int(self.config.budget.hbm_bytes // per_job))
        if self.mesh is not None:
            cap *= self.mesh.shape["jobs"]
        return cap

    def _flush(self, jobs: List[_Job]) -> None:
        # the cancellation gate runs exactly once per job (a second
        # set_running_or_notify_cancel on a RUNNING future raises), so the
        # cap split and split-retry recurse through _flush_started
        self._flush_started([j for j in jobs if self._start_or_drop(j)])

    def _flush_started(self, jobs: List[_Job]) -> None:
        if not jobs:
            return
        plan = jobs[0].plan
        channels = _job_channels(jobs[0])
        cap = self._effective_cap(plan, channels)
        if len(jobs) > cap:
            self._log.event("serve.batch_capped", n=len(jobs), cap=cap,
                            canvas=(plan.canvas_w, plan.canvas_h))
            for lo in range(0, len(jobs), cap):
                self._flush_started(jobs[lo:lo + cap])
            return
        try:
            with spans.span("serve.flush") as flush:
                b = len(jobs)
                padded = self._padded_batch(b)
                with spans.span("serve.stack",
                                start_ns=flush.start_ns) as stack:
                    # the rows up to a jobs-axis multiple are zero jobs,
                    # made on the device; their canvases drop
                    slots = [[j.images[slot] for j in jobs]
                             for slot in range(len(plan.placements))]
                stitcher = self._get_compiled(plan, padded, channels)
                out = stitcher(slots)
                flush.counts = {"jobs": b, "pad_jobs": padded - b,
                                "cards": stitcher.cards}
            # stats before resolving: a client woken by its future sees
            # stats() that include its job.  Latency accumulates only here,
            # so the split-retry below does not count a wait twice.
            for j in jobs:
                spans.record("serve.queue", j.enqueued_ns, flush.start_ns,
                             job=j.job, parent=flush.id)
            waits = [flush.start_ns - j.enqueued_ns for j in jobs]
            ns = self._ns
            ns["queue_wait"] += sum(waits)
            ns["queue_wait_max"] = max(ns["queue_wait_max"], max(waits))
            ns["flush"] += flush.end_ns - flush.start_ns
            ns["stack"] += stack.end_ns - stack.start_ns
            self._stats["jobs"] += b
            self._stats["batches"] += 1
            for i, j in enumerate(jobs):
                with spans.span("serve.resolve", job=j.job, parent=flush.id):
                    self._resolve(j, value=out[i])
            self._log.event("serve.flush", batch=b,
                            canvas=(plan.canvas_w, plan.canvas_h))
        except Exception as e:  # noqa: BLE001 — isolation boundary
            # retry the halves, so one poisoned job cannot take down its
            # batch-mates
            if len(jobs) == 1:
                self._stats["failed"] += 1       # before resolve (see above)
                with spans.span("serve.resolve", job=jobs[0].job,
                                parent=flush.id):
                    self._resolve(jobs[0], error=e)
                self._log.event("serve.job_fail", error=repr(e))
                return
            self._log.event("serve.batch_fail_retry_split", n=len(jobs),
                            error=repr(e))
            mid = len(jobs) // 2
            self._flush_started(jobs[:mid])
            self._flush_started(jobs[mid:])
