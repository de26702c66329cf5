"""The stitch pipeline of the port: budget plan -> composite -> readback.

Port of ``imagestitching_tpu/runtime/pipeline.py``: ``StitchMetrics``
(:45-88), the streamed strategy (``_fence_limit`` :205-219, ``_run_streamed``
:222-254), the banded strategy (``_BandedExecutor`` :261-404,
``_run_banded_pallas`` :407-466, ``_run_banded`` :469-485), the OOM
classifier ``_is_oom`` (:773-787), the demotion ladder (``_banded_bands``
:790-804, ``_strategy_ladder`` :807-824), the front door ``run`` (:851-915)
with the single-device ladder of ``_run_body`` (:1009-1055) and its
``space-sharded`` branch (:949-1007), and the device-free host-blit path
``_host_blit`` (:917-939), and the overlapped scheduler ``run_overlapped``
(:512-557, :579-749) with its transport probe ``_transport_rtt`` (:565-576)
and the profiler switch ``_Profile`` (:493-509).

The tiler's ``plan_execution`` picks the first rung from the memory
budget: ``resident`` (every source and the canvas on the device), then
``streamed`` (the canvas and one or two sources), then ``banded`` (the canvas
on the host, the device holding one source window and one region at a
time).  A rung that runs out of device memory hands the job to the next one.
The engine (``auto``/``cuda``: the kernels; ``torch``: the plain version)
is the same on every rung; nothing demotes from one engine to the other.

With ``RuntimeConfig.mesh`` whose ``space`` axis is larger than 1, a job
whose per-device estimate (``tiler.sharded_peak_bytes``) fits the budget
runs first as ``space-sharded`` (``parallel.sharding.ShardedStitch``: row
bands on kernel #3, one per space index); an OOM there demotes to the
single-card ladder on ``config.device``.  JAX's second try on the gather
engine after ``Infeasible`` (:973-980) has no twin: the port's kernel has
no ``Infeasible``.

:func:`run_overlapped` is the file path's scheduler: the plan is solved from
image headers, and each source is uploaded and drawn the moment its decode
lands (decode || upload || compute), through the same placement step as the
resident and streamed rungs; an OOM demotes it to the banded rung.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import tempfile
import time
import traceback
from typing import (Callable, List, NamedTuple, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from ..config import RuntimeConfig
from ..core import geometry, oracle
from ..core.layout import LayoutPlan
from ..ops import cuda_resize, torch_compose
from ..ops.assemble import job_channels, new_canvas, source_array, \
    source_tensor
from ..ops.window import WindowPlan
from . import tiler
from .logger import get_logger

ProgressFn = Callable[[str, float], None]
#: What a rung returns: the canvas and the bytes it uploaded.
Result = Tuple[Union[np.ndarray, torch.Tensor], int]


@dataclasses.dataclass
class StitchMetrics:
    """Per-phase wall clock + throughput for one job (the JAX package's
    field set).  ``h2d_bytes`` counts what the winning rung staged onto the
    job's device: the sources on the resident, streamed and overlapped
    paths, the source windows on the banded one.

    The overlapped path (:func:`run_overlapped`) also fills
    ``transport_rtt_s``, a one-byte device-to-host read on the idle device
    (the drain in ``compute_s`` pays one), and ``stage_wait_s`` /
    ``stage_wait_max_s``, the host time blocked in the per-source staging
    calls (a wait for a free pinned slot, the copy into it, the enqueues and
    the staged-bytes fence): near 0 with a large ``compute_s`` means the
    card drains work after the last decode; large means the uploads hold
    the host back, and the maximum tells one slow source from a slow link.
    There ``prepare_s`` is the decode wall and ``compute_s`` the drain
    exposed after the last decode."""

    strategy: str = "resident"
    prepare_s: float = 0.0
    layout_s: float = 0.0
    compute_s: float = 0.0    # through the device synchronise
    readback_s: float = 0.0
    encode_s: float = 0.0
    export_s: float = 0.0
    total_s: float = 0.0
    transport_rtt_s: float = 0.0
    stage_wait_s: float = 0.0
    stage_wait_max_s: float = 0.0
    h2d_bytes: int = 0
    canvas_w: int = 0
    canvas_h: int = 0
    est_peak_bytes: int = 0

    @property
    def out_megapixels(self) -> float:
        return self.canvas_w * self.canvas_h / 1e6

    @property
    def mp_per_sec(self) -> float:
        return self.out_megapixels / self.total_s if self.total_s else 0.0


def _noop(phase: str, fraction: float) -> None:
    del phase, fraction


# Allocator-exhaustion wordings (the JAX package's list); the torch types
# are checked first.
_OOM_PHRASES = ("resource_exhausted", "out of memory", "ran out of memory",
                "allocation failure", "failed to allocate",
                "cannot allocate", "could not allocate", "memory exhausted",
                "exceeds the memory capacity", "insufficient memory",
                "oom while")


def _is_oom(e: BaseException) -> bool:
    if isinstance(e, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    if not isinstance(e, RuntimeError):
        return False
    low = str(e).lower()
    return any(p in low for p in _OOM_PHRASES)


def resolve_device(name) -> torch.device:
    """A job's or a server's device; a CUDA device on a host without one is
    an error, never a silent move to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"RuntimeConfig(device={str(name)!r}) but CUDA is not "
            "available on this host; pass device='cpu' to run the plain "
            "PyTorch version")
    return device


def _fence_limit(plan: LayoutPlan, channels: int,
                 config: RuntimeConfig) -> int:
    """Staged-but-unfenced byte budget of the streamed strategy: half the
    budget headroom above the canvas, floored at 8 MB but never above the
    headroom, so zero headroom fences after every source."""
    headroom = max(0, config.budget.hbm_bytes
                   - plan.canvas_h * plan.canvas_w * channels)
    return max(min(8 << 20, headroom), headroom // 2)


def _run_streamed(plan: LayoutPlan, images: Sequence[np.ndarray],
                  channels: int, config: RuntimeConfig,
                  device: torch.device, progress: ProgressFn) -> Result:
    """The canvas on ``device``; each source uploaded, drawn into it in
    place and dropped.  Returns ``(canvas tensor, bytes uploaded)``.

    The fence waits for the device once the staged bytes pass
    :func:`_fence_limit`.  While uploads are synchronous to the host,
    sources cannot pile up and a fence only waits for the kernels; it
    bounds the sources in flight once uploads are not."""
    job_channels(plan, images)
    steps = cuda_resize.plan_steps(plan, device)
    canvas = new_canvas(plan, channels, device)
    fence_limit = _fence_limit(plan, channels, config)
    plain = config.engine == "torch"
    inflight = uploaded = 0
    n = len(images)
    for i, (raw, p, step) in enumerate(zip(images, plan.placements, steps)):
        if step is not None:
            src = source_tensor(raw, p, channels, device)
            cuda_resize.draw_placement(src, p, step, canvas, plain)
            uploaded += src.nbytes
            inflight += src.nbytes
            if inflight > fence_limit:
                if device.type == "cuda":
                    torch.cuda.current_stream(device).synchronize()
                inflight = 0
        progress("composite", 0.30 + 0.60 * (i + 1) / n)
    return canvas, uploaded


def _host_canvas(plan: LayoutPlan, channels: int) -> np.ndarray:
    out = np.empty((plan.canvas_h, plan.canvas_w, channels), np.uint8)
    out[:] = np.asarray(plan.background[:channels], np.uint8)
    return out


def _run_banded_kernel(plan: LayoutPlan, oriented: Sequence[np.ndarray],
                       channels: int, band_rows: int, device: torch.device,
                       progress: ProgressFn) -> Result:
    """The banded strategy on kernel #3: the canvas lives on the host.

    Identity placements are host blits.  Every other placement runs in
    chunks of ``band_rows`` dest rows (:class:`WindowPlan`): the chunk's
    source window is uploaded, the kernel resamples it into one region
    buffer, and the valid rows are read back into the host canvas.  The
    placement's taps are uploaded once; a chunk passes its first tap row
    and its crop's start (``cuda_resize.WindowLauncher``).  The device
    holds one window, one region and the taps.  Returns ``(canvas, bytes
    uploaded)``."""
    work = []
    for img, p in zip(oriented, plan.placements):
        if p.row_span[1] <= p.row_span[0] or p.col_span[1] <= p.col_span[0]:
            continue
        off = geometry.placement_copy_offsets(p, plan.filter)
        work.append((img, p, off if off is not None
                     else WindowPlan(p, plan.filter, band_rows)))
    out = _host_canvas(plan, channels)
    total = sum(1 if isinstance(w, tuple) else w.n_chunks for _, _, w in work)
    done = uploaded = 0
    for img, p, w in work:
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        if isinstance(w, tuple):
            sr, sc = w
            out[r0:r1, c0:c1] = img[sr:sr + r1 - r0, sc:sc + c1 - c0]
            done += 1
            progress("composite", 0.30 + 0.60 * done / total)
            continue
        taps = [torch.from_numpy(a).to(device)
                for a in (w.ri0, w.rw, w.ci0, w.cw)]
        region = torch.empty((w.chunk, w.n_cols, channels), dtype=torch.uint8,
                             device=device)
        launch = cuda_resize.WindowLauncher(
            *taps, region, (w.crop_rows, w.disp_w, channels))
        for g in range(w.n_chunks):
            a, valid, s_lo = w.chunk_window(g)
            crop = torch.from_numpy(w.stage_crop(img, g)).to(device)
            launch(crop, a, s_lo, valid)
            # .cpu() waits for the kernel, so the next chunk may reuse the
            # region buffer (a non-blocking readback would need two)
            out[r0 + a:r0 + a + valid, c0:c1] = region[:valid].cpu().numpy()
            uploaded += crop.nbytes
            done += 1
            progress("composite", 0.30 + 0.60 * done / total)
    return out, uploaded


class _BandWork(NamedTuple):
    """One drawn placement of :class:`_BandedExecutor`: full-span row taps
    (host), the source window height every band's crop takes, and the
    column taps (device)."""

    ri0: np.ndarray
    rw: np.ndarray
    crop_rows: int
    ci0: torch.Tensor
    cw: torch.Tensor


class _BandedExecutor:
    """The plain engine's banded strategy (``engine="torch"``): the canvas
    in canvas-aligned row bands of ``band_rows``, each placement's rows in a
    band resampled by the plain version from a host-cropped window of its
    oriented source.  Column taps are uploaded once.  A (band, placement)
    pair that does not meet is skipped: eager ops need no constant zero crop
    (the JAX executor's one jitted program took every placement's crop in
    every band)."""

    def __init__(self, plan: LayoutPlan, band_rows: int, channels: int,
                 device: torch.device):
        self.plan, self.band_rows = plan, band_rows
        self.channels, self.device = channels, device
        bands = tiler.band_ranges(plan, band_rows)
        self.work: List[Optional[_BandWork]] = []
        for p in plan.placements:
            r0, r1 = p.row_span
            c0, c1 = p.col_span
            if r1 <= r0 or c1 <= c0:
                self.work.append(None)
                continue
            taps = torch_compose.placement_taps(p, plan.filter)
            ri0, rw = taps["rows"]["i0"], taps["rows"]["w"]
            k_rows = rw.shape[1]
            # the widest window any CANVAS-aligned band needs: bands start
            # at multiples of band_rows in canvas space, not at the span's
            # start, so a wide filter needs its crop sized over the real
            # band intersections
            need = k_rows
            for lo, hi in bands:
                br0, br1 = max(r0, lo), min(r1, hi)
                if br1 > br0:
                    need = max(need, int(ri0[br1 - 1 - r0]) + k_rows
                               - int(ri0[br0 - r0]))
            _, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
            self.work.append(_BandWork(
                ri0, rw, min(disp_h, need),
                *(torch.from_numpy(taps["cols"][k]).to(device)
                  for k in ("i0", "w"))))

    def run(self, oriented: Sequence[np.ndarray],
            progress: ProgressFn = _noop) -> Result:
        """Composite the oriented HWC sources; returns ``(canvas, bytes
        uploaded)``."""
        plan, dev = self.plan, self.device
        out = _host_canvas(plan, self.channels)
        bands = tiler.band_ranges(plan, self.band_rows)
        uploaded = 0
        for bi, (lo, hi) in enumerate(bands):
            for img, p, w in zip(oriented, plan.placements, self.work):
                if w is None:
                    continue
                r0, r1 = p.row_span
                c0, c1 = p.col_span
                br0, br1 = max(r0, lo), min(r1, hi)
                if br1 <= br0:
                    continue
                ri0 = w.ri0[br0 - r0:br1 - r0]
                # crop_rows <= disp_h, so the window is always whole
                s_lo = min(int(ri0[0]), max(0, img.shape[0] - w.crop_rows))
                crop = torch.from_numpy(np.ascontiguousarray(
                    img[s_lo:s_lo + w.crop_rows])).to(dev)
                i0 = np.minimum(ri0 - s_lo, w.crop_rows - 1).astype(np.int32)
                region = cuda_resize.resize_place_window_ref(
                    crop, torch.from_numpy(i0).to(dev),
                    torch.from_numpy(np.ascontiguousarray(
                        w.rw[br0 - r0:br1 - r0])).to(dev), w.ci0, w.cw)
                out[br0:br1, c0:c1] = region.cpu().numpy()
                uploaded += crop.nbytes
            progress("composite", 0.30 + 0.60 * (bi + 1) / len(bands))
        return out, uploaded


def _run_banded(plan: LayoutPlan, images: Sequence[np.ndarray],
                channels: int, band_rows: int, engine: str,
                device: torch.device, progress: ProgressFn) -> Result:
    """Orient on the host, then the kernel path (``auto``/``cuda``) or the
    plain executor (``torch``)."""
    job_channels(plan, images)
    oriented = [geometry.orient_array(source_array(raw, p, channels),
                                      p.orientation)
                for raw, p in zip(images, plan.placements)]
    if engine == "torch":
        return _BandedExecutor(plan, band_rows, channels,
                               device).run(oriented, progress)
    return _run_banded_kernel(plan, oriented, channels, band_rows, device,
                              progress)


def _run_rung(strategy: str, band: Optional[int], plan: LayoutPlan,
              images: Sequence[np.ndarray], channels: int,
              config: RuntimeConfig, device: torch.device,
              progress: ProgressFn) -> Result:
    """One rung of the ladder: ``(canvas, bytes uploaded)``, the canvas a
    tensor on ``device`` (resident, streamed) or a host array (banded).

    Work is enqueued asynchronously, so the rung waits for the device
    before it counts as done: an OOM or a kernel fault then surfaces here,
    inside the ladder, and not at the caller's first use of the canvas."""
    if strategy == "banded":
        return _run_banded(plan, images, channels, band, config.engine,
                           device, progress)
    if strategy == "streamed":
        out, uploaded = _run_streamed(plan, images, channels, config, device,
                                      progress)
    else:
        out = cuda_resize.stitch(plan, images, device,
                                 plain=config.engine == "torch")
        uploaded = sum(np.asarray(a).nbytes for a in images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, uploaded


def _banded_bands(ex: tiler.ExecutionPlan, plan: LayoutPlan) -> List[int]:
    """Band heights of the banded attempts, largest first, floored at the
    canvas height: a canvas under 8 rows still gets a banded attempt."""
    band = ex.band_rows or min(plan.canvas_h, 2048)
    floor = max(1, min(8, plan.canvas_h))
    bands = []
    while band >= floor:
        bands.append(band)
        band //= 4
    return bands


def _strategy_ladder(ex: tiler.ExecutionPlan, plan: LayoutPlan
                     ) -> List[Tuple[str, Optional[int]]]:
    """``(strategy, band_rows)`` attempts, leanest last, starting at the
    plan's strategy."""
    order = ["resident", "streamed", "banded"]
    ladder: List[Tuple[str, Optional[int]]] = []
    for s in order[order.index(ex.strategy):]:
        if s == "banded":
            ladder.extend(("banded", b) for b in _banded_bands(ex, plan))
        else:
            ladder.append((s, None))
    return ladder


def run(plan: LayoutPlan, images: Sequence[np.ndarray],
        config: Optional[RuntimeConfig] = None,
        progress: ProgressFn = _noop,
        keep_on_device: bool = False,
        ) -> Tuple[Union[np.ndarray, torch.Tensor], StitchMetrics]:
    """Execute one solved stitch job under the configured memory budget.

    Returns ``(canvas, metrics)``: a uint8 HWC numpy array, or with
    ``keep_on_device=True`` the canvas tensor on the configured device when
    the winning strategy holds it there (resident, streamed); the banded
    and space-sharded strategies and the host engines return numpy either
    way.
    """
    config = (config or RuntimeConfig()).validate()
    log = get_logger()
    m = StitchMetrics(canvas_w=plan.canvas_w, canvas_h=plan.canvas_h)
    t_start = time.perf_counter()

    channels = 3
    if images:
        a0 = np.asarray(images[0])
        channels = a0.shape[2] if a0.ndim == 3 else 1

    # Pure-blit fast path: every drawn placement is an identity copy, so the
    # canvas is sources + background and no device is touched.  A mesh keeps
    # the device pipeline.
    if (config.engine == "auto" and config.mesh is None
            and not keep_on_device and channels == 3):
        copies = geometry.plan_copy_offsets(plan)
        out = _host_blit(plan, images, copies) if copies is not None else None
        if out is not None:
            m.strategy = "host-blit"
            m.compute_s = time.perf_counter() - t_start
            m.total_s = time.perf_counter() - t_start
            log.event("pipeline.done", strategy=m.strategy,
                      compute_s=round(m.compute_s, 4),
                      mp_per_sec=round(m.mp_per_sec, 1))
            progress("layout", 1.0)
            progress("composite", 1.0)
            return out, m

    if config.engine == "oracle":       # host float64; numpy either way
        out = oracle.stitch(plan, images)
        m.strategy = "oracle"
        m.compute_s = m.total_s = time.perf_counter() - t_start
        progress("composite", 1.0)
        return out, m

    device = resolve_device(config.device)
    ex = tiler.plan_execution(plan, config.budget, channels)
    m.est_peak_bytes = ex.est_peak_bytes
    log.event("pipeline.plan", strategy=ex.strategy,
              est_peak_mb=round(ex.est_peak_bytes / 1e6, 1),
              budget_mb=round(ex.budget_bytes / 1e6, 1),
              canvas=(plan.canvas_w, plan.canvas_h))
    progress("layout", 1.0)

    t0 = time.perf_counter()
    out, last_oom = None, None
    prof = _Profile(config.profile, device)
    try:
        n_space = (config.mesh.shape.get("space", 1)
                   if config.mesh is not None else 1)
        if n_space > 1:
            out, last_oom = _run_space_sharded(plan, images, channels,
                                               config, n_space, m, log)
            if out is not None:
                m.strategy = "space-sharded"
        for strategy, band in ([] if out is not None
                               else _strategy_ladder(ex, plan)):
            try:
                out, m.h2d_bytes = _run_rung(strategy, band, plan, images,
                                             channels, config, device,
                                             progress)
            except Exception as e:  # noqa: BLE001 — OOM classification
                if not _is_oom(e):
                    raise
                # The traceback holds the failed rung's frames and with them
                # its sources and canvas: drop them before the next rung
                # allocates.
                traceback.clear_frames(e.__traceback__)
                last_oom = e
                log.event("pipeline.oom_retry", failed=strategy, band=band)
                continue
            m.strategy = strategy
            break
    finally:
        prof.stop()
    if out is None:
        raise MemoryError(
            "stitch ran out of device memory on every strategy") from last_oom
    m.compute_s = time.perf_counter() - t0
    if isinstance(out, torch.Tensor) and not keep_on_device:
        t1 = time.perf_counter()
        out = out.cpu().numpy()
        m.readback_s = time.perf_counter() - t1
    m.total_s = time.perf_counter() - t_start
    # m.strategy names the rung that won, after any demotion
    log.event("pipeline.done", strategy=m.strategy,
              compute_s=round(m.compute_s, 4),
              mp_per_sec=round(m.mp_per_sec, 1))
    progress("composite", 1.0)
    return out, m


def _run_space_sharded(plan: LayoutPlan, images: Sequence[np.ndarray],
                       channels: int, config: RuntimeConfig, n_space: int,
                       m: StitchMetrics, log
                       ) -> Tuple[Optional[np.ndarray],
                                  Optional[BaseException]]:
    """The space-sharded attempt: ``(canvas, None)``, or ``(None, the OOM)``
    when a device ran out of memory, or ``(None, None)`` when the
    per-device estimate is over the budget.  Every other error propagates.
    """
    est = tiler.sharded_peak_bytes(plan, n_space, channels)
    if est > config.budget.hbm_bytes:
        log.event("pipeline.sharded_budget_reject",
                  est_per_device_mb=round(est / 1e6, 1),
                  budget_mb=round(config.budget.hbm_bytes / 1e6, 1))
        return None, None
    from ..parallel.sharding import ShardedStitch

    try:
        sharded = ShardedStitch(plan, config.mesh, channels,
                                engine=config.engine)
        out = sharded(images)
    except Exception as e:  # noqa: BLE001 — OOM classification
        if not _is_oom(e):
            raise
        # the estimate admitted the mesh but a device ran out: the bands
        # and sources die with the traceback's frames, then the single-card
        # ladder runs
        traceback.clear_frames(e.__traceback__)
        log.event("pipeline.oom_retry", failed="space-sharded", band=None)
        return None, e
    m.h2d_bytes = sharded.h2d_bytes
    log.event("pipeline.space_sharded", engine=config.engine,
              shards=n_space)
    return out, None


def _host_blit(plan, images, copies) -> Optional[np.ndarray]:
    """Assemble a pure-blit canvas with memcpys (None -> caller falls back
    to the device path, e.g. on a shape/channel surprise)."""
    srcs = {}
    for p in plan.placements:       # validate before touching the canvas
        if p.index in copies:
            raw = geometry.normalize_rgb(images[p.index])
            if raw is None or raw.shape[:2] != (p.raw_h, p.raw_w):
                return None
            srcs[p.index] = raw
    canvas = np.empty((plan.canvas_h, plan.canvas_w, 3), np.uint8)
    # fill only what the pastes won't overwrite — on a gapless equal-size
    # strip that is nothing at all
    geometry.fill_uncovered(canvas, plan, copies, plan.background[:3])
    for p in plan.placements:
        if p.index in copies:
            geometry.paste_blit(
                canvas, p, geometry.orient_array(srcs[p.index],
                                                 p.orientation),
                copies[p.index])
    return canvas


# ---------------------------------------------------------------------------
# Overlapped execution: decode || upload || compute
# ---------------------------------------------------------------------------

class _Profile:
    """``torch.profiler`` over one job when ``enabled`` (twin of the JAX
    package's ``jax.profiler`` trace): ``stop()`` ends it and writes a
    Chrome trace under ``$IMAGESTITCH_TRACE_DIR`` (default
    ``<tempdir>/imagestitching_trace``).  It is idempotent and must run on
    every exit path, or the profiler stays started and the next profiled
    job fails."""

    def __init__(self, enabled: bool, device: torch.device):
        self._prof = None
        if enabled:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        trace_dir = os.environ.get(
            "IMAGESTITCH_TRACE_DIR",
            os.path.join(tempfile.gettempdir(), "imagestitching_trace"))
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir,
                            f"stitch-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        get_logger().event("pipeline.profile", trace=path)


class _Stager:
    """The overlapped body's uploads: a ring of host slots, a copy stream
    and the staged-bytes fence.

    :meth:`upload` copies a decoded source into the next free slot, then
    copies the slot to a new device tensor.  On a CUDA device the slots are
    pinned (``torch.empty(pin_memory=True)``, which the caching host
    allocator keeps for the next job) and the upload runs non-blocking on a
    copy stream of its own: the device tensor is allocated there, an event
    marks the end of the copy, the caller's (compute) stream waits on that
    event, and ``record_stream`` keeps the tensor's memory from a later
    allocation until the compute stream is done with it.  A slot is written
    again only after its last upload's event, so the host copy of a source
    can go as soon as :meth:`upload` returns.  :meth:`drawn` is the fence:
    once the bytes of sources whose draws are still queued pass ``limit``,
    it waits for the oldest draw.  On the CPU the same steps run with plain
    buffers and no streams or events."""

    def __init__(self, device: torch.device, slot_bytes: int, n_slots: int,
                 limit: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.slots = [torch.empty(slot_bytes, dtype=torch.uint8,
                                  pin_memory=self.cuda)
                      for _ in range(n_slots)]
        self.slot_done: List[Optional[torch.cuda.Event]] = [None] * n_slots
        self.next = 0
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.limit = limit
        self.queued: collections.deque = collections.deque()
        self.queued_bytes = 0

    def upload(self, raw: np.ndarray) -> torch.Tensor:
        """``raw`` (contiguous uint8 HWC) as a tensor on the device, ready
        for work enqueued on the current stream."""
        k, self.next = self.next, (self.next + 1) % len(self.slots)
        if self.slot_done[k] is not None:
            self.slot_done[k].synchronize()   # its last upload has landed
        host = self.slots[k][:raw.nbytes].view(raw.shape)
        np.copyto(host.numpy(), raw)
        if not self.cuda:
            src = torch.empty(raw.shape, dtype=torch.uint8)
            src.copy_(host)
            return src
        with torch.cuda.stream(self.copy_stream):
            src = torch.empty(raw.shape, dtype=torch.uint8,
                              device=self.device)
            src.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.copy_stream)
        self.slot_done[k] = done
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        src.record_stream(compute)
        return src

    def drawn(self, nbytes: int) -> None:
        """A source of ``nbytes`` has its draw enqueued on the current
        stream."""
        ev = None
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        self.queued.append((ev, nbytes))
        self.queued_bytes += nbytes
        while self.queued_bytes > self.limit and self.queued:
            ev, n = self.queued.popleft()
            if ev is not None:
                ev.synchronize()
            self.queued_bytes -= n


def run_overlapped(plan: LayoutPlan, loaders, config: RuntimeConfig,
                   progress: ProgressFn = _noop,
                   keep_on_device: bool = False,
                   ) -> Tuple[Union[np.ndarray, torch.Tensor], StitchMetrics]:
    """Composite that overlaps host decode with the upload and the draw.

    ``loaders[i]()`` returns image i's raw uint8 HWC RGB array (decode +
    normalize).  The layout is already solved from header metadata, so
    compositing starts when the FIRST decode lands, not the last.
    Placements are independent, so sources are drawn in completion order,
    each through :func:`..ops.cuda_resize.draw_placement` (kernel #1 for a
    resampled placement) into a canvas on ``config.device``; each host copy
    is dropped once its source is staged.

    The tiler plans up front.  A banded plan, or an OOM at the canvas, in
    the loop or at the drain, demotes to the banded rung (kernel #3) on the
    host copies, re-decoding the ones already dropped; the strategy is then
    ``"overlapped/banded"``.

    Raises on any decode failure (including the watchdog's TimeoutError):
    by stitch time geometry is committed, the reference aborts there too
    (index.js:1507-1509).  Returns ``(canvas, metrics)``; with
    ``keep_on_device=True`` the canvas stays a tensor where the card holds
    it.
    """
    config = config.validate()
    log = get_logger()
    m = StitchMetrics(canvas_w=plan.canvas_w, canvas_h=plan.canvas_h,
                      strategy="overlapped")
    t_start = time.perf_counter()
    channels = 3
    device = resolve_device(config.device)

    ex = tiler.plan_execution(plan, config.budget, channels)
    m.est_peak_bytes = ex.est_peak_bytes
    log.event("pipeline.plan", strategy=f"overlapped/{ex.strategy}",
              est_peak_mb=round(ex.est_peak_bytes / 1e6, 1),
              budget_mb=round(ex.budget_bytes / 1e6, 1),
              canvas=(plan.canvas_w, plan.canvas_h))

    prof = _Profile(config.profile, device)
    try:
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            return _run_overlapped_body(plan, loaders, config, progress, m,
                                        ex, log, t_start, channels, device,
                                        keep_on_device)
    finally:
        prof.stop()


# Per-process cache of the idle-device transport probe: the round trip is a
# property of the host and the card, not of a job, so steady-state serving
# pays a probe at most once per TTL.  A probe taken while the card is busy
# overcounts (it queues behind the work): acceptable for an attribution
# metric.
_RTT_TTL_S = 300.0
_rtt_cache: dict = {}


def _transport_rtt(device: torch.device) -> float:
    """Seconds of a one-byte device-to-host read after a synchronise."""
    now = time.monotonic()
    at, rtt = _rtt_cache.get(device, (float("-inf"), 0.0))
    if now - at > _RTT_TTL_S:
        probe = torch.zeros(1, dtype=torch.uint8, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        probe.cpu()
        rtt = time.perf_counter() - t0
        _rtt_cache[device] = (now, rtt)
    return rtt


def _drain(device: torch.device) -> None:
    """Wait for the work queued on the device's current stream."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _run_overlapped_body(plan, loaders, config, progress, m, ex, log,
                         t_start, channels, device, keep_on_device):
    from . import decoding

    n = len(loaders)

    def _checked(i: int, raw: np.ndarray) -> np.ndarray:
        p = plan.placements[i]
        if raw.shape[:2] != (p.raw_h, p.raw_w):
            raise ValueError(
                f"image {i}: decoded {raw.shape[1]}x{raw.shape[0]} but "
                f"header said {p.raw_w}x{p.raw_h}")
        return raw

    # Host copies are kept only until a source is staged (or for the banded
    # path, which needs them); an OOM retry re-decodes the dropped ones
    # instead of holding GBs of raw arrays for the whole job.
    decoded: List[Optional[np.ndarray]] = [None] * n
    composited = [False] * n
    canvas = steps = stager = None
    oom = None
    if ex.strategy in ("resident", "streamed"):
        drawn = [p for p in plan.placements
                 if p.row_span[1] > p.row_span[0]
                 and p.col_span[1] > p.col_span[0]]
        try:
            canvas = new_canvas(plan, channels, device)
            steps = cuda_resize.plan_steps(plan, device)
            stager = _Stager(
                device, max((p.raw_h * p.raw_w * channels for p in drawn),
                            default=1), max(1, min(3, len(drawn))),
                _fence_limit(plan, channels, config))
        except Exception as e:  # noqa: BLE001 — OOM classification
            if not _is_oom(e):
                raise
            oom = e   # the canvas does not fit: decode, keep, go banded
            canvas = steps = stager = None
            log.event("pipeline.oom_retry", failed="overlapped-alloc",
                      band=None)
    plain = config.engine == "torch"

    gen = decoding.iter_decoded(loaders, config.decode_threads,
                                config.decode_timeout_s)
    done = 0
    t_decode = 0.0
    try:
        if canvas is not None:
            # the round trip this job pays once inside compute_s at the
            # drain; probed after the decode pool starts, so it runs under
            # the first decode
            m.transport_rtt_s = _transport_rtt(device)
        for i, raw, err in gen:
            if err is not None:
                log.event("pipeline.overlapped_decode_fail", index=i,
                          error=repr(err))
                raise err
            raw = _checked(i, np.asarray(raw))
            decoded[i] = raw
            t_decode = max(t_decode, time.perf_counter() - t_start)
            p = plan.placements[i]
            if canvas is not None and steps[i] is not None:
                try:
                    t_stage = time.perf_counter()
                    src = stager.upload(np.ascontiguousarray(
                        source_array(raw, p, channels)))
                    cuda_resize.draw_placement(src, p, steps[i], canvas,
                                               plain)
                    del src
                    stager.drawn(raw.nbytes)
                    t_stage = time.perf_counter() - t_stage
                    m.stage_wait_s += t_stage
                    m.stage_wait_max_s = max(m.stage_wait_max_s, t_stage)
                    m.h2d_bytes += raw.nbytes
                    composited[i] = True
                    decoded[i] = None   # staged: drop the host copy
                except Exception as e:  # noqa: BLE001 — OOM classify
                    if not _is_oom(e):
                        raise
                    oom = e
                    canvas = steps = stager = src = None
                    log.event("pipeline.oom_retry", failed="overlapped",
                              band=None)
            done += 1
            progress("composite", 0.30 + 0.60 * done / n)
    finally:
        # an error anywhere above (probe, decode, composite) must not leave
        # the eagerly-started workers decoding the rest of the job
        gen.close()
    m.prepare_s = t_decode

    t_drain = time.perf_counter()
    out = None
    if canvas is not None:
        # compute_s = the device drain exposed after the last decode (work
        # that ran under decode cost no wall time)
        try:
            _drain(device)
            m.compute_s = time.perf_counter() - t_drain
            if keep_on_device:
                out = canvas   # the caller streams the readback
            else:
                t0 = time.perf_counter()
                out = canvas.cpu().numpy()
                m.readback_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — OOM classification
            if not _is_oom(e):
                raise
            oom = e
            log.event("pipeline.oom_retry", failed="overlapped-drain",
                      band=None)
    if out is None:
        # free the device canvas, the taps and the pinned ring, and the
        # failed attempt's frames, before the banded rung allocates
        canvas = steps = stager = None
        if oom is not None:
            traceback.clear_frames(oom.__traceback__)
        missing = [i for i in range(n) if decoded[i] is None
                   and composited[i]]
        if missing:
            log.event("pipeline.oom_redecode", n=len(missing))
            gen2 = decoding.iter_decoded(
                [loaders[j] for j in missing], config.decode_threads,
                config.decode_timeout_s)
            try:
                for k, raw2, err2 in gen2:
                    if err2 is not None:
                        raise err2
                    decoded[missing[k]] = _checked(missing[k],
                                                   np.asarray(raw2))
            finally:
                gen2.close()   # a failed re-decode must cancel the workers
        for band in _banded_bands(ex, plan):
            try:
                out, m.h2d_bytes = _run_banded(plan, decoded, channels, band,
                                               config.engine, device,
                                               progress)
                break
            except Exception as e:  # noqa: BLE001 — OOM classification
                if not _is_oom(e):
                    raise
                traceback.clear_frames(e.__traceback__)
                oom = e
                log.event("pipeline.oom_retry", failed="banded", band=band)
        if out is None:
            raise MemoryError(
                "overlapped stitch ran out of device memory on every "
                "strategy") from oom
        m.strategy = "overlapped/banded"
        m.compute_s = time.perf_counter() - t_drain
    m.total_s = time.perf_counter() - t_start
    log.event("pipeline.overlapped_done", n=n, strategy=m.strategy,
              total_s=round(m.total_s, 4),
              decode_wall_s=round(m.prepare_s, 4),
              compute_s=round(m.compute_s, 4),
              transport_rtt_s=round(m.transport_rtt_s, 4),
              stage_wait_s=round(m.stage_wait_s, 4),
              stage_wait_max_s=round(m.stage_wait_max_s, 4),
              h2d_mb=round(m.h2d_bytes / 1e6, 1),
              readback_s=round(m.readback_s, 4),
              mp_per_sec=round(m.mp_per_sec, 1))
    progress("composite", 1.0)
    return out, m
