"""The stitch pipeline of the port: budget plan -> composite -> readback.

Port of ``imagestitching_tpu/runtime/pipeline.py``: ``StitchMetrics``
(:45-88), the streamed strategy (``_fence_limit`` :205-219, ``_run_streamed``
:222-254), the banded strategy (``_BandedExecutor`` :261-404,
``_run_banded_pallas`` :407-466, ``_run_banded`` :469-485), the OOM
classifier ``_is_oom`` (:773-787), the demotion ladder (``_banded_bands``
:790-804, ``_strategy_ladder`` :807-824), the front door ``run`` (:851-915)
with the single-device ladder of ``_run_body`` (:1009-1055), and the
device-free host-blit path ``_host_blit`` (:917-939).

The tiler's ``plan_execution`` picks the first rung from the memory
budget: ``resident`` (every source and the canvas on the device), then
``streamed`` (the canvas and one or two sources), then ``banded`` (the canvas
on the host, the device holding one source window and one region at a
time).  A rung that runs out of device memory hands the job to the next one.
The engine (``auto``/``cuda``: the kernels; ``torch``: the plain version)
is the same on every rung; nothing demotes from one engine to the other.
"""

from __future__ import annotations

import dataclasses
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
    field set; ``transport_rtt_s`` and ``stage_wait_*`` belong to the
    overlapped path and stay 0 until it lands).  ``h2d_bytes`` counts what
    the winning rung staged onto the job's device: the sources on the
    resident and streamed rungs, the source windows on the banded one."""

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
    strategy and the host engines return numpy either way.
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
    # canvas is sources + background and no device is touched.
    if config.engine == "auto" and not keep_on_device and channels == 3:
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
    for strategy, band in _strategy_ladder(ex, plan):
        try:
            out, m.h2d_bytes = _run_rung(strategy, band, plan, images,
                                         channels, config, device, progress)
        except Exception as e:  # noqa: BLE001 — OOM classification
            if not _is_oom(e):
                raise
            # The traceback holds the failed rung's frames and with them its
            # sources and canvas: drop them before the next rung allocates.
            traceback.clear_frames(e.__traceback__)
            last_oom = e
            log.event("pipeline.oom_retry", failed=strategy, band=band)
            continue
        m.strategy = strategy
        break
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
