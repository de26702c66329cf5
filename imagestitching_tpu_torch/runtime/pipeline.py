"""The stitch pipeline of the port: budget plan -> composite -> readback.

Port of ``imagestitching_tpu/runtime/pipeline.py``: ``StitchMetrics``
(:45-88), the device-free host-blit path ``_host_blit`` (:917-939), the front
door ``run`` (:851-915), the resident rung of ``_run_body`` (:1009-1021),
the OOM classifier ``_is_oom`` (:773-787) and the engine choice that
replaces ``_kernel_backend_ok`` / ``_pallas_ok`` (:827-848).

The shared ``tiler.plan_execution`` picks the strategy.  This slice runs the
resident strategy; a plan that needs the streamed or banded strategy raises
``NotImplementedError`` until the slice that ports them lands.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from imagestitching_tpu.core import geometry, oracle
from imagestitching_tpu.core.layout import LayoutPlan
from imagestitching_tpu.runtime import tiler
from imagestitching_tpu.runtime.logger import get_logger

from ..config import RuntimeConfig

ProgressFn = Callable[[str, float], None]


@dataclasses.dataclass
class StitchMetrics:
    """Per-phase wall clock + throughput for one job (the JAX package's
    field set; ``transport_rtt_s`` and ``stage_wait_*`` belong to the
    overlapped path and stay 0 until it lands)."""

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


def _resident(plan: LayoutPlan, images: Sequence[np.ndarray],
              engine: str, device: torch.device) -> torch.Tensor:
    """The resident strategy: every source and the canvas on ``device``;
    ``torch`` is the plain cross-check engine, ``auto``/``cuda`` the kernel."""
    from ..ops import cuda_resize
    return cuda_resize.stitch(plan, images, device, plain=engine == "torch")


def run(plan: LayoutPlan, images: Sequence[np.ndarray],
        config: Optional[RuntimeConfig] = None,
        progress: ProgressFn = _noop,
        keep_on_device: bool = False,
        ) -> Tuple[Union[np.ndarray, torch.Tensor], StitchMetrics]:
    """Execute one solved stitch job.

    Returns ``(canvas, metrics)``: a uint8 HWC numpy array, or with
    ``keep_on_device=True`` the canvas tensor on the configured device
    (the host-compositing oracle engine returns numpy either way).
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
    if ex.strategy != "resident":
        raise NotImplementedError(
            f"the budget calls for the {ex.strategy!r} strategy, which the "
            "port runs from its streamed/banded slice on; raise "
            "MemoryBudget.hbm_bytes to run resident")
    progress("layout", 1.0)

    t0 = time.perf_counter()
    try:
        out = _resident(plan, images, config.engine, device)
        if device.type == "cuda":
            # work is enqueued asynchronously: wait here so an OOM or a
            # kernel fault surfaces inside this rung, not at the caller's
            # first use of the canvas
            torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 — OOM classification
        if not _is_oom(e):
            raise
        log.event("pipeline.oom_retry", failed="resident", band=None)
        raise MemoryError(
            "stitch ran out of device memory on the resident strategy (the "
            "streamed and banded rungs arrive with a later slice)") from e
    m.strategy = "resident"
    m.compute_s = time.perf_counter() - t0
    if device.type == "cuda":
        m.h2d_bytes = sum(np.asarray(a).nbytes for a in images)
    if not keep_on_device:
        t1 = time.perf_counter()
        out = out.cpu().numpy()
        m.readback_s = time.perf_counter() - t1
    m.total_s = time.perf_counter() - t_start
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
