"""The port's OOM demotion ladder on the CPU: the scenarios of
tests/test_recovery.py:23-109 in torch terms.

A rung that runs out of device memory hands the job to the next rung
(resident -> streamed -> banded with shrinking bands); any other error
propagates; ``MemoryError`` comes only when every rung ran out.  A demoted
job's canvas equals the resident canvas bit for bit (the rungs run the same
f32 sums) and the oracle within 1 uint8 step.  The port runs on its own
layout types; the JAX package's ladder and oracle on the JAX package's.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.runtime import pipeline as jax_pipeline
from imagestitching_tpu.runtime import tiler as jax_tiler
from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig, StitchOptions
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.runtime import pipeline, tiler
from imagestitching_tpu_torch.runtime.logger import StitchLogger, set_logger

CPU = RuntimeConfig(device="cpu")
_SPECS = [ImageSpec(64, 48), ImageSpec(48, 64, orientation=6),
          ImageSpec(80, 50, orientation=3)]


def _job():
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in _SPECS]
    return solve(_SPECS, StitchOptions(supersample=False)), imgs


def _oracle(imgs):
    """The JAX package's oracle on its own plan of :func:`_job`'s job."""
    specs = [jax_layout.ImageSpec(s.raw_w, s.raw_h, s.orientation)
             for s in _SPECS]
    return oracle.stitch(jax_layout.solve(
        specs, jax_config.StitchOptions(supersample=False)), imgs)


@pytest.fixture
def events():
    """The pipeline's log events of this test."""
    log = StitchLogger()
    set_logger(log)
    yield lambda tag: [e for e in log.ring() if e["tag"] == tag]
    set_logger(StitchLogger())


def _oom(*a, **k):
    raise torch.cuda.OutOfMemoryError("CUDA out of memory (synthetic)")


@pytest.mark.parametrize("strategy,band", [
    ("resident", None), ("streamed", None), ("banded", 512), ("banded", 8)])
@pytest.mark.parametrize("shape", ["tall", "short"])
def test_strategy_ladder_matches_jax(strategy, band, shape):
    shapes = ([(100, 100, 1)] if shape == "tall"
              else [(45, 6, 3), (42, 39, 5)])
    plan = solve([ImageSpec(*s) for s in shapes],
                 StitchOptions(direction="horizontal", supersample=False))
    ex = tiler.ExecutionPlan(strategy, 0, 10 ** 9, band_rows=band)
    got = pipeline._strategy_ladder(ex, plan)
    jplan = jax_layout.solve(
        [jax_layout.ImageSpec(*s) for s in shapes],
        jax_config.StitchOptions(direction="horizontal", supersample=False))
    assert got == jax_pipeline._strategy_ladder(
        jax_tiler.ExecutionPlan(strategy, 0, 10 ** 9, band_rows=band), jplan)
    names = [s for s, _ in got]
    assert names[0] == strategy and names.count("banded") >= 1
    bands = [b for s, b in got if s == "banded"]
    assert bands == sorted(bands, reverse=True)
    if strategy == "banded":
        assert "resident" not in names and "streamed" not in names


@pytest.mark.parametrize("exc,oom", [
    (RuntimeError("RESOURCE_EXHAUSTED: foo"), True),
    (RuntimeError("Allocator ran out of memory"), True),
    (RuntimeError("allocation failure (4096 bytes)"), True),
    (RuntimeError("Failed to allocate device buffer"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate"),
     True),
    (MemoryError(), True),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     False),
    (ValueError("out of memory"), False),
    (TypeError("allocation failure"), False),
])
def test_is_oom_classification(exc, oom):
    """OOMs in torch terms demote; programming errors and kernel faults
    (``cudaErrorIllegalAddress`` is sticky) never do."""
    assert pipeline._is_oom(exc) is oom


@pytest.mark.parametrize("exc", [
    RuntimeError("allocation failure: 123456789 bytes"),
    torch.cuda.OutOfMemoryError("CUDA out of memory (synthetic)")])
def test_resident_oom_demotes_to_streamed(monkeypatch, events, exc):
    """An allocation failure worded without RESOURCE_EXHAUSTED demotes as a
    torch OOM does."""
    plan, imgs = _job()
    want = pipeline.run(plan, imgs, CPU, keep_on_device=True)[0].numpy()
    calls = []

    def exhausted(*a, **k):
        calls.append(1)
        raise exc

    monkeypatch.setattr(cuda_resize, "stitch", exhausted)
    out, m = pipeline.run(plan, imgs, CPU)
    assert calls == [1] and m.strategy == "streamed"
    np.testing.assert_array_equal(out, want)
    assert int(np.abs(out.astype(int) - _oracle(imgs)).max()) <= 1
    retries = events("pipeline.oom_retry")
    assert [(e["failed"], e["band"]) for e in retries] == [("resident", None)]
    assert events("pipeline.done")[-1]["strategy"] == "streamed"


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_canvas_oom_demotes_to_banded(monkeypatch, events, engine):
    """A canvas that does not fit fails the resident and the streamed rung;
    the banded rung holds no canvas on the device and wins."""
    plan, imgs = _job()
    cfg = RuntimeConfig(device="cpu", engine=engine)
    want = pipeline.run(plan, imgs, cfg, keep_on_device=True)[0].numpy()
    monkeypatch.setattr(cuda_resize, "new_canvas", _oom)
    monkeypatch.setattr(pipeline, "new_canvas", _oom)
    out, m = pipeline.run(plan, imgs, cfg, keep_on_device=True)
    assert m.strategy == "banded" and isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, want)
    assert [e["failed"] for e in events("pipeline.oom_retry")] == [
        "resident", "streamed"]
    assert m.h2d_bytes > 0


def test_banded_oom_retries_a_smaller_band(monkeypatch, events):
    plan, imgs = _job()
    want = pipeline.run(plan, imgs, CPU, keep_on_device=True)[0].numpy()
    monkeypatch.setattr(cuda_resize, "new_canvas", _oom)
    monkeypatch.setattr(pipeline, "new_canvas", _oom)
    real = pipeline._run_banded_kernel
    tried = []

    def first_band_fails(plan, oriented, channels, band_rows, *a):
        tried.append(band_rows)
        if len(tried) == 1:
            _oom()
        return real(plan, oriented, channels, band_rows, *a)

    monkeypatch.setattr(pipeline, "_run_banded_kernel", first_band_fails)
    out, m = pipeline.run(plan, imgs, CPU)
    assert m.strategy == "banded" and tried == [tried[0], tried[0] // 4]
    np.testing.assert_array_equal(out, want)
    assert [e["band"] for e in events("pipeline.oom_retry")] == [
        None, None, tried[0]]


def test_non_oom_errors_propagate(monkeypatch, events):
    def broken(*a, **k):
        raise ValueError("genuine bug")

    monkeypatch.setattr(cuda_resize, "stitch", broken)
    plan, imgs = _job()
    with pytest.raises(ValueError, match="genuine bug"):
        pipeline.run(plan, imgs, CPU)
    assert events("pipeline.oom_retry") == []


def test_kernel_fault_is_not_retried(monkeypatch, events):
    """A kernel fault surfaces inside its rung and is raised as it is: an
    illegal address is sticky, so no later rung may run on the device."""
    def fault(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(cuda_resize, "resize_place_ref", fault)
    plan, imgs = _job()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        pipeline.run(plan, imgs, CPU)
    assert events("pipeline.oom_retry") == []


def test_failed_rung_releases_its_tensors(monkeypatch):
    """The failed rung's tensors are gone before the next rung allocates:
    the OOM's traceback no longer holds their frames."""
    plan, imgs = _job()
    held = []

    def allocates_then_fails(plan, images, device, plain=False):
        canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3),
                             dtype=torch.uint8)
        held.append(weakref.ref(canvas))
        _oom()

    real = pipeline._run_streamed
    alive = []

    def streamed(*a, **k):
        gc.disable()                  # freed by reference count, not by gc
        try:
            alive.append(held[0]() is not None)
        finally:
            gc.enable()
        return real(*a, **k)

    monkeypatch.setattr(cuda_resize, "stitch", allocates_then_fails)
    monkeypatch.setattr(pipeline, "_run_streamed", streamed)
    _, m = pipeline.run(plan, imgs, CPU)
    assert m.strategy == "streamed" and alive == [False]


@pytest.mark.parametrize("strategy", ["resident", "streamed", "banded"])
def test_keep_on_device_follows_the_rung(strategy):
    """Resident and streamed return the device tensor; banded composites on
    the host and returns numpy."""
    plan, imgs = _job()
    canvas = 3 * plan.canvas_w * plan.canvas_h
    hbm = {"resident": 10 ** 9,
           "streamed": tiler.resident_peak_bytes(plan) - 1,
           "banded": max(canvas // 2, tiler.min_feasible_bytes(plan))}
    cfg = RuntimeConfig(device="cpu",
                        budget=MemoryBudget(hbm_bytes=hbm[strategy]))
    out, m = pipeline.run(plan, imgs, cfg, keep_on_device=True)
    assert m.strategy == strategy
    host, _ = pipeline.run(plan, imgs, cfg)
    if strategy == "banded":
        assert isinstance(out, np.ndarray)
        np.testing.assert_array_equal(out, host)
    else:
        assert isinstance(out, torch.Tensor)
        np.testing.assert_array_equal(out.numpy(), host)
