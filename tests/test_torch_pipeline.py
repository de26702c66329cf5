"""The port's slice end to end on the CPU: ``stitch_arrays`` -> ``solve`` ->
``pipeline.run`` -> strategy -> resize-and-place -> uint8 canvas,
against the JAX package's ``stitch_arrays`` (Pallas kernel in interpret
mode) and the float64 oracle.

Same numpy inputs to both packages (``default_rng``); the port's side
runs on the port's own layout types, the reference side on the JAX
package's.  Tolerance: 1 uint8
step (f32 sums against f64, and the JAX kernel's matmul order against the
port's gathers); the golden fixture is held to 1 step as in
tests/test_golden.py:38-44; host-blit jobs are bit-exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.config import RuntimeConfig as JaxRuntimeConfig
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.runtime import pipeline as jax_pipeline
from imagestitching_tpu_torch import (MemoryBudget, RuntimeConfig,
                                      StitchOptions, api)
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.imgio import codec
from imagestitching_tpu_torch.runtime import pipeline, tiler
from imagestitching_tpu_torch.runtime.logger import StitchLogger, set_logger

CPU = RuntimeConfig(device="cpu")
_GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_v1.npz")
_GOLDEN_SHAPES = [(40, 30, 1), (24, 36, 6), (32, 32, 3), (28, 44, 8)]
# BASELINE config 3 (benchmarks/run_all.py:97-99) at 1/8 of its sides,
# with its orientations
_CONFIG3_8 = [(240, 135, 1), (135, 240, 6), (180, 135, 3), (160, 120, 8),
              (250, 187, 1), (135, 135, 5), (200, 150, 2), (150, 200, 7),
              (240, 180, 4)]


def _job(name):
    """(images, specs, options) of one named job."""
    rng = np.random.default_rng(sum(map(ord, name)))

    def rand(w, h, c=3):
        return rng.integers(0, 256, (h, w, c), np.uint8)

    if name == "golden":
        z = np.load(_GOLDEN)
        imgs = [z[f"img{i}"] for i in range(len(_GOLDEN_SHAPES))]
        return imgs, _GOLDEN_SHAPES, StitchOptions(
            direction="horizontal", mode="min", gap=3.5, supersample=False,
            background=(250, 128, 7))
    if name == "config3-small":
        return ([rand(w, h) for w, h, _ in _CONFIG3_8], _CONFIG3_8,
                StitchOptions(direction="horizontal", mode="min", gap=4,
                              max_images=None))
    if name == "gray":
        shapes = [(60, 40, 1), (45, 50, 6), (30, 30, 1)]
        return [rand(w, h, 1) for w, h, _ in shapes], shapes, \
            StitchOptions(gap=2)
    if name == "mixed-gray-rgb":
        shapes = [(60, 40, 1), (45, 50, 3), (30, 30, 1)]
        return [rand(w, h, 1 if i != 1 else 3)
                for i, (w, h, _) in enumerate(shapes)], shapes, \
            StitchOptions(direction="horizontal", mode="max", gap=1.5,
                          background=(10, 200, 30))
    assert name == "host-blit"
    shapes = [(48, 32, 1), (48, 20, 3), (48, 28, 1)]
    return [rand(w, h) for w, h, _ in shapes], shapes, StitchOptions(gap=3)


def _specs(shapes):
    return [ImageSpec(w, h, o) for w, h, o in shapes]


def _jax_specs(shapes):
    return [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes]


def _jax_opts(opts):
    """The port's options as the JAX package's type, for its calls."""
    return jax_config.StitchOptions(**dataclasses.asdict(opts))


def _jax_plan(shapes, opts):
    return jax_layout.solve(_jax_specs(shapes), _jax_opts(opts))


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _oracle(imgs, shapes, opts):
    imgs = jax_api._unify_channels([jax_api._as_uint8(a) for a in imgs])
    return oracle.stitch(_jax_plan(shapes, opts), imgs)


@pytest.mark.parametrize("name", ["golden", "config3-small", "gray",
                                  "mixed-gray-rgb"])
def test_slice_matches_jax_pallas_and_oracle(name):
    imgs, shapes, opts = _job(name)
    got, m = api.stitch_arrays(imgs, _specs(shapes), opts, CPU,
                               return_metrics=True)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    assert m.strategy == "resident"
    jax_out = jax_api.stitch_arrays(
        imgs, _jax_specs(shapes), _jax_opts(opts),
        JaxRuntimeConfig(engine="pallas", interpret=True))
    assert _maxdiff(got, np.asarray(jax_out)) <= 1
    assert _maxdiff(got, _oracle(imgs, shapes, opts)) <= 1
    if name == "golden":
        assert _maxdiff(got, np.load(_GOLDEN)["out"]) <= 1
    if name == "gray":
        assert got.shape[2] == 1
    if name == "mixed-gray-rgb":
        assert got.shape[2] == 3


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_host_blit_is_bit_exact_and_touches_no_device(device):
    """Equal-width identity copies take the device-free host blit, even when
    the configured device does not exist on this host."""
    imgs, shapes, opts = _job("host-blit")
    got, m = api.stitch_arrays(imgs, _specs(shapes), opts,
                               RuntimeConfig(device=device),
                               return_metrics=True)
    assert m.strategy == "host-blit"
    np.testing.assert_array_equal(got, _oracle(imgs, shapes, opts))
    jax_out, jm = jax_pipeline.run(_jax_plan(shapes, opts), imgs,
                                   JaxRuntimeConfig())
    assert jm.strategy == "host-blit"
    np.testing.assert_array_equal(got, jax_out)


@pytest.mark.parametrize("engine", ["torch", "oracle"])
def test_explicit_engines(engine):
    imgs, shapes, opts = _job("config3-small")
    auto = api.stitch_arrays(imgs, _specs(shapes), opts, CPU)
    got, m = api.stitch_arrays(imgs, _specs(shapes), opts,
                               RuntimeConfig(engine=engine, device="cpu"),
                               return_metrics=True)
    want = _oracle(imgs, shapes, opts)
    if engine == "oracle":
        assert m.strategy == "oracle"
        np.testing.assert_array_equal(got, want)
    else:
        assert m.strategy == "resident"
        # the same f32 arithmetic in the same order as the auto engine
        np.testing.assert_array_equal(got, auto)
        assert _maxdiff(got, want) <= 1


def test_keep_on_device_returns_tensor():
    imgs, shapes, opts = _job("config3-small")
    out = api.stitch_arrays(imgs, _specs(shapes), opts, CPU,
                            keep_on_device=True)
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    np.testing.assert_array_equal(
        out.numpy(), api.stitch_arrays(imgs, _specs(shapes), opts, CPU))


def test_stitch_metrics_fields_match_jax():
    names = {f.name for f in dataclasses.fields(pipeline.StitchMetrics)}
    assert names == {f.name for f in
                     dataclasses.fields(jax_pipeline.StitchMetrics)}
    m = pipeline.StitchMetrics(canvas_w=2000, canvas_h=500, total_s=0.5)
    assert m.out_megapixels == 1.0 and m.mp_per_sec == 2.0


@pytest.mark.parametrize("strategy", ["streamed", "banded"])
def test_budget_below_resident_runs_tiler_strategy(strategy):
    """A budget below the resident peak runs the strategy the tiler picks,
    with nothing raising NotImplementedError: the canvas equals the resident
    one bit for bit, and the JAX package's same strategy (Pallas interpret)
    and the oracle within 1 step."""
    imgs, shapes, opts = _job("config3-small")
    plan = solve(_specs(shapes), opts)
    budget = tiler.resident_peak_bytes(plan) - 1
    if strategy == "banded":
        budget = 3 * plan.canvas_w * plan.canvas_h    # the canvas alone
    budget = MemoryBudget(hbm_bytes=budget)
    assert tiler.plan_execution(plan, budget).strategy == strategy
    got, m = api.stitch_arrays(imgs, _specs(shapes), opts,
                               RuntimeConfig(device="cpu", budget=budget),
                               return_metrics=True)
    assert m.strategy == strategy
    np.testing.assert_array_equal(
        got, api.stitch_arrays(imgs, _specs(shapes), opts, CPU))
    jax_out, jm = jax_pipeline.run(_jax_plan(shapes, opts), imgs,
                                   JaxRuntimeConfig(
        engine="pallas", interpret=True,
        budget=jax_config.MemoryBudget(hbm_bytes=budget.hbm_bytes)))
    assert jm.strategy == strategy
    assert _maxdiff(got, np.asarray(jax_out)) <= 1
    assert _maxdiff(got, _oracle(imgs, shapes, opts)) <= 1


def test_stitch_items_with_orientations_and_file_round_trip(tmp_path):
    imgs, shapes, opts = _job("config3-small")
    items = [(a, o) for a, (_, _, o) in zip(imgs, shapes)]
    out, m = api.stitch(items, options=opts, config=CPU, return_metrics=True)
    np.testing.assert_array_equal(
        out, api.stitch_arrays(imgs, _specs(shapes), opts, CPU))
    assert m.prepare_s > 0 and m.total_s >= m.compute_s
    path, m = api.stitch_to_file(items, tmp_path / "out.png", options=opts,
                                 config=CPU, stream=False,
                                 return_metrics=True)
    back, orientation = codec.decode(path)
    np.testing.assert_array_equal(back, out)
    assert orientation == 1 and m.encode_s > 0


@pytest.mark.parametrize("stream", [True, "auto"])
def test_streaming_export_of_a_gray_canvas(tmp_path, stream):
    """A 1-channel canvas has no streaming encoder: ``stream=True`` raises,
    as the JAX package does, and ``"auto"`` writes the file through the
    monolithic encoder, equal to the JAX package's file."""
    imgs, shapes, opts = _job("gray")
    out = tmp_path / "out.png"
    if stream is True:
        with pytest.raises(ValueError, match="3-channel"):
            api.stitch_to_file(imgs, out, stream=True, config=CPU)
        with pytest.raises(ValueError, match="3-channel"):
            jax_api.stitch_to_file(imgs, tmp_path / "jax.png", stream=True)
        assert not out.exists()
        return
    path = api.stitch_to_file(imgs, out, stream="auto", config=CPU)
    jax_path = jax_api.stitch_to_file(imgs, tmp_path / "jax.png",
                                      stream="auto")
    got, want = codec.decode(path)[0], codec.decode(jax_path)[0]
    canvas = api.stitch(imgs, config=CPU)
    assert canvas.shape[2] == 1
    np.testing.assert_array_equal(got, np.repeat(canvas, 3, axis=2))
    assert _maxdiff(got, want) <= 1


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    imgs, shapes, opts = _job("config3-small")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.stitch_arrays(imgs, _specs(shapes), opts,
                          RuntimeConfig(device="cuda"))


@pytest.mark.parametrize("kw", [dict(engine="pallas"), dict(device="tpu"),
                                dict(engine="cuda", device="cpu"),
                                dict(decode_timeout_s=0)])
def test_runtime_config_validation(kw):
    with pytest.raises(ValueError):
        RuntimeConfig(**kw).validate()


def test_merge_overlap_not_yet_ported():
    """``merge_overlap`` in ``stitch_arrays``: a gray capture cut into three
    strips sharing 40 rows merges back to it, equal to the stitch of the
    pre-trimmed strips and to the JAX package's merge, bit for bit."""
    rng = np.random.default_rng(12)
    base = rng.integers(0, 256, (680, 96, 1), np.uint8)
    parts = [base[:250], base[210:470], base[430:]]
    got = api.stitch_arrays(parts, options=StitchOptions(merge_overlap=True),
                            config=CPU)
    want = api.stitch_arrays([parts[0], parts[1][40:], parts[2][40:]],
                             options=StitchOptions(), config=CPU)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base)
    np.testing.assert_array_equal(got, jax_api.stitch_arrays(
        parts, options=jax_config.StitchOptions(merge_overlap=True)))


def test_taps_not_shared_across_fractional_offsets():
    """Plans with the same pixel spans but another sub-pixel phase share a
    shape_signature and must not share cached taps (keyed on signature)."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, (h, 100, 3), np.uint8) for h in (50, 60)]
    shapes = [(100, 50, 1), (100, 60, 1)]
    opts = [StitchOptions(gap=g, supersample=False) for g in (0.51, 0.69)]
    pa, pb = (solve(_specs(shapes), o) for o in opts)
    assert pa.shape_signature() == pb.shape_signature()
    assert pa.signature() != pb.signature()
    for plan, o in zip((pa, pb), opts):
        out, _ = pipeline.run(plan, imgs, CPU)
        assert _maxdiff(out, oracle.stitch(_jax_plan(shapes, o), imgs)) <= 1


@pytest.mark.parametrize("exc,oom", [
    (MemoryError(), True),
    (torch.cuda.OutOfMemoryError("CUDA out of memory"), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("shape mismatch"), False),
    (ValueError("out of memory"), False),
])
def test_is_oom(exc, oom):
    assert pipeline._is_oom(exc) is oom


def test_resident_oom_surfaces_as_memory_error(monkeypatch):
    """An OOM on every rung -- resident, streamed and every banded band --
    surfaces as MemoryError, chained to the last OOM; an OOM on the
    resident rung alone demotes (tests/test_torch_recovery.py)."""
    from imagestitching_tpu_torch.ops import cuda_resize

    def exhausted(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(cuda_resize, "resize_place_ref", exhausted)
    imgs, shapes, opts = _job("config3-small")
    log = StitchLogger()
    set_logger(log)
    try:
        with pytest.raises(MemoryError, match="every strategy") as info:
            api.stitch_arrays(imgs, _specs(shapes), opts, CPU)
    finally:
        set_logger(StitchLogger())
    assert isinstance(info.value.__cause__, torch.cuda.OutOfMemoryError)
    plan = solve(_specs(shapes), opts)
    ladder = pipeline._strategy_ladder(
        tiler.plan_execution(plan, CPU.budget), plan)
    assert [(e["failed"], e["band"]) for e in log.ring()
            if e["tag"] == "pipeline.oom_retry"] == ladder
    assert [s for s, _ in ladder[:3]] == ["resident", "streamed", "banded"]
