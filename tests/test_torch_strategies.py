"""The port's streamed and banded strategies on the CPU, against the port's
resident strategy, the JAX package's same strategy and the oracle.

The scenarios are those of tests/test_tiler_pipeline.py (fence limit,
streamed, banded, upscale with orientations, progress, windowed chunks,
copy blit, wide-filter band alignment, short canvas), on the same numpy
inputs (``default_rng``) for both packages.

Tolerances:

* port streamed or banded against the port's resident canvas: bit for bit.
  Every rung runs the same f32 sums in the same order, and a source window
  clamps its taps where the whole image does (ops/window.py);
* port ``auto`` against JAX ``engine="pallas", interpret=True`` and port
  ``torch`` against JAX ``engine="xla"`` at the same budget: within 1 uint8
  step, with the same strategy on both.  The JAX kernel contracts f32
  matmuls where the port gathers, so a sum within f32 rounding of a .5
  boundary may quantize one step apart;
* everything against the float64 oracle: within 1 step; identity copies
  exact.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu.config import RuntimeConfig as JaxRuntimeConfig
from imagestitching_tpu.core import geometry, oracle
from imagestitching_tpu.core.layout import ImageSpec, solve
from imagestitching_tpu.ops import pallas_resize
from imagestitching_tpu.runtime import pipeline as jax_pipeline
from imagestitching_tpu.runtime import tiler
from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig, StitchOptions
from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.runtime import pipeline

CPU = torch.device("cpu")


def _imgs(specs, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]


def _plan(specs, **kw):
    kw.setdefault("supersample", False)
    return solve(specs, StitchOptions(**kw))


def _maxdiff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _oriented(plan, imgs):
    return [geometry.orient_array(a, p.orientation)
            for a, p in zip(imgs, plan.placements)]


def _resident(plan, imgs, engine="auto"):
    """The port's resident canvas (``keep_on_device`` keeps an all-copy
    plan off the host blit)."""
    out, m = pipeline.run(plan, imgs, RuntimeConfig(device="cpu",
                                                    engine=engine),
                          keep_on_device=True)
    assert m.strategy == "resident"
    return out.numpy()


def _budget(plan, strategy):
    """A budget under which the shared tiler picks ``strategy``."""
    canvas = 3 * plan.canvas_w * plan.canvas_h
    if strategy == "streamed":
        b = tiler.resident_peak_bytes(plan) - 1
    else:
        b = max(canvas // 2, tiler.min_feasible_bytes(plan))
    budget = MemoryBudget(hbm_bytes=b)
    assert tiler.plan_execution(plan, budget).strategy == strategy
    return budget


# (specs, options) of the tiler_pipeline scenarios (:164-214, :271-282)
_SCENARIOS = {
    "streamed-orient8": (
        [ImageSpec(200, 150), ImageSpec(150, 200, orientation=8),
         ImageSpec(180, 120)], dict(mode="min", gap=3), "streamed"),
    "streamed-pair": ([ImageSpec(200, 150), ImageSpec(150, 100)],
                      dict(mode="min"), "streamed"),
    "streamed-kernel-update": (
        [ImageSpec(80, 60), ImageSpec(50, 90, orientation=8)],
        dict(gap=2), "streamed"),
    "banded-orient3": (
        [ImageSpec(300, 400), ImageSpec(240, 360, orientation=3)],
        dict(mode="min", gap=7), "banded"),
    "banded-upscale-orientations": (
        [ImageSpec(300, 400, orientation=o) for o in (1, 5, 6, 7)],
        dict(mode="max", gap=2), "banded"),
}


@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_strategy_matches_resident_jax_and_oracle(name, engine):
    specs, kw, strategy = _SCENARIOS[name]
    imgs = _imgs(specs, sum(map(ord, name)))
    plan = _plan(specs, **kw)
    budget = _budget(plan, strategy)
    got, m = pipeline.run(plan, imgs, RuntimeConfig(
        device="cpu", engine=engine, budget=budget))
    assert m.strategy == strategy
    np.testing.assert_array_equal(got, _resident(plan, imgs, engine))
    jax_cfg = (JaxRuntimeConfig(engine="pallas", interpret=True,
                                budget=budget) if engine == "auto"
               else JaxRuntimeConfig(engine="xla", budget=budget))
    jax_out, jm = jax_pipeline.run(plan, imgs, jax_cfg)
    assert jm.strategy == strategy
    assert _maxdiff(got, jax_out) <= 1
    assert _maxdiff(got, oracle.stitch(plan, imgs)) <= 1


@pytest.mark.parametrize("strategy", ["streamed", "banded"])
def test_h2d_bytes_count_what_the_rung_uploaded(strategy):
    specs, kw, _ = _SCENARIOS["banded-orient3"]
    imgs = _imgs(specs, 3)
    plan = _plan(specs, **kw)
    budget = _budget(plan, strategy)
    _, m = pipeline.run(plan, imgs, RuntimeConfig(device="cpu",
                                                  budget=budget))
    assert m.strategy == strategy
    if strategy == "streamed":
        assert m.h2d_bytes == sum(a.nbytes for a in imgs)
    else:
        band = tiler.plan_execution(plan, budget).band_rows
        want = 0
        for img, p in zip(_oriented(plan, imgs), plan.placements):
            if geometry.placement_copy_offsets(p, plan.filter) is not None:
                continue        # a host blit
            wp = WindowPlan(p, plan.filter, band)
            want += wp.n_chunks * wp.crop_rows * img.shape[1] * 3
        assert m.h2d_bytes == want


def test_fence_limit_matches_jax():
    """tests/test_tiler_pipeline.py:119-133: the fence never exceeds the
    headroom above the canvas, is 0 at no headroom, headroom // 2 when
    plentiful; and equals the JAX package's at every budget."""
    plan = _plan([ImageSpec(1000, 1000)] * 3)
    canvas = 3 * plan.canvas_w * plan.canvas_h

    def lim(hbm, jax=False):
        b = MemoryBudget(hbm_bytes=hbm)
        if jax:
            return jax_pipeline._fence_limit(plan, 3, JaxRuntimeConfig(
                budget=b))
        return pipeline._fence_limit(plan, 3, RuntimeConfig(budget=b))

    assert lim(canvas + (6 << 20)) <= 6 << 20
    assert lim(canvas) == 0
    assert lim(canvas + (1 << 30)) == (1 << 30) // 2
    for extra in (0, 1, 5 << 20, 8 << 20, 17 << 20, 1 << 30):
        assert lim(canvas + extra) == lim(canvas + extra, jax=True)
    assert lim(canvas // 2) == 0


def test_streamed_fences_past_the_limit():
    """Zero headroom fences after every drawn source; the canvas and the
    bytes uploaded are as without a fence."""
    specs, kw, _ = _SCENARIOS["streamed-orient8"]
    imgs = _imgs(specs, 1)
    plan = _plan(specs, **kw)
    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    cfg = RuntimeConfig(device="cpu",
                        budget=MemoryBudget(hbm_bytes=canvas_bytes))
    assert pipeline._fence_limit(plan, 3, cfg) == 0
    out, uploaded = pipeline._run_streamed(plan, imgs, 3, cfg, CPU,
                                           lambda *a: None)
    np.testing.assert_array_equal(out.numpy(), _resident(plan, imgs))
    assert uploaded == sum(a.nbytes for a in imgs)


@pytest.mark.parametrize("strategy", ["streamed", "banded"])
def test_progress_phases(strategy):
    """tests/test_tiler_pipeline.py:217-227: composite progress rises and
    ends at 1.0, from 0.30 on."""
    specs = [ImageSpec(64, 64), ImageSpec(48, 64, orientation=6),
             ImageSpec(80, 40)]
    imgs = _imgs(specs, 7)
    plan = _plan(specs)
    seen = []
    _, m = pipeline.run(plan, imgs,
                        RuntimeConfig(device="cpu",
                                      budget=_budget(plan, strategy)),
                        progress=lambda ph, f: seen.append((ph, f)))
    assert m.strategy == strategy
    comp = [f for ph, f in seen if ph == "composite"]
    assert comp == sorted(comp) and comp[-1] == 1.0 and comp[0] >= 0.30
    assert ("layout", 1.0) in seen


_WINDOW_SPECS = [ImageSpec(90, 70), ImageSpec(60, 120, orientation=6),
                 ImageSpec(75, 75)]


@pytest.mark.parametrize("mode", ["min", "original"])
@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
def test_banded_kernel_windowed_chunks(direction, mode):
    """tests/test_tiler_pipeline.py:230-252: 16-row chunks, several per
    placement; bit-equal to resident, within 1 of the JAX kernel's banded
    path (interpret) and the oracle."""
    imgs = _imgs(_WINDOW_SPECS, 5)
    plan = _plan(_WINDOW_SPECS, direction=direction, mode=mode, gap=3)
    oriented = _oriented(plan, imgs)
    before = cuda_resize.window_launches
    got, uploaded = pipeline._run_banded_kernel(plan, oriented, 3, 16, CPU,
                                                lambda *a: None)
    assert cuda_resize.window_launches == before   # the plain version
    resampled = [p for p in plan.placements
                 if geometry.placement_copy_offsets(p, plan.filter) is None]
    assert (uploaded > 0) == bool(resampled)
    np.testing.assert_array_equal(got, _resident(plan, imgs))
    want = jax_pipeline._run_banded_pallas(plan, oriented, 3, band_rows=16,
                                           progress=lambda *a: None,
                                           interpret=True)
    assert _maxdiff(got, want) <= 1
    assert _maxdiff(got, oracle.stitch(plan, imgs)) <= 1


def test_banded_kernel_copy_blit():
    """tests/test_tiler_pipeline.py:255-268: identity placements are host
    blits inside the banded strategy, exact; nothing is uploaded."""
    specs = [ImageSpec(40, 30)] * 3
    imgs = _imgs(specs, 6)
    plan = _plan(specs, gap=2)
    got, uploaded = pipeline._run_banded_kernel(
        plan, _oriented(plan, imgs), 3, 8, CPU, lambda *a: None)
    np.testing.assert_array_equal(got, oracle.stitch(plan, imgs))
    assert uploaded == 0


@pytest.mark.parametrize("kind", ["lanczos3", "box", "triangle"])
def test_banded_executor_wide_filter_band_alignment(kind):
    """tests/test_tiler_pipeline.py:311-332: canvas-aligned bands over spans
    not aligned to them, with wide filters; the crop must be sized over the
    real band intersections.  Bit-equal to the plain resident engine,
    within 1 of the JAX executor and the oracle."""
    rng = np.random.default_rng(1065)
    specs = [ImageSpec(119, 50, 2), ImageSpec(52, 67, 2),
             ImageSpec(76, 73, 2), ImageSpec(97, 86, 5)]
    imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8)
            for s in specs]
    plan = _plan(specs, mode="max", gap=3, filter=kind)
    oriented = _oriented(plan, imgs)
    got, _ = pipeline._BandedExecutor(plan, 128, 3, CPU).run(oriented)
    np.testing.assert_array_equal(got, _resident(plan, imgs, "torch"))
    jax_out = jax_pipeline._BandedExecutor(plan, 128, 3).run(oriented)
    assert _maxdiff(got, jax_out) <= 1
    assert _maxdiff(got, oracle.stitch(plan, imgs)) <= 1
    # the kernel path over the same plan, chunked off the band grid
    kern, _ = pipeline._run_banded_kernel(plan, oriented, 3, 24, CPU,
                                          lambda *a: None)
    np.testing.assert_array_equal(kern, got)


@pytest.mark.parametrize("engine", ["auto", "torch"])
def test_banded_ladder_short_canvas(engine):
    """tests/test_tiler_pipeline.py:335-354: a canvas under 8 rows still
    gets a banded attempt."""
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, (6, 45, 3), np.uint8),
            rng.integers(0, 256, (39, 42, 3), np.uint8)]
    specs = [ImageSpec(45, 6, 3), ImageSpec(42, 39, 5)]
    opts = StitchOptions(direction="horizontal", mode="min", gap=2,
                         supersample=False)
    plan = solve(specs, opts)
    assert plan.canvas_h < 8
    budget = MemoryBudget(hbm_bytes=300_000)
    from imagestitching_tpu_torch import api
    out, m = api.stitch_arrays(imgs, specs, opts, RuntimeConfig(
        device="cpu", engine=engine, budget=budget), return_metrics=True)
    assert m.strategy == "banded"
    np.testing.assert_array_equal(out, _resident(plan, imgs, engine))
    jax_out, jm = jax_pipeline.run(plan, imgs, JaxRuntimeConfig(
        budget=budget, interpret=True))
    assert jm.strategy == "banded" and _maxdiff(out, jax_out) <= 1
    assert _maxdiff(out, oracle.stitch(plan, imgs)) <= 1


_WINDOW_CASES = {
    "down-16": ([ImageSpec(90, 70), ImageSpec(60, 120, 6)],
                dict(direction="horizontal", gap=3), 16),
    "up-8": ([ImageSpec(30, 20, 8), ImageSpec(90, 70)], dict(gap=1.5), 8),
    "lanczos3-24": ([ImageSpec(119, 50, 2), ImageSpec(52, 67, 2)],
                    dict(mode="max", gap=3, filter="lanczos3"), 24),
    "box-32": ([ImageSpec(200, 90, 7), ImageSpec(40, 50)],
               dict(direction="horizontal", filter="box"), 32),
    "triangle-one-chunk": ([ImageSpec(64, 48, 5), ImageSpec(30, 30)],
                           dict(mode="max", filter="triangle"), 256),
}


@pytest.mark.parametrize("name", sorted(_WINDOW_CASES))
def test_window_plan_matches_jax(name):
    """For chunk heights that are multiples of 8 and a feasible K, the
    port's WindowPlan keeps the JAX ``_WindowPlan``'s schedule exactly:
    windows, crop height, chunk windows and the valid rows of the rebased
    taps."""
    specs, kw, chunk = _WINDOW_CASES[name]
    plan = _plan(specs, **kw)
    checked = 0
    for p in plan.placements:
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        got = WindowPlan(p, plan.filter, chunk)
        want = pallas_resize._WindowPlan(p, plan.filter, 3, chunk_rows=chunk)
        assert got.windows == want.windows and got.n_chunks == want.n_chunks
        assert got.crop_rows == want.crop_rows
        for g in range(got.n_chunks):
            assert got.chunk_window(g) == want.chunk_window(g)
            _, valid, _ = got.chunk_window(g)
            i0, w = got.chunk_taps(g)
            wi0, ww = want.chunk_taps(g)
            assert i0.dtype == np.int32 and w.dtype == np.float32
            np.testing.assert_array_equal(i0, wi0[:valid, 0])
            np.testing.assert_array_equal(w, ww[:valid])
        checked += 1
    assert checked, name


@pytest.mark.parametrize("name", sorted(_WINDOW_CASES))
def test_window_chunks_equal_the_whole_placement(name):
    """Every chunk's region equals the same rows of the whole-image plain
    resample bit for bit: the crop clamps taps where the image does."""
    specs, kw, chunk = _WINDOW_CASES[name]
    plan = _plan(specs, **kw)
    imgs = _imgs(specs, 4)
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        wp = WindowPlan(p, plan.filter, chunk)
        oriented = geometry.orient_array(raw, p.orientation)
        taps = [torch.from_numpy(a) for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
        whole = cuda_resize.resize_place_ref(torch.from_numpy(raw),
                                             p.orientation, *taps)
        ci0, cw = taps[2:]
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = wp.stage_crop(oriented, g)
            assert crop.flags["C_CONTIGUOUS"]
            assert crop.shape == (wp.crop_rows, wp.disp_w, 3)
            assert 0 <= s_lo <= wp.disp_h - wp.crop_rows
            i0, w = wp.chunk_taps(g)
            region = cuda_resize.resize_place_window_ref(
                torch.from_numpy(crop), torch.from_numpy(i0),
                torch.from_numpy(w), ci0, cw)
            assert torch.equal(region, whole[a:a + valid]), (name, g)


def test_window_plan_rejects_bad_input():
    plan = _plan([ImageSpec(40, 30), ImageSpec(20, 30)])
    with pytest.raises(ValueError, match="chunk_rows"):
        WindowPlan(plan.placements[1], plan.filter, 0)
