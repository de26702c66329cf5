"""The port's resize-and-place (plain version, on the CPU) against the JAX
package: the Pallas kernel in interpret mode, the XLA engine and the oracle.

Every case feeds the same numpy inputs (``default_rng``) to both packages,
each on its own plan of the job (the port's layout types and the JAX
package's, solved from the same specs and options).
Tolerance: 1 uint8 step.  The JAX kernel contracts f32 banded matmuls in
interpret mode (pallas_resize.py:504-527) where the port gathers, and the
oracle sums in float64, so a sum that lands within float32 rounding of a .5
boundary may quantize one step apart.  Identity copies are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import geometry as jax_geometry
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.ops import pallas_resize, xla_compose
from imagestitching_tpu_torch.config import CanvasLimits, StitchOptions
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import _build, cuda_resize, torch_compose
from imagestitching_tpu_torch.ops.window import WindowPlan

_CASES = {
    "bilinear-down": ([(64, 48, 1), (40, 30, 1)], dict(mode="min"), None),
    "bilinear-up": ([(24, 18, 1), (50, 40, 1)], dict(mode="max"), None),
    "fractional": ([(80, 72, 1), (64, 80, 1)],
                   dict(direction="horizontal", gap=9),
                   CanvasLimits(max_side=60, max_pixels=10 ** 9,
                                max_supersample=1.0)),
    **{f"orient{o}": ([(37, 23, o), (45, 29, 1)], dict(mode="max", gap=2.5),
                      None) for o in range(1, 9)},
    **{f"{k}-down": ([(90, 70, 6), (30, 20, 1)],
                     dict(direction="horizontal", filter=k), None)
       for k in ("triangle", "box", "lanczos3")},
    "gray": ([(50, 40, 1), (30, 35, 8)], dict(direction="horizontal"), None),
}


def _jax_plan(shapes, opts, limits=None):
    """The JAX package's plan of the same job, from its own types."""
    return jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(**dataclasses.asdict(opts)),
        None if limits is None
        else jax_config.CanvasLimits(**dataclasses.asdict(limits)))


def _job(name):
    """(port plan, JAX plan, images) of one named case."""
    shapes, kw, limits = _CASES[name]
    opts = StitchOptions(supersample=False, **kw)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts, limits)
    rng = np.random.default_rng(sum(map(ord, name)))
    c = 1 if name == "gray" else 3
    imgs = [rng.integers(0, 256, (h, w, c), np.uint8) for w, h, _ in shapes]
    return plan, _jax_plan(shapes, opts, limits), imgs


def _port_region(raw, p, kind):
    t = torch_compose.placement_taps(p, kind)
    return cuda_resize.resize_place_ref(
        torch.from_numpy(raw), p.orientation,
        *(torch.from_numpy(a) for a in (t["rows"]["i0"], t["rows"]["w"],
                                        t["cols"]["i0"], t["cols"]["w"]))
    ).numpy()


def _pallas_region(raw, p, kind):
    s = pallas_resize._Schedule(p, kind)
    src = pallas_resize._orient_chw(jnp.asarray(raw), p.orientation,
                                    s.m_h_pad, s.m_w_pad)
    region, (_, _, nr, nc) = pallas_resize.resize_place_one(
        src, p, kind, interpret=True)
    return np.asarray(region)[:, :nr, :nc].transpose(1, 2, 0)


def _xla_region(raw, p, kind):
    prm = xla_compose.placement_params(p, kind)
    img = xla_compose.orient_jnp(jnp.asarray(raw), p.orientation)
    img = img.astype(jnp.float32)
    img = xla_compose.ktap_axis(img, prm["rows"]["i0"], prm["rows"]["w"], 0)
    img = xla_compose.ktap_axis(img, prm["cols"]["i0"], prm["cols"]["w"], 1)
    return np.asarray(xla_compose.to_uint8(img))


def _oracle_region(raw, p, kind):
    oriented = jax_geometry.orient_array(raw, p.orientation)
    rows = oracle.resample_axis(oriented, 0, *p.row_span, p.y0, p.h, kind)
    return oracle.to_uint8(
        oracle.resample_axis(rows, 1, *p.col_span, p.x0, p.w, kind))


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.mark.parametrize("name", sorted(_CASES))
def test_plain_resize_place_matches_jax_and_oracle(name):
    plan, jplan, imgs = _job(name)
    checked = 0
    for raw, p, jp in zip(imgs, plan.placements, jplan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        got = _port_region(raw, p, plan.filter)
        for ref in (_pallas_region, _xla_region, _oracle_region):
            d = _maxdiff(got, ref(raw, jp, jplan.filter))
            assert d <= 1, f"{name} #{p.index} vs {ref.__name__}: {d}"
        checked += 1
    assert checked, f"{name}: no resampled placement"


def test_identity_placement_is_exact():
    rng = np.random.default_rng(5)
    plan = solve([ImageSpec(32, 16, 3), ImageSpec(32, 24, 2)],
                 StitchOptions(supersample=False))
    for p in plan.placements:
        sr, sc = geometry.placement_copy_offsets(p, plan.filter)
        raw = rng.integers(0, 256, (p.raw_h, p.raw_w, 3), np.uint8)
        nr = p.row_span[1] - p.row_span[0]
        nc = p.col_span[1] - p.col_span[0]
        want = jax_geometry.orient_array(raw, p.orientation)[sr:sr + nr,
                                                             sc:sc + nc]
        np.testing.assert_array_equal(_port_region(raw, p, plan.filter), want)


def test_exact_halves_round_half_up():
    """A 2x bilinear downscale weighs every tap 0.5, so each sum is exact in
    f32 and many land on .5, where half-up (the contract) and torch.round
    (half to even) part ways.  Held exactly, not within 1."""
    rng = np.random.default_rng(2)
    plan = solve([ImageSpec(40, 20), ImageSpec(10, 10)],
                 StitchOptions(direction="horizontal", supersample=False))
    p = plan.placements[0]
    assert (p.row_span, p.col_span) == ((0, 10), (0, 20))
    raw = rng.integers(0, 256, (20, 40, 3), np.uint8)
    rows = oracle.resample_axis(raw, 0, *p.row_span, p.y0, p.h)
    full = oracle.resample_axis(rows, 1, *p.col_span, p.x0, p.w)
    assert np.count_nonzero(full % 1 == 0.5) > 100
    np.testing.assert_array_equal(_port_region(raw, p, plan.filter),
                                  oracle.to_uint8(full))


@pytest.mark.parametrize("kind", ["bilinear", "triangle", "box", "lanczos3"])
def test_placement_taps_equal_xla_params(kind):
    """The state the port carries across from the JAX package: the same f32
    taps, element for element, from the same f64 ``filter_taps``."""
    shapes = _CASES["triangle-down"][0]
    opts = StitchOptions(direction="horizontal", gap=3.5, filter=kind)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    for p, jp in zip(plan.placements,
                     _jax_plan(shapes, opts).placements):
        got = torch_compose.placement_taps(p, kind)
        want = xla_compose.placement_params(jp, kind)
        for axis in ("rows", "cols"):
            for f in ("i0", "w"):
                a, b = got[axis][f], want[axis][f]
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


def _cpu_operands(c=3):
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 256, (20, 30, c), np.uint8))
    ri0, rw = geometry.filter_taps(0, 10, 0.0, 10.0, 20)
    ci0, cw = geometry.filter_taps(0, 12, 0.0, 12.0, 30)
    taps = [torch.from_numpy(ri0), torch.from_numpy(rw.astype(np.float32)),
            torch.from_numpy(ci0), torch.from_numpy(cw.astype(np.float32))]
    return src, taps, torch.zeros((16, 20, c), dtype=torch.uint8)


def test_wrapper_on_cpu_runs_plain_version_without_launching():
    src, taps, canvas = _cpu_operands()
    before = cuda_resize.launches
    cuda_resize.resize_place(src, 6, *taps, canvas, 3, 5)
    assert cuda_resize.launches == before
    want = cuda_resize.resize_place_ref(src, 6, *taps)
    assert torch.equal(canvas[3:13, 5:17], want)
    assert int(canvas[:3].sum()) == 0 and int(canvas[:, :5].sum()) == 0


@pytest.mark.parametrize("bad", ["float-src", "int64-taps", "off-canvas",
                                 "channels", "meta-device", "orientation"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src, taps, canvas = _cpu_operands()
    r0, c0, o = 0, 0, 1
    if bad == "float-src":
        src = src.float()
    elif bad == "int64-taps":
        taps[0] = taps[0].long()
    elif bad == "off-canvas":
        r0 = 7
    elif bad == "channels":
        canvas = torch.zeros((16, 20, 1), dtype=torch.uint8)
    elif bad == "meta-device":
        src, canvas = src.to("meta"), canvas.to("meta")
        taps = [t.to("meta") for t in taps]
    else:
        o = 9
    with pytest.raises(ValueError):
        cuda_resize.resize_place(src, o, *taps, canvas, r0, c0)


def test_window_wrapper_on_cpu_runs_plain_version_without_launching():
    """Kernel #3's wrapper on CPU tensors: the plain version into the top
    rows of the region buffer, nothing else touched, no launch counted."""
    crop, taps, _ = _cpu_operands()
    region = torch.zeros((16, 12, 3), dtype=torch.uint8)
    before = cuda_resize.window_launches
    cuda_resize.resize_place_window(crop, *taps, region)
    assert cuda_resize.window_launches == before
    want = cuda_resize.resize_place_window_ref(crop, *taps)
    assert torch.equal(want, cuda_resize.resize_place_ref(crop, 1, *taps))
    assert torch.equal(region[:10], want) and int(region[10:].sum()) == 0


@pytest.mark.parametrize("bad", ["region-width", "region-rows", "float-crop",
                                 "region-2d"])
def test_window_wrapper_rejects_what_the_kernel_does_not_take(bad):
    crop, taps, _ = _cpu_operands()
    region = torch.zeros((16, 12, 3), dtype=torch.uint8)
    if bad == "region-width":
        region = torch.zeros((16, 13, 3), dtype=torch.uint8)
    elif bad == "region-rows":
        region = torch.zeros((9, 12, 3), dtype=torch.uint8)
    elif bad == "float-crop":
        crop = crop.float()
    else:
        region = torch.zeros((16, 12), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_resize.resize_place_window(crop, *taps, region)


def test_kernel_build_flags_and_missing_nvcc(monkeypatch):
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert [s.name for s in _build.sources()] == ["resize_place.cu",
                                                  "resize_place_staged.cu"]
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _window_job(kind="bilinear", chunk=8):
    """A placement of a downscaled, rotated source and its WindowPlan."""
    plan = solve([ImageSpec(120, 90, 6), ImageSpec(40, 30, 1)],
                 StitchOptions(mode="min", supersample=False, filter=kind))
    p = plan.placements[0]
    raw = np.random.default_rng(17).integers(0, 256, (p.raw_h, p.raw_w, 3),
                                             np.uint8)
    return p, geometry.orient_array(raw, p.orientation), \
        WindowPlan(p, plan.filter, chunk)


@pytest.mark.parametrize("kind,chunk", [("bilinear", 8), ("lanczos3", 8),
                                        ("box", 16), ("triangle", 5)])
def test_window_launcher_on_cpu_equals_rebased_taps(kind, chunk):
    """The banded rung's form of kernel #3 -- the placement's taps once, per
    chunk its first tap row and crop start -- gives each chunk the region
    its rebased taps give, rows past the chunk untouched, no launch
    counted (the plain version on the CPU)."""
    p, oriented, wp = _window_job(kind, chunk)
    assert wp.n_chunks > 2
    taps = [torch.from_numpy(a) for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
    region = torch.zeros((wp.chunk, wp.n_cols, 3), dtype=torch.uint8)
    launch = cuda_resize.WindowLauncher(*taps, region,
                                        (wp.crop_rows, wp.disp_w, 3))
    before = cuda_resize.window_launches
    shifted = 0
    for g in range(wp.n_chunks):
        a, valid, s_lo = wp.chunk_window(g)
        crop = torch.from_numpy(wp.stage_crop(oriented, g))
        region.fill_(7)
        launch(crop, a, s_lo, valid)
        want = cuda_resize.resize_place_window_ref(
            crop, *map(torch.from_numpy, wp.chunk_taps(g)), *taps[2:])
        assert torch.equal(region[:valid], want), g
        assert bool((region[valid:] == 7).all())
        assert torch.equal(want, cuda_resize.resize_place_window_ref(
            crop, *taps, a, s_lo, valid))
        shifted += s_lo > 0
    assert shifted and cuda_resize.window_launches == before


@pytest.mark.parametrize("bad", ["crop-shape", "crop-dtype", "rows-past",
                                 "region-short", "crop-shape-ctor"])
def test_window_launcher_rejects_what_the_kernel_does_not_take(bad):
    _, oriented, wp = _window_job()
    taps = [torch.from_numpy(a) for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
    region = torch.zeros((wp.chunk, wp.n_cols, 3), dtype=torch.uint8)
    shape = (wp.crop_rows, wp.disp_w, 3)
    if bad == "crop-shape-ctor":
        with pytest.raises(ValueError):
            cuda_resize.WindowLauncher(*taps, region, shape[:2] + (1,))
        return
    launch = cuda_resize.WindowLauncher(*taps, region, shape)
    crop = torch.from_numpy(wp.stage_crop(oriented, 0))
    a, valid, s_lo = wp.chunk_window(0)
    if bad == "crop-shape":
        crop = crop[1:].contiguous()
    elif bad == "crop-dtype":
        crop = crop.float()
    elif bad == "rows-past":
        a = wp.n_rows - 1
    else:
        valid = wp.chunk + 1
    with pytest.raises(ValueError):
        launch(crop, a, s_lo, valid)
