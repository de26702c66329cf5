"""Kernel #4's module on the CPU: the staged-band resample
(``ops/staged_resize.py``) and its profiler (``tools/profile_bf16_stage``).

The plain version is held to the JAX package's Pallas kernel in interpret
mode on config 5's slot 0 (the slot ``benchmarks/profile_bf16_stage.py``
times) and at a quarter of its size, within 1 uint8 step: the JAX kernel
contracts f32 banded matmuls where the port gathers, so a sum within f32
rounding of a .5 boundary may land one step apart.  Against the port's own
resample (kernel #1's plain version) it is exact: the same sums in the same
order.  The band schedule is checked tap by tap: every clamped tap of every
tile lies in its band.  The kernel itself runs only on a card
(``tests/test_torch_kernel.py``); here the wrapper takes its plain version
because the tensors lie on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.ops import pallas_resize
from imagestitching_tpu_torch.config import StitchOptions
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import cuda_resize, staged_resize, \
    torch_compose
from imagestitching_tpu_torch.tools import profile_bf16_stage

_CONFIG5 = profile_bf16_stage.CONFIG5
_OPTS5 = dict(mode="min", gap=4)

# (shapes (raw w, raw h, orientation), options, channels): resampled slot 0
_CASES = {
    "slot0": ([(w, h, 1) for w, h in _CONFIG5], _OPTS5, 3),
    "slot0-quarter": ([(w // 4, h // 4, 1) for w, h in _CONFIG5], _OPTS5, 3),
    "upscale-odd": ([(333, 217, 1), (700, 520, 1)],
                    dict(mode="max", gap=2.5), 3),
    "gray-odd": ([(333, 217, 6), (400, 300, 1)], dict(mode="max", gap=2.5),
                 1),
    "rotated-down": ([(900, 700, 6), (300, 200, 1)],
                     dict(direction="horizontal", gap=4), 3),
    "triangle-down": ([(900, 700, 3), (300, 200, 1)],
                      dict(direction="horizontal", filter="triangle"), 3),
    "lanczos3-odd": ([(1001, 563, 8), (400, 300, 1)],
                     dict(mode="min", filter="lanczos3"), 3),
    "bilinear-12x": ([(2400, 1800, 6), (150, 200, 1)], dict(mode="min"), 3),
}


def _job(name):
    """(port plan, JAX plan, slot 0, its raw source, its oriented source)."""
    shapes, kw, c = _CASES[name]
    opts = StitchOptions(supersample=False, max_images=None, **kw)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    jplan = jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(**dataclasses.asdict(opts)))
    p = plan.placements[0]
    assert geometry.placement_copy_offsets(p, plan.filter) is None, name
    rng = np.random.default_rng(sum(map(ord, name)))
    raw = rng.integers(0, 256, (p.raw_h, p.raw_w, c), np.uint8)
    oriented = torch_compose.orient(torch.from_numpy(raw),
                                    p.orientation).contiguous()
    return plan, jplan, p, raw, oriented


def _taps(p, kind):
    t = torch_compose.placement_taps(p, kind)
    return tuple(torch.from_numpy(a) for a in (
        t["rows"]["i0"], t["rows"]["w"], t["cols"]["i0"], t["cols"]["w"]))


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


@pytest.mark.parametrize("name", ["slot0", "slot0-quarter"])
def test_plain_version_matches_the_jax_kernel(name):
    """The TPU kernel's function on its own ``_Schedule``, in interpret
    mode, as ``tests/test_torch_resize.py`` runs it."""
    plan, jplan, p, raw, oriented = _job(name)
    jp = jplan.placements[0]
    s = pallas_resize._Schedule(jp, jplan.filter)
    src = pallas_resize._orient_chw(jnp.asarray(raw), jp.orientation,
                                    s.m_h_pad, s.m_w_pad)
    region, (_, _, nr, nc) = pallas_resize.resize_place_one(
        src, jp, jplan.filter, interpret=True)
    want = np.asarray(region)[:, :nr, :nc].transpose(1, 2, 0)
    got = staged_resize.resize_place_staged_ref(
        staged_resize.stage_source(oriented), *_taps(p, plan.filter))
    assert _maxdiff(got.numpy(), want) <= 1


@pytest.mark.parametrize("name", sorted(_CASES))
def test_plain_version_equals_kernel1_plain_version(name):
    plan, _, p, raw, oriented = _job(name)
    taps = _taps(p, plan.filter)
    want = cuda_resize.resize_place_ref(torch.from_numpy(raw), p.orientation,
                                        *taps)
    got = staged_resize.resize_place_staged_ref(
        staged_resize.stage_source(oriented), *taps)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_uint8_and_bf16_band_sources_agree(name):
    plan, _, p, _, oriented = _job(name)
    taps = _taps(p, plan.filter)
    u8, bf = (staged_resize.resize_place_staged_ref(
        staged_resize.stage_source(oriented, dt), *taps)
        for dt in (torch.uint8, torch.bfloat16))
    assert torch.equal(u8, bf)


def _check_bands(ri0, ci0, k_rows, k_cols, m_h, m_w, tile_r, tile_c):
    b = staged_resize.band_schedule(ri0, ci0, k_rows, k_cols, m_h, m_w,
                                    tile_r, tile_c)
    align = staged_resize.ALIGN_C
    w_pad = -(-m_w // align) * align
    assert b.row_starts.dtype == np.int32 and b.col_starts.dtype == np.int32
    assert len(b.row_starts) == -(-len(ri0) // tile_r)
    assert len(b.col_starts) == -(-len(ci0) // tile_c)
    assert b.band_w % align == 0 and (b.col_starts % align == 0).all()
    assert (b.row_starts >= 0).all() and (b.row_starts + b.band_h <= m_h).all()
    assert (b.col_starts >= 0).all() and (b.col_starts + b.band_w
                                          <= w_pad).all()
    for starts, i0, k, m, tile, band in (
            (b.row_starts, ri0, k_rows, m_h, tile_r, b.band_h),
            (b.col_starts, ci0, k_cols, m_w, tile_c, b.band_w)):
        for g, start in enumerate(starts):
            taps = np.clip(np.asarray(i0[g * tile:(g + 1) * tile])[:, None]
                           + np.arange(k)[None, :], 0, m - 1)
            assert start <= taps.min() and taps.max() < start + band, g
    return b


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("tile", [(32, 64), (7, 16), (1, 48)])
def test_every_clamped_tap_lies_in_its_band(name, tile):
    plan, _, p, _, oriented = _job(name)
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    m_h, m_w = oriented.shape[:2]
    _check_bands(ri0.numpy(), ci0.numpy(), rw.shape[1], cw.shape[1], m_h,
                 m_w, *tile)


def test_band_schedule_of_slot0():
    """Config 5's slot 0: 32x64 tiles from 60x144 bands, 18 x 16 tiles; the
    ring of three bf16 bands fits Hopper's 227 KB."""
    plan, p = profile_bf16_stage.slot0()
    assert (p.raw_w, p.raw_h, p.orientation) == (1920, 1080, 1)
    assert (p.row_span, p.col_span) == ((0, 576), (0, 1024))
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    s = staged_resize.staged_schedule(ri0, ci0, 2, 2, 1080, 1920, 3)
    assert (s.tile_r, s.tile_c, s.band_h, s.band_w) == (32, 64, 60, 144)
    assert s.grid == (18, 16) and s.row_starts.dtype == torch.int32
    assert staged_resize.smem_bytes(32, 64, 60, 144, 3, 2) \
        <= staged_resize.SMEM_CAP
    _check_bands(ri0.numpy(), ci0.numpy(), 2, 2, 1080, 1920, 32, 64)


def test_band_schedule_raises_when_a_band_misses_its_taps(monkeypatch):
    """The guard behind the kernel's unchecked taps: a band sized one
    alignment short (a rounding down) leaves a tile's taps outside."""
    ri0 = np.arange(3, 67, 2, dtype=np.int32)     # starts off the 16s
    staged_resize.band_schedule(ri0, ri0, 2, 2, 80, 80, 8, 8)
    monkeypatch.setattr(staged_resize, "_round_up", lambda v, m: v // m * m)
    with pytest.raises(ValueError, match="does not cover"):
        staged_resize.band_schedule(ri0, ri0, 2, 2, 80, 80, 8, 8)
    with pytest.raises(ValueError):
        staged_resize.band_schedule(ri0, ri0, 2, 2, 80, 80, 0, 8)


def test_schedule_refuses_what_no_tile_fits():
    """lanczos3 at a 16x downscale (K = 97): three bf16 bands of even a
    1 x 16 tile exceed 227 KB."""
    plan = solve([ImageSpec(2400, 1800), ImageSpec(150, 100)],
                 StitchOptions(mode="min", filter="lanczos3",
                               supersample=False))
    p = plan.placements[0]
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    assert rw.shape[1] > 64
    with pytest.raises(ValueError, match="shared memory"):
        staged_resize.staged_schedule(ri0, ci0, rw.shape[1], cw.shape[1],
                                      1800, 2400, 3)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
@pytest.mark.parametrize("w", [333, 1920, 1])
def test_stage_source_pads_rows_to_16_bytes(dtype, w):
    src = torch.from_numpy(np.random.default_rng(w).integers(
        0, 256, (5, w, 3), np.uint8))
    band = staged_resize.stage_source(src, dtype)
    assert band.shape == src.shape and band.dtype == dtype
    w_pad = -(-w // 16) * 16
    assert band.stride() == (w_pad * 3, 3, 1)
    assert (band.stride(0) * band.element_size()) % 16 == 0
    assert torch.equal(band.to(torch.int32), src.to(torch.int32))
    full = band.as_strided((5, w_pad, 3), band.stride())
    assert not full[:, w:].any()


@pytest.mark.parametrize("name", ["slot0-quarter", "gray-odd",
                                  "triangle-down"])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_wrapper_on_cpu_places_the_plain_version(name, dtype):
    plan, _, p, _, oriented = _job(name)
    taps = _taps(p, plan.filter)
    band = staged_resize.stage_source(oriented, dtype)
    n_rows, n_cols = len(taps[0]), len(taps[2])
    c = oriented.shape[2]
    rng = np.random.default_rng(3)
    canvas = torch.from_numpy(rng.integers(0, 256, (n_rows + 5, n_cols + 7, c),
                                           np.uint8))
    before = canvas.clone()
    launches = staged_resize.staged_launches
    staged_resize.resize_place_staged(band, *taps, canvas, 3, 5)
    assert staged_resize.staged_launches == launches
    want = before.clone()
    want[3:3 + n_rows, 5:5 + n_cols] = staged_resize.resize_place_staged_ref(
        band, *taps)
    assert torch.equal(canvas, want)


def _slot(name="slot0-quarter"):
    plan, _, p, _, oriented = _job(name)
    taps = _taps(p, plan.filter)
    canvas = torch.zeros((len(taps[0]), len(taps[2]), 3), dtype=torch.uint8)
    return oriented, taps, canvas


@pytest.mark.parametrize("bad", [
    "float32", "int16", "canvas-dtype", "gray-canvas", "odd-pitch",
    "strided-cols", "short-storage", "region-right", "region-below",
    "negative-r0", "other-schedule", "negative-ctas", "2d"])
def test_wrapper_rejects(bad):
    oriented, taps, canvas = _slot()
    band = staged_resize.stage_source(oriented)
    r0 = c0 = 0
    kw = {}
    if bad == "float32":
        band = band.float()
    elif bad == "int16":
        band = band.to(torch.int16)
    elif bad == "canvas-dtype":
        canvas = canvas.float()
    elif bad == "gray-canvas":
        canvas = canvas[..., :1].contiguous()
    elif bad == "odd-pitch":          # 270 rows of 480 + 1 pixels
        band = torch.zeros((oriented.shape[0], oriented.shape[1] + 1, 3),
                           dtype=torch.uint8)[:, :oriented.shape[1]]
    elif bad == "strided-cols":
        band = staged_resize.stage_source(
            torch.cat([oriented, oriented], 1))[:, ::2]
    elif bad == "short-storage":      # pitch fine, last row's pad missing
        h, w, c = oriented.shape
        flat = torch.zeros(((h - 1) * w * c + (w - 15) * c,),
                           dtype=torch.uint8)
        band = flat.as_strided((h, w - 15, c), (w * c, c, 1))
    elif bad == "region-right":
        c0 = 1
    elif bad == "region-below":
        r0 = 1
    elif bad == "negative-r0":
        r0 = -1
    elif bad == "other-schedule":
        kw["schedule"] = staged_resize.staged_schedule(
            taps[0][:-1], taps[2], 2, 2, *oriented.shape)
    elif bad == "negative-ctas":
        kw["ctas"] = -1
    else:
        band = band[..., 0]
    with pytest.raises(ValueError):
        staged_resize.resize_place_staged(band, *taps, canvas, r0, c0, **kw)


def test_wrapper_takes_a_dense_source_with_a_16_byte_pitch():
    """A contiguous source whose width is a multiple of 16 pixels is its own
    band source: no copy needed."""
    oriented, taps, canvas = _slot()
    assert oriented.shape[1] % 16 == 0 and oriented.is_contiguous()
    staged_resize.resize_place_staged(oriented, *taps, canvas, 0, 0)
    assert torch.equal(canvas, staged_resize.resize_place_staged_ref(
        oriented, *taps))


def test_profiler_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the profiler would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_bf16_stage.main(["--reps", "1"])
