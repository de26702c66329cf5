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


def _check_bands(ri0, ci0, k_rows, k_cols, m_h, m_w, tile_r, tile_c,
                 align=staged_resize.BAND_ALIGN_C):
    b = staged_resize.band_schedule(ri0, ci0, k_rows, k_cols, m_h, m_w,
                                    tile_r, tile_c, align)
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
@pytest.mark.parametrize("tile", [(32, 64), (7, 16), (1, 48), (16, 64),
                                  (2, 16)])
def test_every_clamped_tap_lies_in_its_band(name, tile):
    """Columns start at any pixel: the kernel starts a band's TMA boxes on
    the 16-byte boundary at or before it."""
    plan, _, p, _, oriented = _job(name)
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    m_h, m_w = oriented.shape[:2]
    _check_bands(ri0.numpy(), ci0.numpy(), rw.shape[1], cw.shape[1], m_h,
                 m_w, *tile)


@pytest.mark.parametrize("name", sorted(_CASES))
@pytest.mark.parametrize("tile", [(32, 64), (16, 64), (2, 16)])
def test_every_clamped_tap_lies_in_its_16_pixel_aligned_band(name, tile):
    """The first version's schedule, columns aligned to 16 pixels, as
    chip_smoke.py builds it for the previous body."""
    plan, _, p, _, oriented = _job(name)
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    m_h, m_w = oriented.shape[:2]
    _check_bands(ri0.numpy(), ci0.numpy(), rw.shape[1], cw.shape[1], m_h,
                 m_w, *tile, 16)


def _ctas_an_sm(smem):
    """CTAs of ``smem`` bytes an SM's shared memory holds."""
    return staged_resize.SM_SMEM // (smem + staged_resize.CTA_RESERVED)


def test_band_schedule_of_slot0():
    """Config 5's slot 0: 16x64 tiles from 30x120 bands (columns unaligned),
    36 x 16 = 576 tiles, the largest tile whose ring of three bf16 bands
    leaves room for two CTAs on an SM (the 32x64 tile's, from 60-row bands,
    holds one); a uint8 ring leaves room for four.  The grid the kernel
    launches is the SMs times the CTAs they hold, at most one a tile:
    on 132 SMs, 528 CTAs of uint8 bands walk 1 or 2 tiles (480 of them
    one), and 264 of bf16 bands 2 or 3."""
    plan, p = profile_bf16_stage.slot0()
    assert (p.raw_w, p.raw_h, p.orientation) == (1920, 1080, 1)
    assert (p.row_span, p.col_span) == ((0, 576), (0, 1024))
    ri0, rw, ci0, cw = _taps(p, plan.filter)
    s = staged_resize.staged_schedule(ri0, ci0, 2, 2, 1080, 1920, 3)
    assert (s.tile_r, s.tile_c, s.band_h, s.band_w) == (16, 64, 30, 120)
    assert s.grid == (36, 16) and s.row_starts.dtype == torch.int32
    tiles = s.grid[0] * s.grid[1]
    for elt, boxes, kb in ((1, (208, 192, 2, 30, 1, 6272), 46488),
                           (2, (208, 192, 4, 30, 1, 6272), 84120)):
        assert staged_resize.box_geometry(30, 120, 3 * elt) == boxes
        assert staged_resize.smem_bytes(16, 64, 30, 120, 3, elt, 2, 2) == kb
    assert _ctas_an_sm(84120) >= staged_resize.CTAS_PER_SM == 2
    assert _ctas_an_sm(46488) >= 4 and 84120 <= staged_resize.SMEM_CAP
    big = staged_resize.band_schedule(ri0.numpy(), ci0.numpy(), 2, 2, 1080,
                                      1920, 32, 64)
    assert (big.band_h, big.band_w) == (60, 120)
    big_smem = staged_resize.smem_bytes(32, 64, 60, 120, 3, 2, 2, 2)
    assert big_smem <= staged_resize.SMEM_CAP and _ctas_an_sm(big_smem) == 1
    for ctas, walks in ((132 * 4, (480, 48, 0)), (132 * 2, (0, 216, 48))):
        per_cta = [len(range(b, tiles, ctas)) for b in range(ctas)]
        assert tuple(per_cta.count(n) for n in (1, 2, 3)) == walks
    _check_bands(ri0.numpy(), ci0.numpy(), 2, 2, 1080, 1920, 16, 64)


@pytest.mark.parametrize("band_h,band_w,px,want", [
    (30, 120, 3, (208, 192, 2, 30, 1, 6272)),      # slot 0, uint8 RGB
    (30, 120, 6, (208, 192, 4, 30, 1, 6272)),      # slot 0, bf16 RGB
    (5, 16, 1, (48, 32, 1, 5, 1, 256)),            # one box
    (1, 1, 3, (48, 32, 1, 1, 1, 128)),             # one pixel
    (300, 257, 1, (160, 144, 2, 150, 2, 48000)),   # tall: two row boxes
])
def test_box_geometry(band_h, band_w, px, want):
    """Boxes are whole 16 bytes, at most 256 bytes by 256 rows, 16 bytes
    longer than their step (no pixel straddles two), together at least the
    band and the up to 15 bytes before it, each column of them 128-byte
    aligned."""
    got = staged_resize.box_geometry(band_h, band_w, px)
    assert got == want
    box_bytes, step, boxes, box_rows, row_boxes, stride = got
    assert box_bytes % 16 == 0 and box_bytes <= 256
    assert step == box_bytes - 16 and step % 16 == 0
    assert box_rows <= 256 and boxes * step >= band_w * px + 15
    assert row_boxes * box_rows >= band_h and stride % 128 == 0
    assert stride >= row_boxes * box_rows * box_bytes


def test_band_schedule_raises_when_a_band_misses_its_taps(monkeypatch):
    """The guard behind the kernel's unchecked taps: a band sized one
    alignment short (a rounding down) leaves a tile's taps outside; with
    columns aligned to 16 pixels, where the rounding is visible."""
    ri0 = np.arange(3, 67, 2, dtype=np.int32)     # starts off the 16s
    staged_resize.band_schedule(ri0, ri0, 2, 2, 80, 80, 8, 8, 16)
    monkeypatch.setattr(staged_resize, "_round_up", lambda v, m: v // m * m)
    with pytest.raises(ValueError, match="does not cover"):
        staged_resize.band_schedule(ri0, ri0, 2, 2, 80, 80, 8, 8, 16)
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


_BAD = ["float32", "int16", "canvas-dtype", "gray-canvas", "odd-pitch",
        "strided-cols", "short-storage", "region-right", "region-below",
        "negative-r0", "other-schedule", "negative-ctas", "2d"]


def _bad_call(bad):
    """The operands of slot 0 at 1/4 size with one thing wrong: (band
    source, taps, canvas, r0, c0, keywords)."""
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
    return band, taps, canvas, r0, c0, kw


@pytest.mark.parametrize("bad", _BAD)
def test_wrapper_rejects(bad):
    band, taps, canvas, r0, c0, kw = _bad_call(bad)
    with pytest.raises(ValueError):
        staged_resize.resize_place_staged(band, *taps, canvas, r0, c0, **kw)


@pytest.mark.parametrize("bad", _BAD)
def test_prepared_launch_rejects_at_preparation(bad):
    band, taps, canvas, r0, c0, kw = _bad_call(bad)
    with pytest.raises(ValueError):
        staged_resize.StagedLaunch(band, *taps, canvas, r0, c0, **kw)


@pytest.mark.parametrize("other", ["shape", "dtype", "device", "pitch",
                                   "misaligned"])
def test_prepared_launch_rejects_another_source_at_the_call(other):
    """A call checks the source against what was prepared: shape, dtype,
    device and strides as integer compares, and the data pointer's
    16-byte alignment."""
    oriented, taps, canvas = _slot()
    band = staged_resize.stage_source(oriented)
    launch = staged_resize.StagedLaunch(band, *taps, canvas, 0, 0)
    h, w, c = oriented.shape
    if other == "shape":
        src = staged_resize.stage_source(oriented[:-1])
    elif other == "dtype":
        src = staged_resize.stage_source(oriented, torch.bfloat16)
    elif other == "device":
        src = torch.empty_like(band, device="meta")
    elif other == "pitch":            # rows of 496 pixels, not 480
        src = staged_resize.stage_source(
            torch.cat([oriented, oriented[:, :16]], 1))[:, :w]
    else:                             # one byte off a 16-byte boundary
        src = torch.zeros((h * w * c + 16,), dtype=torch.uint8)[1:] \
            .as_strided((h, w, c), (w * c, c, 1))
    before = canvas.clone()
    with pytest.raises(ValueError):
        launch(src)
    assert torch.equal(canvas, before)
    launch(band)


@pytest.mark.parametrize("offset", [0, 16])
def test_prepared_launch_checks_the_storage_past_the_calls_offset(offset):
    """The kernel reads a band source through its last row's padded width.
    A call's source of the prepared shape and strides, 16 bytes further
    into a buffer that holds the view but not its last row's pad, is
    refused; the same buffer at offset 0 holds it all and is taken."""
    plan, _, p, _, oriented = _job("upscale-odd")
    h, w, c = oriented.shape
    pitch = -(-w // 16) * 16 * c
    assert pitch > w * c                  # the rows have a pad
    band = staged_resize.stage_source(oriented)
    taps = _taps(p, plan.filter)
    canvas = torch.zeros((len(taps[0]), len(taps[2]), c), dtype=torch.uint8)
    launch = staged_resize.StagedLaunch(band, *taps, canvas, 0, 0)
    buf = torch.zeros((16 + (h - 1) * pitch + w * c + 1,), dtype=torch.uint8)
    src = buf.as_strided((h, w, c), band.stride(), offset)
    src.copy_(oriented)
    assert src.data_ptr() % 16 == 0
    if offset:
        with pytest.raises(ValueError, match="padded width"):
            launch(src)
        assert not canvas.any()
    else:
        launch(src)
        assert torch.equal(canvas, staged_resize.resize_place_staged_ref(
            src, *taps))


def test_prepared_launch_on_cpu_places_the_plain_version():
    """Prepared once, called on two band sources (uint8, then bf16 copies
    of the same shape go through their own launch): each call places the
    plain version of the source it was given; no kernel launch counted."""
    oriented, taps, canvas = _slot()
    rng = np.random.default_rng(9)
    launches = staged_resize.staged_launches
    for dt in (torch.uint8, torch.bfloat16):
        launch = staged_resize.StagedLaunch(
            staged_resize.stage_source(oriented, dt), *taps, canvas, 0, 0)
        assert launch.args is None and launch.schedule.tile_c > 0
        for _ in range(2):
            src = staged_resize.stage_source(torch.from_numpy(rng.integers(
                0, 256, tuple(oriented.shape), np.uint8)), dt)
            launch(src)
            assert torch.equal(canvas, staged_resize.resize_place_staged_ref(
                src, *taps))
    assert staged_resize.staged_launches == launches


def test_staged_args_fields_follow_the_c_struct():
    """``StagedArgs`` mirrors ``struct StagedArgs`` of the kernel source
    field by field, in order, with the C types' widths; its size is held
    to the library's on the card (tests/test_torch_kernel.py)."""
    import ctypes
    import os
    import re

    path = os.path.join(os.path.dirname(staged_resize.__file__), "..",
                        "csrc", "resize_place_staged.cu")
    with open(path) as f:
        body = re.search(r"struct StagedArgs \{(.*?)\n\};", f.read(),
                         re.S).group(1)
    widths = {"int64_t": ctypes.c_int64, "int32_t": ctypes.c_int32}
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if not line:
            continue
        m = re.match(r"(const )?(\w+)(\*?) ?(.*);$", line)
        kind = ctypes.c_void_p if m.group(3) or "*" in m.group(4) \
            else widths[m.group(2)]
        for name in m.group(4).split(","):
            fields.append((name.strip().lstrip("*"), kind))
    assert fields == staged_resize.StagedArgs._fields_


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
