"""The prepared launches of kernels #1-#3 on the CPU: ``PlaceLaunch`` (#1,
and #2 on a ``(B, H, W, C)`` batch), ``PlacementLauncher`` (one per drawn
placement, held in the step cache) and the prepared ``WindowLauncher``
(#3, per chunk of the banded rung).

On the CPU each runs its plain version because the tensors lie there; the
kernels themselves run only on a card (``tests/test_torch_kernel.py``,
prepared against plain, bit for bit).  Here the prepared
forms equal their plain versions exactly and the JAX package's Pallas
kernel (interpret mode, as its own tests run it) within 1 uint8 step: the
JAX kernel contracts f32 banded matmuls where the port gathers, so a sum
within f32 rounding of a .5 boundary may land one step apart.  A call with
a tensor of another shape, dtype, device or stride than the one prepared
raises; the step cache keys on ``plan.signature()``.
"""

import ctypes
import dataclasses
import os
import re

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
from imagestitching_tpu_torch.ops import cuda_resize, torch_compose
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.parallel.batch import BatchedStitch

CPU = torch.device("cpu")

# (shapes (raw w, raw h, orientation), options, channels); every case has a
# resampled placement
_CASES = {
    **{f"orient{o}": ([(37, 23, o), (45, 29, 1)], dict(mode="max", gap=2.5),
                      3) for o in range(1, 9)},
    "bilinear-down-gray": ([(64, 48, 6), (40, 30, 1)], dict(mode="min"), 1),
    "lanczos3-down": ([(90, 70, 6), (30, 20, 1)],
                      dict(direction="horizontal", filter="lanczos3"), 3),
    "lanczos3-gray": ([(70, 90, 3), (30, 20, 1)],
                      dict(direction="horizontal", filter="lanczos3"), 1),
}


def _job(name, seed=0):
    """(port plan, JAX plan, raw images) of one named case."""
    shapes, kw, c = _CASES[name]
    opts = StitchOptions(supersample=False, **kw)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    jplan = jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(**dataclasses.asdict(opts)))
    rng = np.random.default_rng(sum(map(ord, name)) + seed)
    imgs = [rng.integers(0, 256, (h, w, c), np.uint8) for w, h, _ in shapes]
    return plan, jplan, imgs


def _resampled(plan, jplan):
    return [(p, jp) for p, jp in zip(plan.placements, jplan.placements)
            if geometry.placement_copy_offsets(p, plan.filter) is None]


def _taps(p, kind):
    t = torch_compose.placement_taps(p, kind)
    return [torch.from_numpy(a) for a in (t["rows"]["i0"], t["rows"]["w"],
                                          t["cols"]["i0"], t["cols"]["w"])]


def _pallas_region(raw, jp, kind):
    """The JAX package's kernel #1 on the placement, in interpret mode."""
    s = pallas_resize._Schedule(jp, kind)
    src = pallas_resize._orient_chw(jnp.asarray(raw), jp.orientation,
                                    s.m_h_pad, s.m_w_pad)
    region, (_, _, nr, nc) = pallas_resize.resize_place_one(
        src, jp, kind, interpret=True)
    return torch.from_numpy(
        np.asarray(region)[:, :nr, :nc].transpose(1, 2, 0).copy())


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a.int() - b.int()).abs().max())


@pytest.mark.parametrize("name", sorted(_CASES))
def test_prepared_launch_equals_plain_and_jax(name):
    """#1 prepared on the CPU: the placement's region exactly the plain
    version's, within 1 of the Pallas kernel, nothing stored outside it, no
    launch counted."""
    plan, jplan, imgs = _job(name)
    counts = (cuda_resize.launches, cuda_resize.batch_launches)
    checked = 0
    for p, jp in _resampled(plan, jplan):
        src = torch.from_numpy(imgs[p.index])
        taps = _taps(p, plan.filter)
        canvas = torch.zeros((plan.canvas_h, plan.canvas_w, src.shape[2]),
                             dtype=torch.uint8)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)
        assert launch.args is None      # nothing to prepare on the CPU
        launch(src, canvas)
        want = cuda_resize.resize_place_ref(src, p.orientation, *taps)
        assert torch.equal(canvas[r0:r1, c0:c1], want)
        assert _maxdiff(want, _pallas_region(imgs[p.index], jp,
                                             jplan.filter)) <= 1
        canvas[r0:r1, c0:c1] = 0
        assert int(canvas.count_nonzero()) == 0
        checked += 1
    assert checked
    assert (cuda_resize.launches, cuda_resize.batch_launches) == counts


@pytest.mark.parametrize("name", ["orient6", "lanczos3-gray", "orient3"])
def test_prepared_batch_launch_equals_plain_and_single_jobs(name):
    """#2 prepared on the CPU: B = 3 jobs of other data, each job's region
    the plain version's and the single-job prepared launch's."""
    plan, jplan, _ = _job(name)
    c = _CASES[name][2]
    rng = np.random.default_rng(3)
    before = cuda_resize.batch_launches
    for p, jp in _resampled(plan, jplan):
        src = torch.from_numpy(rng.integers(0, 256, (3, p.raw_h, p.raw_w, c),
                                            np.uint8))
        taps = _taps(p, plan.filter)
        canvas = torch.zeros((3, plan.canvas_h, plan.canvas_w, c),
                             dtype=torch.uint8)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas, r0,
                                c0)(src, canvas)
        want = cuda_resize.resize_place_batch_ref(src, p.orientation, *taps)
        assert torch.equal(canvas[:, r0:r1, c0:c1], want)
        one = torch.zeros_like(canvas[0])
        single = cuda_resize.PlaceLaunch(src[0], p.orientation, *taps, one,
                                         r0, c0)
        for b in range(3):
            single(src[b].contiguous(), one)
            assert torch.equal(one, canvas[b])
        assert _maxdiff(want[1], _pallas_region(src[1].numpy(), jp,
                                                jplan.filter)) <= 1
    assert cuda_resize.batch_launches == before


@pytest.mark.parametrize("name,chunk", [("orient5", 4), ("orient8", 6),
                                        ("lanczos3-down", 5),
                                        ("lanczos3-gray", 7),
                                        ("bilinear-down-gray", 9)])
def test_prepared_window_launcher_equals_plain_and_jax(name, chunk):
    """#3 prepared on the CPU, the banded rung's form (the placement's taps
    once, per chunk its first tap row and crop start): each chunk's rows
    the plain version's, rows past a short last chunk untouched, the chunks
    together within 1 of the Pallas kernel's region and equal to the
    chunks of ``resize_place_window``, a launcher made and called once."""
    plan, jplan, imgs = _job(name)
    checked = 0
    for p, jp in _resampled(plan, jplan):
        oriented = geometry.orient_array(imgs[p.index], p.orientation)
        rows, k = p.row_span[1] - p.row_span[0], chunk
        while rows % k == 0:        # a last chunk shorter than the region
            k += 1
        wp = WindowPlan(p, plan.filter, k)
        taps = [torch.from_numpy(a) for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
        c = oriented.shape[2]
        region = torch.zeros((wp.chunk, wp.n_cols, c), dtype=torch.uint8)
        other = torch.zeros_like(region)
        launch = cuda_resize.WindowLauncher(*taps, region,
                                            (wp.crop_rows, wp.disp_w, c))
        assert launch.args is None
        whole = torch.zeros((wp.n_rows, wp.n_cols, c), dtype=torch.uint8)
        short = 0
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = torch.from_numpy(wp.stage_crop(oriented, g))
            region.fill_(7)
            launch(crop, a, s_lo, valid)
            want = cuda_resize.resize_place_window_ref(crop, *taps, a, s_lo,
                                                       valid)
            assert torch.equal(region[:valid], want), g
            assert bool((region[valid:] == 7).all())
            cuda_resize.resize_place_window(crop, *taps, other, a, s_lo,
                                            valid)
            assert torch.equal(other[:valid], want), g
            whole[a:a + valid] = want
            short += valid < wp.chunk
        assert short == 1, "the last chunk must be shorter than the region"
        assert torch.equal(whole, cuda_resize.resize_place_ref(
            torch.from_numpy(imgs[p.index]), p.orientation,
            *_taps(p, plan.filter)))
        assert _maxdiff(whole, _pallas_region(imgs[p.index], jp,
                                              jplan.filter)) <= 1
        checked += 1
    assert checked


def _one():
    plan, jplan, imgs = _job("orient6")
    p, _ = _resampled(plan, jplan)[0]
    src = torch.from_numpy(imgs[p.index])
    canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3), dtype=torch.uint8)
    return p, src, _taps(p, plan.filter), canvas


@pytest.mark.parametrize("other", ["src-shape", "canvas-shape", "src-dtype",
                                   "canvas-dtype", "src-device",
                                   "canvas-device", "src-stride",
                                   "canvas-stride", "batch"])
def test_prepared_launch_rejects_another_tensor(other):
    p, src, taps, canvas = _one()
    launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                     *(s[0] for s in (p.row_span,
                                                      p.col_span)))
    if other == "src-shape":
        src = src[1:].contiguous()
    elif other == "canvas-shape":
        canvas = canvas[:, 1:].contiguous()
    elif other == "src-dtype":
        src = src.float()
    elif other == "canvas-dtype":
        canvas = canvas.to(torch.int32)
    elif other == "src-device":
        src = src.to("meta")
    elif other == "canvas-device":
        canvas = canvas.to("meta")
    elif other == "src-stride":
        # the same shape, not dense: a transposed copy viewed back
        src = src.transpose(0, 1).contiguous().transpose(0, 1)
    elif other == "canvas-stride":
        canvas = canvas.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        src, canvas = src[None], canvas[None]
    with pytest.raises(ValueError):
        launch(src, canvas)


@pytest.mark.parametrize("bad", ["orientation", "off-canvas", "meta",
                                 "int64-taps", "channels"])
def test_prepared_launch_rejects_at_preparation(bad):
    p, src, taps, canvas = _one()
    o, r0 = p.orientation, p.row_span[0]
    if bad == "orientation":
        o = 9
    elif bad == "off-canvas":
        r0 = canvas.shape[0]
    elif bad == "meta":
        src, canvas = src.to("meta"), canvas.to("meta")
        taps = [t.to("meta") for t in taps]
    elif bad == "int64-taps":
        taps[0] = taps[0].long()
    else:
        canvas = canvas[..., :1].contiguous()
    with pytest.raises(ValueError):
        cuda_resize.PlaceLaunch(src, o, *taps, canvas, r0, p.col_span[0])


@pytest.mark.parametrize("other", ["shape", "dtype", "stride", "device"])
def test_prepared_window_launcher_rejects_another_crop(other):
    plan, jplan, imgs = _job("orient5")
    p, _ = _resampled(plan, jplan)[0]
    wp = WindowPlan(p, plan.filter, 4)
    taps = [torch.from_numpy(a) for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
    region = torch.zeros((wp.chunk, wp.n_cols, 3), dtype=torch.uint8)
    launch = cuda_resize.WindowLauncher(*taps, region,
                                        (wp.crop_rows, wp.disp_w, 3))
    oriented = geometry.orient_array(imgs[p.index], p.orientation)
    crop = torch.from_numpy(wp.stage_crop(oriented, 0))
    a, valid, s_lo = wp.chunk_window(0)
    launch(crop, a, s_lo, valid)
    if other == "shape":
        crop = crop[:, 1:].contiguous()
    elif other == "dtype":
        crop = crop.float()
    elif other == "stride":
        crop = crop.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        crop = crop.to("meta")
    with pytest.raises(ValueError):
        launch(crop, a, s_lo, valid)


def test_step_cache_keys_on_the_full_signature():
    """Two plans that share every span but not the sub-pixel phase get their
    own taps and their own prepared launchers."""
    specs = [ImageSpec(37, 23, 6), ImageSpec(45, 29, 1)]
    a = solve(specs, StitchOptions(mode="max", gap=0.51, supersample=False))
    b = solve(specs, StitchOptions(mode="max", gap=0.69, supersample=False))
    assert a.shape_signature() == b.shape_signature()
    assert a.signature() != b.signature()
    sa, sb = cuda_resize.plan_steps(a, CPU), cuda_resize.plan_steps(b, CPU)
    assert cuda_resize.plan_steps(a, CPU) is sa
    differ = 0
    for x, y in zip(sa, sb):
        if x is None or x.copy is not None:
            continue
        assert isinstance(x.launch, cuda_resize.PlacementLauncher)
        assert x.launch is not y.launch and x.launch.taps is x.taps
        differ += not all(torch.equal(u, v) for u, v in zip(x.taps, y.taps))
    assert differ, "the two phases gave the same taps"


def test_placement_launcher_prepares_once_per_shape_pair():
    """One step serves an RGB job, a gray job and a batch: one prepared
    launch per pair of source and canvas shapes, each reused, at most
    ``_LAUNCHES_MAX`` held; every draw the plain version's."""
    plan, jplan, imgs = _job("orient6")
    p, _ = _resampled(plan, jplan)[0]
    step = cuda_resize.plan_steps(plan, CPU)[p.index]
    r0, r1 = p.row_span
    c0, c1 = p.col_span
    held = step.launch._launches
    held.clear()
    rgb = torch.from_numpy(imgs[p.index])
    for src in (rgb, rgb[..., :1].contiguous(), rgb, rgb[None].repeat(
            2, 1, 1, 1)):
        canvas = torch.zeros((*src.shape[:-3], plan.canvas_h, plan.canvas_w,
                              src.shape[-1]), dtype=torch.uint8)
        cuda_resize.draw_placement(src, p, step, canvas, plain=False)
        assert torch.equal(canvas[..., r0:r1, c0:c1, :],
                           cuda_resize.resize_place_ref(src, p.orientation,
                                                        *step.taps))
    assert len(held) == 3
    for b in range(2, 2 + cuda_resize.PlacementLauncher._LAUNCHES_MAX):
        src = rgb[None].repeat(b, 1, 1, 1)
        step.launch(src, torch.zeros((b, plan.canvas_h, plan.canvas_w, 3),
                                     dtype=torch.uint8))
    assert len(held) == cuda_resize.PlacementLauncher._LAUNCHES_MAX


def test_place_args_fields_follow_the_c_struct():
    """``PlaceArgs`` mirrors ``struct PlaceArgs`` of the kernel source field
    by field, in order, with the C types' widths; its size is held to the
    library's on the card (tests/test_torch_kernel.py)."""
    path = os.path.join(os.path.dirname(cuda_resize.__file__), "..", "csrc",
                        "resize_place.cu")
    with open(path) as f:
        body = re.search(r"struct PlaceArgs \{(.*?)\n\};", f.read(),
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
    assert fields == cuda_resize.PlaceArgs._fields_


def test_main_path_on_cpu_counts_no_launch():
    """The resident, batched and banded paths on the CPU go through the
    prepared forms' plain versions: no launch of any kind counted."""
    from imagestitching_tpu_torch.runtime import pipeline

    plan, _, imgs = _job("lanczos3-down")
    counts = (cuda_resize.launches, cuda_resize.batch_launches,
              cuda_resize.window_launches)
    got = cuda_resize.stitch(plan, imgs, CPU)
    stacks = [np.stack([a, a]) for a in imgs]
    both = BatchedStitch(plan, 2, device=CPU)(stacks)
    banded, _ = pipeline._run_banded(plan, imgs, 3, 8, "auto", CPU,
                                     lambda *_: None)
    assert np.array_equal(both[0], got.numpy())
    assert np.array_equal(both[1], got.numpy())
    assert np.array_equal(banded, got.numpy())
    assert counts == (cuda_resize.launches, cuda_resize.batch_launches,
                      cuda_resize.window_launches)


def test_profile_resize_sites_agree_on_cpu(monkeypatch):
    """The fresh-process profiler's three sites (#1 at config 3, #2 at
    config 5, #3 on config 4-EXIF's banded chunks), cut 16x to 32x and run
    on the CPU: prepared and plain agree exactly."""
    from imagestitching_tpu_torch.tools import profile_resize as pr

    monkeypatch.setattr(pr, "CONFIG3", [(w // 16, h // 16, o)
                                        for w, h, o in pr.CONFIG3])
    monkeypatch.setattr(pr, "CONFIG5", [(w // 16, h // 16)
                                        for w, h in pr.CONFIG5])
    monkeypatch.setattr(pr, "CONFIG4", [(w // 32, h // 32, o)
                                        for w, h, o in pr.CONFIG4])
    gen = torch.Generator().manual_seed(0)
    sites = [pr.site_config3(CPU, gen), pr.site_config5(CPU, gen, batch=3),
             pr.site_config4_banded(CPU, gen, band_rows=8)]
    assert [len(s.prepared) for s in sites[:2]] == [5, 8]
    assert len(sites[2].prepared) > 5
    for site in sites:
        assert site.nbytes > 0
        for f in site.prepared:
            f()
        assert site.parity() == (0, 0), site.name


def test_profile_resize_main_raises_without_cuda():
    from imagestitching_tpu_torch.tools import profile_resize

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the profiler would run")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_resize.main(["--reps", "1"])
