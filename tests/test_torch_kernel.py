"""The CUDA resize-and-place kernels (single-job, batched, windowed, and
#4 from a ring of staged source bands) against their plain PyTorch version,
on the card.  The kernels have no CPU mode, so every
test here is marked ``cuda`` and skips on a host without a card.  Run them on a CUDA host with

    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q

(``--noconftest``: the shared conftest sets up JAX, which this file does not
use).  Tolerance: none.  The kernel sums in the plain version's order and is
built with ``-fmad=false``, so its store equals the plain version's bit for
bit; a truncating or half-to-even store, or an orientation stride bug,
differs somewhere.  The batched kernel is the same body over ``blockIdx.z``,
so it also equals B single launches bit for bit.  The windowed kernel is
the same body on a source row window, so its chunks put together equal the
single-job kernel's region bit for bit, and a banded job equals the resident
one.  Whole jobs are held to the float64 oracle within 1 step.  Kernel #4
computes from bands of an oriented source staged in a ring of three, held
as uint8 or bf16: both equal its plain version at the persistent default
grid, at grids where each CTA walks 8, about 115 or all of the tiles (the
ring wraps), with one channel and with an odd width's padded pitch, and
equal #1 on config 5's slot 0; its prepared call equals the one-shot
wrapper, and a wrong pitch or a refused launch raises.  Kernels #1-#3
launch prepared, reused or made and called once by the wrappers, with
equal bits.

The cases reach what the tiled body does differently: tiles cut by the
region's edge at odd canvas columns, a 12x bilinear downscale of a
transposed source (a list of touched lines), lanczos3 with K = 97 taps, a
4x upscale and one channel.  The file imports only the port, so it runs
where the JAX package is not installed.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig, StitchServer
from imagestitching_tpu_torch.config import CanvasLimits, StitchOptions
from imagestitching_tpu_torch.core import geometry, oracle
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import _build, cuda_resize, \
    staged_resize, torch_compose
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.runtime import pipeline, tiler
from imagestitching_tpu_torch.tools import profile_bf16_stage

pytestmark = pytest.mark.cuda

_CASES = {
    # 2x downscale: every tap weighs 0.5, many sums land on .5 (half-up)
    "bilinear-halves": ([(400, 200, 1), (100, 100, 1)],
                        dict(direction="horizontal"), None, 3),
    "bilinear-up": ([(97, 61, 6), (400, 300, 1)], dict(mode="max", gap=3.5),
                    None, 3),
    "fractional-down": ([(800, 720, 1), (640, 800, 3)],
                        dict(direction="horizontal", gap=9),
                        CanvasLimits(max_side=600, max_pixels=10 ** 9,
                                     max_supersample=1.0), 3),
    **{f"orient{o}": ([(333, 217, o), (400, 260, 1)],
                      dict(mode="max", gap=2.5), None, 3)
       for o in range(1, 9)},
    **{f"{k}-down": ([(900, 700, 6), (300, 200, 1)],
                     dict(direction="horizontal", gap=4, filter=k), None, 3)
       for k in ("triangle", "box", "lanczos3")},
    "gray-c1": ([(500, 400, 1), (300, 350, 8)],
                dict(direction="horizontal", gap=1.5), None, 1),
    # regions of 240, 100 and 258 cols by 151 rows at canvas cols 0, 241
    # and 343: tiles cut by the region's edge, odd c0
    "edge-odd-c0": ([(97, 61, 1), (151, 100, 6), (77, 45, 3)],
                    dict(direction="horizontal", mode="max", gap=1.5), None,
                    3),
    # 1800 display cols onto 150: a 12x bilinear downscale, transposed
    "bilinear-12x-transposed": ([(2400, 1800, 6), (150, 200, 1)],
                                dict(mode="min"), None, 3),
    # 2400 cols onto 150 with lanczos3: K = 97 taps on both axes
    "lanczos3-k97": ([(2400, 1800, 1), (150, 100, 1)],
                     dict(mode="min", filter="lanczos3"), None, 3),
    "upscale-4x": ([(40, 50, 8), (200, 160, 1)], dict(mode="max", gap=2),
                   None, 3),
    "gray-c1-12x-o5": ([(1200, 1800, 5), (100, 80, 1)],
                       dict(mode="min"), None, 1),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _job(name):
    shapes, kw, limits, c = _CASES[name]
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes],
                 StitchOptions(**kw), limits)
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (lambda w, h: (h, w)) if c == 1 else (lambda w, h: (h, w, c))
    imgs = [rng.integers(0, 256, shape(w, h), np.uint8) for w, h, _ in shapes]
    return plan, imgs


def _taps(p, kind, dev):
    t = torch_compose.placement_taps(p, kind)
    return [torch.from_numpy(x).to(dev) for x in
            (t["rows"]["i0"], t["rows"]["w"], t["cols"]["i0"], t["cols"]["w"])]


def _operands(raw, p, kind, dev):
    a = raw if raw.ndim == 3 else raw[:, :, None]
    src = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    return src, _taps(p, kind, dev)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_kernel_equals_plain_version(card, name):
    plan, imgs = _job(name)
    checked = 0
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        src, taps = _operands(raw, p, plan.filter, card)
        canvas = torch.zeros((plan.canvas_h, plan.canvas_w, src.shape[2]),
                             dtype=torch.uint8, device=card)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        before = cuda_resize.launches
        cuda_resize.resize_place(src, p.orientation, *taps, canvas, r0, c0)
        assert cuda_resize.launches == before + 1
        want = cuda_resize.resize_place_ref(src, p.orientation, *taps)
        d = (canvas[r0:r1, c0:c1].int() - want.int()).abs()
        assert int(d.max()) == 0, f"{name} #{p.index}: max |diff| {d.max()}"
        # nothing stored outside the placement's region
        canvas[r0:r1, c0:c1] = 0
        assert int(canvas.count_nonzero()) == 0
        checked += 1
    assert checked, f"{name}: no resampled placement"
    got = cuda_resize.stitch(plan, imgs, card).cpu().numpy()
    want = oracle.stitch(plan, imgs)
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1


@pytest.mark.parametrize("name", sorted(_CASES))
def test_batched_kernel_equals_plain_and_single_launches(card, name):
    plan, _ = _job(name)
    c = _CASES[name][3]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    checked = 0
    for p in plan.placements:
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        src = torch.from_numpy(rng.integers(
            0, 256, (3, p.raw_h, p.raw_w, c), np.uint8)).to(card)
        taps = _taps(p, plan.filter, card)
        canvas = torch.zeros((3, plan.canvas_h, plan.canvas_w, c),
                             dtype=torch.uint8, device=card)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        before = cuda_resize.batch_launches
        cuda_resize.resize_place_batch(src, p.orientation, *taps, canvas,
                                       r0, c0)
        assert cuda_resize.batch_launches == before + 1
        want = cuda_resize.resize_place_batch_ref(src, p.orientation, *taps)
        d = (canvas[:, r0:r1, c0:c1].int() - want.int()).abs()
        assert int(d.max()) == 0, f"{name} #{p.index}: max |diff| {d.max()}"
        for b in range(3):
            one = torch.zeros_like(canvas[b])
            cuda_resize.resize_place(src[b], p.orientation, *taps, one, r0, c0)
            assert torch.equal(one, canvas[b]), f"{name} #{p.index} job {b}"
        checked += 1
    assert checked, f"{name}: no resampled placement"


def test_broken_build_fails_the_flush(card, monkeypatch):
    """A kernel that cannot be built fails the flush's jobs with the build's
    error; it never hands back a plain-version result."""
    def broken():
        raise RuntimeError("nvcc failed (synthetic)")

    monkeypatch.setattr(_build, "load", broken)
    shapes, kw, _, _ = _CASES["bilinear-up"]
    _, imgs = _job("bilinear-up")
    with StitchServer(max_batch=2, max_wait_s=5.0,
                      config=RuntimeConfig(device="cuda")) as s:
        futs = [s.submit(imgs, StitchOptions(**kw),
                         orientations=[o for _, _, o in shapes])
                for _ in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="synthetic"):
                f.result(timeout=60)
        st = s.stats()
    assert st["failed"] == 2 and st["jobs"] == 0


@pytest.mark.parametrize("name", sorted(_CASES))
def test_window_kernel_equals_plain_version(card, name):
    """Kernel #3 at 16-row chunks (several per placement): every chunk's
    region equals the plain version bit for bit, rows past the chunk stay
    untouched, and the chunks together equal kernel #1's region.  Each chunk
    is launched twice: with its rebased taps, and from the placement's taps
    with its first row and crop start (the banded rung's form, non-zero
    offsets on every chunk but the first)."""
    plan, imgs = _job(name)
    checked = 0
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        a3 = raw if raw.ndim == 3 else raw[:, :, None]
        oriented = geometry.orient_array(a3, p.orientation)
        wp = WindowPlan(p, plan.filter, 16)
        assert wp.n_chunks > 1
        src, taps = _operands(raw, p, plan.filter, card)
        whole = torch.zeros((wp.n_rows, wp.n_cols, a3.shape[2]),
                            dtype=torch.uint8, device=card)
        cuda_resize.resize_place(src, p.orientation, *taps, whole, 0, 0)
        ci0, cw = taps[2:]
        once = torch.zeros((wp.chunk, wp.n_cols, a3.shape[2]),
                           dtype=torch.uint8, device=card)
        launch = cuda_resize.WindowLauncher(
            taps[0], taps[1], ci0, cw, once,
            (wp.crop_rows, wp.disp_w, a3.shape[2]))
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = torch.from_numpy(wp.stage_crop(oriented, g)).to(card)
            ri0, rw = (torch.from_numpy(t).to(card) for t in wp.chunk_taps(g))
            region = torch.zeros((wp.chunk, wp.n_cols, a3.shape[2]),
                                 dtype=torch.uint8, device=card)
            before = cuda_resize.window_launches
            cuda_resize.resize_place_window(crop, ri0, rw, ci0, cw, region)
            assert cuda_resize.window_launches == before + 1
            want = cuda_resize.resize_place_window_ref(crop, ri0, rw, ci0, cw)
            d = (region[:valid].int() - want.int()).abs()
            assert int(d.max()) == 0, f"{name} #{p.index} chunk {g}: {d.max()}"
            assert int(region[valid:].count_nonzero()) == 0
            assert torch.equal(region[:valid], whole[a:a + valid])
            once.zero_()
            launch(crop, a, s_lo, valid)
            assert cuda_resize.window_launches == before + 2
            assert torch.equal(once, region), f"{name} #{p.index} chunk {g}"
        checked += 1
    assert checked, f"{name}: no resampled placement"


@pytest.mark.parametrize("name,strategy", [
    ("bilinear-up", "streamed"), ("orient6", "streamed"),
    ("gray-c1", "streamed"), ("bilinear-up", "banded"),
    ("lanczos3-down", "banded"), ("box-down", "banded"),
    ("orient7", "banded"), ("gray-c1", "banded")])
def test_strategy_equals_resident_on_card(card, name, strategy):
    """A streamed or banded job on the card equals the resident job bit for
    bit; the banded job launches kernel #3 once per chunk and kernel #1
    never."""
    plan, imgs = _job(name)
    c = _CASES[name][3]
    canvas = c * plan.canvas_w * plan.canvas_h
    hbm = (tiler.resident_peak_bytes(plan, c) - 1 if strategy == "streamed"
           else max(canvas // 2, tiler.min_feasible_bytes(plan, c)))
    budget = MemoryBudget(hbm_bytes=hbm)
    ex = tiler.plan_execution(plan, budget, c)
    assert ex.strategy == strategy
    want, m = pipeline.run(plan, imgs, RuntimeConfig(device=str(card)),
                           keep_on_device=True)
    assert m.strategy == "resident"
    before = (cuda_resize.launches, cuda_resize.window_launches)
    got, m = pipeline.run(plan, imgs, RuntimeConfig(device=str(card),
                                                    budget=budget))
    assert m.strategy == strategy
    np.testing.assert_array_equal(got, want.cpu().numpy())
    resampled = [p for p in plan.placements
                 if geometry.placement_copy_offsets(p, plan.filter) is None]
    launched = (cuda_resize.launches - before[0],
                cuda_resize.window_launches - before[1])
    if strategy == "banded":
        chunks = sum(WindowPlan(p, plan.filter, ex.band_rows).n_chunks
                     for p in resampled)
        assert launched == (0, chunks)
    else:
        assert launched == (len(resampled), 0)


def test_broken_build_fails_a_banded_job(card, monkeypatch):
    """A kernel that cannot be built fails a banded job with the build's
    error: it is no OOM, so nothing demotes, and nothing falls back to the
    plain version."""
    def broken():
        raise RuntimeError("nvcc failed (synthetic)")

    plan, imgs = _job("bilinear-up")
    canvas = 3 * plan.canvas_w * plan.canvas_h
    budget = MemoryBudget(hbm_bytes=max(canvas // 2,
                                        tiler.min_feasible_bytes(plan)))
    assert tiler.plan_execution(plan, budget).strategy == "banded"
    monkeypatch.setattr(_build, "load", broken)
    with pytest.raises(RuntimeError, match="synthetic"):
        pipeline.run(plan, imgs, RuntimeConfig(device=str(card),
                                               budget=budget))


@pytest.mark.parametrize("name,strategy", [
    ("bilinear-up", "resident"), ("orient6", "resident"),
    ("lanczos3-down", "resident"), ("edge-odd-c0", "resident"),
    ("bilinear-12x-transposed", "resident"), ("orient7", "streamed"),
    ("bilinear-up", "banded"), ("box-down", "banded")])
def test_overlapped_equals_never_on_card(card, name, strategy):
    """The overlapped scheduler on the card (pinned ring, copy stream, the
    compute stream waiting on each upload) equals the non-overlapped job bit
    for bit; it launches kernel #1 once per resampled placement, or on a
    banded plan kernel #3 once per chunk."""
    plan, imgs = _job(name)
    budget = MemoryBudget()
    if strategy == "streamed":
        budget = MemoryBudget(hbm_bytes=tiler.resident_peak_bytes(plan) - 1)
    elif strategy == "banded":
        budget = MemoryBudget(hbm_bytes=max(
            3 * plan.canvas_w * plan.canvas_h // 2,
            tiler.min_feasible_bytes(plan)))
    ex = tiler.plan_execution(plan, budget)
    assert ex.strategy == strategy
    cfg = RuntimeConfig(device=str(card), budget=budget)
    want, _ = pipeline.run(plan, imgs, cfg)
    before = (cuda_resize.launches, cuda_resize.window_launches)
    got, m = pipeline.run_overlapped(plan, [(lambda a=a: a) for a in imgs],
                                     cfg)
    launched = (cuda_resize.launches - before[0],
                cuda_resize.window_launches - before[1])
    np.testing.assert_array_equal(got, want)
    resampled = [p for p in plan.placements
                 if geometry.placement_copy_offsets(p, plan.filter) is None]
    if strategy == "banded":
        assert m.strategy == "overlapped/banded"
        assert launched == (0, sum(
            WindowPlan(p, plan.filter, ex.band_rows).n_chunks
            for p in resampled))
    else:
        assert m.strategy == "overlapped"
        assert launched == (len(resampled), 0)
        assert m.h2d_bytes == sum(a.nbytes for a in imgs)


def test_overlapped_stager_reuses_its_slots_on_card(card):
    """Nine sources through a ring of two pinned slots, with a fence after
    every draw: each source lands before its slot is written again."""
    shapes = [(300 + 17 * i, 200 + 11 * i, 1 + i % 8) for i in range(9)]
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes],
                 StitchOptions(gap=2, max_images=None))
    rng = np.random.default_rng(9)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in shapes]
    canvas = pipeline.new_canvas(plan, 3, card)
    steps = cuda_resize.plan_steps(plan, card)
    stager = pipeline._Stager(card, max(a.nbytes for a in imgs), 2, 0)
    assert all(s.is_pinned() for s in stager.slots)
    for raw, p, step in zip(imgs, plan.placements, steps):
        src = stager.upload(np.ascontiguousarray(raw))
        cuda_resize.draw_placement(src, p, step, canvas, False)
        stager.drawn(raw.nbytes)
    torch.cuda.synchronize(card)
    want, _ = pipeline.run(plan, imgs, RuntimeConfig(device=str(card)))
    np.testing.assert_array_equal(canvas.cpu().numpy(), want)


class _SlowBands:
    """A writer that sleeps in every write and keeps a copy of each band."""

    def __init__(self, delay_s):
        self.bands, self.delay_s, self.closed = [], delay_s, False

    def write(self, band):
        import time
        time.sleep(self.delay_s)
        self.bands.append(np.array(band, copy=True))

    def close(self):
        self.closed = True


@pytest.mark.parametrize("h,band,depth,delay", [
    (1000, 96, 3, 0.0), (1000, 96, 2, 0.01), (257, 300, 3, 0.0),
    (4099, 512, 3, 0.005)])
def test_stream_device_reads_back_a_card_canvas(card, h, band, depth, delay):
    """``_stream_device`` on a CUDA tensor: the bands, read into pinned
    buffers on their own stream behind the kernels that drew the canvas,
    join to ``canvas.cpu()``; a writer slower than the copies never sees a
    band before its copy lands or after its buffer is reused."""
    from imagestitching_tpu_torch.runtime import export

    w = 700
    g = torch.Generator(device=card).manual_seed(h)
    canvas = torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8,
                           device=card)
    # queue more work on the canvas's stream: the readback must wait for it
    canvas.add_(1)
    writer = _SlowBands(delay)
    phases = {"readback_s": 0.0, "encode_s": 0.0}
    export._stream_device(canvas, writer, h, w, 3, band, phases,
                          lambda *a: None, depth=depth)
    assert writer.closed and phases["readback_s"] > 0
    np.testing.assert_array_equal(np.concatenate(writer.bands),
                                  canvas.cpu().numpy())


def test_stitch_to_file_streams_a_card_canvas(card, tmp_path):
    """Nine sources through ``stitch_to_file``: the overlapped job's canvas
    stays on the card and is streamed to PNG and JPEG, equal to the
    monolithic files."""
    from imagestitching_tpu_torch import api
    from imagestitching_tpu_torch.imgio import codec, native

    if not native.available():
        pytest.skip("native codec unavailable")
    plan, imgs = _job("orient6")
    items = [(imgs[i % 2], plan.placements[i % 2].orientation)
             for i in range(9)]
    cfg = RuntimeConfig(device=str(card))
    for ext in ("png", "jpg"):
        p, m = api.stitch_to_file(items, tmp_path / f"s.{ext}", config=cfg,
                                  return_metrics=True)
        assert m.strategy == "overlapped" and m.readback_s > 0
        q = api.stitch_to_file(items, tmp_path / f"m.{ext}", config=cfg,
                               stream=False)
        if ext == "png":
            np.testing.assert_array_equal(codec.decode(p)[0],
                                          codec.decode(q)[0])
        else:
            assert open(p, "rb").read() == open(q, "rb").read()


# ---------------------------------------------------------------- extensions

@pytest.mark.parametrize("h,w,c,box_w", [
    (1, 37, 3, 12), (37, 1, 3, 12), (1, 1, 3, 12), (3, 500, 3, 12),
    (333, 517, 1, 120), (2728, 300, 3, 75), (9, 7, 3, 50)])
def test_preview_kernel_equals_plain_version(card, h, w, c, box_w):
    """The preview is one launch of kernel #1 (orientation 1, K = 2),
    equal bit for bit to the plain version on the same pixels, from a host
    array and from a CUDA tensor on the card (no host round trip), and
    within 1 of the float64 host path."""
    from imagestitching_tpu_torch import api

    img = np.random.default_rng(h * w + c).integers(0, 256, (h, w, c),
                                                    np.uint8)
    want = api.make_preview(img, box_w, min_height=2, device="cpu")
    for source in (img, torch.from_numpy(img).to(card)):
        before = cuda_resize.launches
        got = api.make_preview(source, box_w, min_height=2)
        assert cuda_resize.launches == before + 1
        np.testing.assert_array_equal(got, want)
    host = api.make_preview(img, box_w, min_height=2, device=False)
    assert int(np.abs(got.astype(np.int16) - host.astype(np.int16)).max()) \
        <= 1


def test_grid_on_card_equals_grid_on_cpu(card):
    """Three columns of mixed widths (every column resamples) and EXIF
    orientations: the grid on the card equals the grid on the CPU bit for
    bit, one launch of #1 per resampled placement."""
    from imagestitching_tpu_torch import api

    rng = np.random.default_rng(20)
    shapes = [(300, 200, 1), (240, 320, 6), (280, 210, 3), (200, 260, 8),
              (310, 190, 5), (230, 230, 2), (260, 300, 1)]
    items = [(rng.integers(0, 256, (h, w, 3), np.uint8), o)
             for w, h, o in shapes]
    opts = StitchOptions(gap=4, background=(9, 8, 7))
    before = cuda_resize.launches
    got, m = api.stitch_grid(items, cols=3, options=opts,
                             config=RuntimeConfig(device="cuda"),
                             return_metrics=True)
    launched = cuda_resize.launches - before
    want = api.stitch_grid(items, cols=3, options=opts,
                           config=RuntimeConfig(device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert m.strategy == "grid(resident,resident,resident)"
    assert 0 < launched <= len(items)


@pytest.mark.parametrize("shape,k", [((1266, 1170, 3), 32), ((97, 37, 1), 9)])
def test_overlap_scorer_on_card_matches_numpy(card, shape, k):
    """The float64 scorer on the card: within 1e-9 of ``_scores_numpy``,
    the same ordering of the best candidates, and trims equal to the numpy
    scorer's on a synthetic capture."""
    from imagestitching_tpu_torch.ops import overlap

    rng = np.random.default_rng(shape[0])
    region = rng.integers(0, 256, shape, np.uint8)
    template = np.ascontiguousarray(region[200 % shape[0]:][:k])
    want = overlap._scores_numpy(region, template)
    got = overlap._scores(region, template, True)
    assert np.abs(got - want).max() <= 1e-9
    np.testing.assert_array_equal(np.argsort(got, kind="stable")[:4],
                                  np.argsort(want, kind="stable")[:4])
    base = rng.integers(0, 256, (1500, shape[1], shape[2]), np.uint8)
    parts = [base[:600], base[450:1100], base[900:]]
    assert overlap.detect_trims(parts, device=True) == \
        overlap.detect_trims(parts, device=False) == [0, 150, 200]


# ---------------------------------------------------------------- meshes
# One card: the shards of a mesh go onto cuda:0 several times.  That checks
# bits, launches and uploads, not multi-card speed.

def _mesh_job(name):
    """(plan, images) of the sharded card cases: an odd canvas height, a
    resampled placement only the middle bands meet, lanczos3 downscales."""
    shapes, kw = {
        # canvas 61 + 4 + 26 = 91 rows (odd), one 2.5x downscale
        "odd-h": ([(32, 61, 1), (64, 80, 6)], dict(mode="min", gap=4)),
        # the upscaled middle image meets only the middle bands
        "middle-bands": ([(96, 40, 1), (64, 48, 3), (96, 40, 1)],
                         dict(mode="max", gap=200)),
        "lanczos3": ([(900, 700, 6), (300, 200, 1), (640, 480, 3)],
                     dict(mode="min", gap=3, filter="lanczos3")),
    }[name]
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes],
                 StitchOptions(**kw))
    rng = np.random.default_rng(sum(map(ord, name)) + 7)
    return plan, [rng.integers(0, 256, (h, w, 3), np.uint8)
                  for w, h, _ in shapes]


def _pairs(plan, n):
    """(band, resampled placement) pairs that meet: kernel #3's launches."""
    band = -(-plan.canvas_h // n)
    return sum(max(p.row_span[0], k * band)
               < min(p.row_span[1], (k + 1) * band)
               for p in plan.placements
               if p.row_span[1] > p.row_span[0]
               and p.col_span[1] > p.col_span[0]
               and geometry.placement_copy_offsets(p, plan.filter) is None
               for k in range(n))


@pytest.mark.parametrize("name", ["odd-h", "middle-bands", "lanczos3"])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_on_repeated_card_equals_resident(card, name, n):
    from imagestitching_tpu_torch.parallel.mesh import make_mesh
    from imagestitching_tpu_torch.parallel.sharding import ShardedStitch

    plan, imgs = _mesh_job(name)
    if name == "odd-h":
        assert plan.canvas_h % 2 == 1
    ss = ShardedStitch(plan, make_mesh((1, n), devices=["cuda:0"] * n))
    before = cuda_resize.window_launches
    got = ss(imgs)
    assert cuda_resize.window_launches - before == _pairs(plan, n)
    want = cuda_resize.stitch(plan, imgs, card).cpu().numpy()
    assert np.array_equal(got, want)
    # one device: each source uploaded once, not once per shard
    assert ss.h2d_bytes == sum(a.nbytes for a in imgs)


def test_space_sharded_pipeline_on_card(card):
    from imagestitching_tpu_torch.parallel.mesh import make_mesh

    plan, imgs = _mesh_job("lanczos3")
    cfg = RuntimeConfig(device="cuda", overlap="never",
                        mesh=make_mesh((1, 4), devices=["cuda:0"] * 4))
    out, m = pipeline.run(plan, imgs, cfg)
    assert m.strategy == "space-sharded"
    assert np.array_equal(out, cuda_resize.stitch(plan, imgs, card)
                          .cpu().numpy())


@pytest.mark.parametrize("jobs", [2, 4])
def test_jobs_mesh_on_repeated_card_equals_single_card_batch(card, jobs):
    from imagestitching_tpu_torch.parallel import batch
    from imagestitching_tpu_torch.parallel.mesh import make_mesh

    plan, _ = _job("bilinear-up")
    rng = np.random.default_rng(5)
    stacks = [rng.integers(0, 256, (8, p.raw_h, p.raw_w, 3), np.uint8)
              for p in plan.placements]
    n_res = sum(geometry.placement_copy_offsets(p, plan.filter) is None
                for p in plan.placements)
    single = batch.BatchedStitch(plan, 8, device="cuda")(stacks)
    bs = batch.BatchedStitch(plan, 8, mesh=make_mesh(
        (jobs, 1), devices=["cuda:0"] * jobs))
    before = cuda_resize.batch_launches
    got = bs(stacks)
    assert cuda_resize.batch_launches - before == jobs * n_res
    assert np.array_equal(got, single)


# ---------------------------------------------------------------------------
# Kernel #4: a placement from a ring of staged source bands
# (ops/staged_resize.py), in both band dtypes, tolerance 0
# ---------------------------------------------------------------------------

_DTYPES = [torch.uint8, torch.bfloat16]


def _slot0(dev):
    """Config 5's slot 0 (1920x1080 -> 1024x576): oriented source and taps."""
    plan, p = profile_bf16_stage.slot0()
    raw = np.random.default_rng(5).integers(0, 256, (p.raw_h, p.raw_w, 3),
                                            np.uint8)
    return torch.from_numpy(raw).to(dev), _taps(p, plan.filter, dev)


def _staged_vs_plain(src, taps, dtype, r0=0, c0=0, **kw):
    """Kernel #4 into a random canvas at (r0, c0): max |diff| against the
    plain version there, and whether anything outside the region moved."""
    band = staged_resize.stage_source(src, dtype)
    n_rows, n_cols = len(taps[0]), len(taps[2])
    c = src.shape[2]
    gen = torch.Generator(device=src.device).manual_seed(n_rows + n_cols)
    canvas = torch.randint(0, 256, (r0 + n_rows + 3, c0 + n_cols + 5, c),
                           generator=gen, device=src.device,
                           dtype=torch.uint8)
    before = canvas.clone()
    launches = staged_resize.staged_launches
    staged_resize.resize_place_staged(band, *taps, canvas, r0, c0, **kw)
    torch.cuda.synchronize()
    assert staged_resize.staged_launches == launches + 1
    want = staged_resize.resize_place_staged_ref(band, *taps)
    d = int((canvas[r0:r0 + n_rows, c0:c0 + n_cols].int()
             - want.int()).abs().max())
    canvas[r0:r0 + n_rows, c0:c0 + n_cols] = before[r0:r0 + n_rows,
                                                    c0:c0 + n_cols]
    return d, bool(torch.equal(canvas, before)), want


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
@pytest.mark.parametrize("ctas", [0, 72, 5, 1], ids=[
    "default", "ring-8", "five-ctas", "one-cta"])
def test_staged_kernel_equals_plain_on_slot0(card, dtype, ctas):
    """Slot 0 at the persistent default grid, at 72 CTAs (each walks 8 of
    the 576 tiles, so the ring of 3 wraps), at 5 and at 1 CTA."""
    src, taps = _slot0(card)
    d, outside, _ = _staged_vs_plain(src, taps, dtype, 7, 3, ctas=ctas)
    assert d == 0 and outside


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
def test_staged_kernel_equals_kernel1_on_slot0(card, dtype):
    src, taps = _slot0(card)
    band = staged_resize.stage_source(src, dtype)
    got = torch.zeros((576, 1024, 3), dtype=torch.uint8, device=card)
    staged_resize.resize_place_staged(band, *taps, got, 0, 0)
    one = torch.zeros_like(got)
    cuda_resize.resize_place(src, 1, *taps, one, 0, 0)
    assert torch.equal(got, one)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_staged_kernel_equals_plain_on_oriented_sources(card, name):
    """The phase-3 cases, each resampled placement's source oriented on the
    card first; both band dtypes.  A placement whose three bf16 bands fit
    no tile (lanczos3 at 16x, K = 97) is refused by the schedule."""
    plan, imgs = _job(name)
    checked = refused = 0
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        src, taps = _operands(raw, p, plan.filter, card)
        src = torch_compose.orient(src, p.orientation).contiguous()
        try:
            staged_resize.staged_schedule(taps[0], taps[2], taps[1].shape[1],
                                          taps[3].shape[1], *src.shape)
        except ValueError as e:
            assert "shared memory" in str(e) and taps[1].shape[1] > 64
            refused += 1
            continue
        for dtype in _DTYPES:
            d, outside, want = _staged_vs_plain(src, taps, dtype, 2, 1,
                                                ctas=5)
            assert d == 0 and outside, f"{name} #{p.index} {dtype}: {d}"
            assert torch.equal(want, cuda_resize.resize_place_ref(
                src, 1, *taps))
        checked += 1
    assert checked or name == "lanczos3-k97", name
    assert refused == 0 or name == "lanczos3-k97", name


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
@pytest.mark.parametrize("shape,c", [((563, 1001), 3), ((217, 333), 1)],
                         ids=["odd-rgb", "odd-gray"])
def test_staged_kernel_pads_an_odd_pitch(card, dtype, shape, c):
    _odd_pitch(card, dtype, shape, c, 3)


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
@pytest.mark.parametrize("shape,c", [((563, 1001), 3), ((217, 333), 1)],
                         ids=["odd-rgb", "odd-gray"])
def test_staged_kernel_pads_an_odd_pitch_at_the_default_grid(card, dtype,
                                                             shape, c):
    _odd_pitch(card, dtype, shape, c, 0)


def _odd_pitch(card, dtype, shape, c, ctas):
    """Odd widths: the band source's rows are padded to 16 pixels, so a band
    may read past the last real pixel into the pad, never past the row."""
    h, w = shape
    plan = solve([ImageSpec(w, h), ImageSpec(w + 200, h + 100)],
                 StitchOptions(mode="max", gap=2.5, supersample=False))
    p = plan.placements[0]
    raw = np.random.default_rng(w).integers(0, 256, (h, w, c), np.uint8)
    src = torch.from_numpy(raw).to(card)
    assert staged_resize.stage_source(src, dtype).stride(0) % (16 * c) == 0
    d, outside, _ = _staged_vs_plain(src, _taps(p, plan.filter, card), dtype,
                                     ctas=ctas)
    assert d == 0 and outside


def test_staged_args_size_is_the_librarys(card):
    import ctypes

    lib = _build.load()
    assert ctypes.sizeof(staged_resize.StagedArgs) \
        == lib.resize_place_staged_args_size()


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
def test_staged_default_grid_is_persistent(card, dtype):
    """Slot 0's default grid: as many CTAs as the SMs hold at the kernel's
    occupancy, at most one a tile, which for bf16 bands is at least the
    two CTAs an SM the tile picker planned for; the library's shared
    memory is the host's."""
    src, taps = _slot0(card)
    band = staged_resize.stage_source(src, dtype)
    canvas = torch.zeros((576, 1024, 3), dtype=torch.uint8, device=card)
    launch = staged_resize.StagedLaunch(band, *taps, canvas, 0, 0)
    a, s = launch.args, launch.schedule
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert a.tiles == 576 and a.per_sm >= staged_resize.CTAS_PER_SM
    assert a.grid == min(a.tiles, sms * a.per_sm)
    elt = 2 if dtype == torch.bfloat16 else 1
    assert a.smem_bytes == staged_resize.smem_bytes(
        s.tile_r, s.tile_c, s.band_h, s.band_w, 3, elt, 2, 2)


@pytest.mark.parametrize("dtype", _DTYPES, ids=["uint8", "bf16"])
def test_staged_prepared_call_equals_one_shot(card, dtype):
    """One prepared launch over three sources of slot 0's shape, each equal
    to the one-shot wrapper's result on the same source."""
    _, taps = _slot0(card)
    gen = torch.Generator(device=card).manual_seed(11)
    canvas = torch.zeros((576, 1024, 3), dtype=torch.uint8, device=card)
    one = torch.zeros_like(canvas)
    srcs = [staged_resize.stage_source(torch.randint(
        0, 256, (1080, 1920, 3), generator=gen, device=card,
        dtype=torch.uint8), dtype) for _ in range(3)]
    launch = staged_resize.StagedLaunch(srcs[0], *taps, canvas, 0, 0)
    before = staged_resize.staged_launches
    for b in srcs:
        launch(b)
        staged_resize.resize_place_staged(b, *taps, one, 0, 0)
        assert torch.equal(canvas, one)
    assert staged_resize.staged_launches == before + 6


def test_staged_prepared_call_rejects_a_wrong_pitch(card):
    src, taps = _slot0(card)
    band = staged_resize.stage_source(src)
    canvas = torch.zeros((576, 1024, 3), dtype=torch.uint8, device=card)
    launch = staged_resize.StagedLaunch(band, *taps, canvas, 0, 0)
    wide = staged_resize.stage_source(torch.cat([src, src[:, :16]], 1))
    before = staged_resize.staged_launches
    with pytest.raises(ValueError):
        launch(wide[:, :1920])
    assert staged_resize.staged_launches == before


def test_staged_refused_launch_raises(card):
    """A launch the card refuses (shared memory above the 227 KB the
    kernel may take, forced into the prepared arguments) raises
    RuntimeError and counts no launch."""
    src, taps = _slot0(card)
    band = staged_resize.stage_source(src)
    canvas = torch.zeros((576, 1024, 3), dtype=torch.uint8, device=card)
    launch = staged_resize.StagedLaunch(band, *taps, canvas, 0, 0)
    launch.args.smem_bytes = 240 * 1024
    before = staged_resize.staged_launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        launch(band)
    assert staged_resize.staged_launches == before


# ------------------------------------------------- #1-#3 prepared launches

@pytest.mark.parametrize("name", sorted(_CASES))
def test_prepared_kernel_equals_one_shot_and_plain(card, name):
    """#1 and #2 prepared (``PlaceLaunch``: checked, packed and tiled once,
    one ``ctypes`` call a launch, the launch reused) against the wrappers
    (a launch made and called once) and the plain version, bit for bit:
    one job, then B = 3 jobs of other data through one prepared launch,
    each launch counted once."""
    plan, imgs = _job(name)
    c = _CASES[name][3]
    rng = np.random.default_rng(sum(map(ord, name)) + 2)
    checked = 0
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        src, taps = _operands(raw, p, plan.filter, card)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        canvas = torch.zeros((plan.canvas_h, plan.canvas_w, c),
                             dtype=torch.uint8, device=card)
        one = torch.zeros_like(canvas)
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)
        assert launch.args.kernel and launch.args.tile_r >= 1
        counts = (cuda_resize.launches, cuda_resize.batch_launches)
        launch(src, canvas)
        assert (cuda_resize.launches, cuda_resize.batch_launches) == (
            counts[0] + 1, counts[1])
        cuda_resize.resize_place(src, p.orientation, *taps, one, r0, c0)
        assert torch.equal(canvas, one), f"{name} #{p.index}"
        want = cuda_resize.resize_place_ref(src, p.orientation, *taps)
        assert torch.equal(canvas[r0:r1, c0:c1], want)
        stack = torch.from_numpy(rng.integers(
            0, 256, (3, p.raw_h, p.raw_w, c), np.uint8)).to(card)
        batch = torch.zeros((3, plan.canvas_h, plan.canvas_w, c),
                            dtype=torch.uint8, device=card)
        ones = torch.zeros_like(batch)
        before = cuda_resize.batch_launches
        cuda_resize.PlaceLaunch(stack, p.orientation, *taps, batch, r0,
                                c0)(stack, batch)
        assert cuda_resize.batch_launches == before + 1
        cuda_resize.resize_place_batch(stack, p.orientation, *taps, ones,
                                       r0, c0)
        assert torch.equal(batch, ones), f"{name} #{p.index} batch"
        assert torch.equal(batch[:, r0:r1, c0:c1],
                           cuda_resize.resize_place_batch_ref(
                               stack, p.orientation, *taps))
        checked += 1
    assert checked, f"{name}: no resampled placement"


@pytest.mark.parametrize("name", sorted(_CASES))
def test_prepared_window_equals_one_shot_and_plain(card, name):
    """#3 prepared (``WindowLauncher``) at chunks of about 16 rows, the last
    one shorter than the region (it launches fewer row tiles of the tile
    prepared): every chunk equal bit for bit to ``resize_place_window``'s
    (a launcher made and called once) on the same rows and to the plain
    version, rows past the chunk untouched."""
    plan, imgs = _job(name)
    checked = 0
    for raw, p in zip(imgs, plan.placements):
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            continue
        a3 = raw if raw.ndim == 3 else raw[:, :, None]
        oriented = geometry.orient_array(a3, p.orientation)
        rows, k = p.row_span[1] - p.row_span[0], 16
        while rows % k == 0:
            k += 1
        wp = WindowPlan(p, plan.filter, k)
        taps = [torch.from_numpy(t).to(card)
                for t in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
        c = a3.shape[2]
        region = torch.zeros((wp.chunk, wp.n_cols, c), dtype=torch.uint8,
                             device=card)
        one = torch.zeros_like(region)
        launch = cuda_resize.WindowLauncher(*taps, region,
                                            (wp.crop_rows, wp.disp_w, c))
        assert launch.args.kernel and launch.args.tap_rows == wp.n_rows
        short = 0
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = torch.from_numpy(wp.stage_crop(oriented, g)).to(card)
            region.fill_(7)
            one.fill_(7)
            counts = cuda_resize.window_launches
            launch(crop, a, s_lo, valid)
            assert cuda_resize.window_launches == counts + 1
            cuda_resize.resize_place_window(crop, *taps, one, a, s_lo, valid)
            assert torch.equal(region, one), f"{name} #{p.index} chunk {g}"
            assert torch.equal(region[:valid],
                               cuda_resize.resize_place_window_ref(
                                   crop, *taps, a, s_lo, valid))
            assert bool((region[valid:] == 7).all())
            short += valid < wp.chunk
        assert short == 1
        checked += 1
    assert checked, f"{name}: no resampled placement"


def test_prepared_preview_equals_one_shot(card):
    """The preview's one large launch (a 27282 x 3000 canvas onto 750 cols,
    bilinear, K = 2), prepared and reused against ``make_preview``'s
    (through ``resize_place``, a launch made and called once) and the plain
    version, bit for bit."""
    from imagestitching_tpu_torch import api

    gen = torch.Generator(device=card).manual_seed(21)
    canvas = torch.randint(0, 256, (27282, 3000, 3), generator=gen,
                           dtype=torch.uint8, device=card)
    got = api.make_preview(canvas, 750)
    ph, pw = got.shape[:2]
    ri0, rw = geometry.filter_taps(0, ph, 0.0, float(ph), 27282, "bilinear")
    ci0, cw = geometry.filter_taps(0, pw, 0.0, float(pw), 3000, "bilinear")
    taps = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
            for a in (ri0, rw.astype(np.float32), ci0,
                      cw.astype(np.float32))]
    out = torch.zeros((ph, pw, 3), dtype=torch.uint8, device=card)
    cuda_resize.PlaceLaunch(canvas, 1, *taps, out, 0, 0)(canvas, out)
    np.testing.assert_array_equal(out.cpu().numpy(), got)
    assert torch.equal(out, cuda_resize.resize_place_ref(canvas, 1, *taps))


def test_place_args_size_is_the_librarys(card):
    import ctypes

    lib = _build.load()
    assert ctypes.sizeof(cuda_resize.PlaceArgs) \
        == lib.resize_place_args_size()


def test_prepared_launch_rejects_another_source_on_card(card):
    plan, imgs = _job("orient6")
    p = next(q for q in plan.placements
             if geometry.placement_copy_offsets(q, plan.filter) is None)
    src, taps = _operands(imgs[p.index], p, plan.filter, card)
    canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=card)
    launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                     p.row_span[0], p.col_span[0])
    before = cuda_resize.launches
    for bad in (src[1:].contiguous(), src.cpu(),
                src.transpose(0, 1).contiguous().transpose(0, 1)):
        with pytest.raises(ValueError):
            launch(bad, canvas)
    assert cuda_resize.launches == before


def test_refused_prepare_and_launch_raise(card):
    """A launch the library refuses raises RuntimeError and counts nothing:
    at preparation (a batch of 0, forced into the arguments) and at the
    call (shared memory above what the kernel may take, forced into the
    prepared arguments).  Nothing falls back to the plain version."""
    plan, imgs = _job("orient6")
    p = next(q for q in plan.placements
             if geometry.placement_copy_offsets(q, plan.filter) is None)
    src, taps = _operands(imgs[p.index], p, plan.filter, card)
    canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=card)
    launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                     p.row_span[0], p.col_span[0])
    args = cuda_resize.PlaceArgs.from_buffer_copy(launch.args)
    args.batch = 0
    with pytest.raises(RuntimeError, match="prepare failed"):
        cuda_resize._prepare(args, card.index)
    launch.args.smem_bytes = 240 * 1024
    before = cuda_resize.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        launch(src, canvas)
    assert cuda_resize.launches == before
    assert int(canvas.count_nonzero()) == 0


def test_main_path_launches_prepared_on_card(card):
    """The resident, batched and banded paths launch #1, #2 and #3 through
    their prepared forms: each launch counted."""
    from imagestitching_tpu_torch.parallel.batch import BatchedStitch

    plan, imgs = _job("lanczos3-k97")
    n = sum(geometry.placement_copy_offsets(p, plan.filter) is None
            for p in plan.placements)
    counts = [cuda_resize.launches, cuda_resize.batch_launches,
              cuda_resize.window_launches]
    got = cuda_resize.stitch(plan, imgs, card).cpu().numpy()
    both = BatchedStitch(plan, 2, device=card)(
        [np.stack([a, a]) for a in imgs])
    banded, _ = pipeline._run_banded(plan, imgs, 3, 64, "auto", card,
                                     lambda *_: None)
    assert np.array_equal(both[0], got) and np.array_equal(both[1], got)
    assert np.array_equal(banded, got)
    assert cuda_resize.launches - counts[0] == n
    assert cuda_resize.batch_launches - counts[1] == n
    assert cuda_resize.window_launches - counts[2] > n
