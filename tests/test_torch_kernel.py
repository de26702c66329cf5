"""The CUDA resize-and-place kernels (single-job, batched and windowed)
against their plain PyTorch version, on the card.  The kernels have no CPU mode, so every
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
one.  Whole jobs are held to the float64 oracle within 1 step.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu.config import CanvasLimits, StitchOptions
from imagestitching_tpu.core import geometry, oracle
from imagestitching_tpu.core.layout import ImageSpec, solve
from imagestitching_tpu.runtime import tiler
from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig, StitchServer
from imagestitching_tpu_torch.ops import _build, cuda_resize, torch_compose
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.runtime import pipeline

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
    untouched, and the chunks together equal kernel #1's region."""
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
        for g in range(wp.n_chunks):
            a, valid, _ = wp.chunk_window(g)
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
