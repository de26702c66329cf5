"""Six 48 MP photos side by side in mode ``max`` (the benchmark's
``phone48mp_h6_max`` configuration) on the port's plain path and its
streamed rung, here on the CPU.

At full size the layout and the plan are host math alone: the port's
``solve`` equals the frozen reference's rect for rect (a 50,420 x 8064
canvas, under the side cap, so nothing shrinks), and the default 2 GB
budget streams it (the resident rung would need more than the budget), with
one fence a job.

Six array images are under the big-task line, so ``api.stitch`` takes the
plain path: ``prepare``, ``stitch_arrays``, ``pipeline.run``.  The job runs
at the configuration's shapes divided by 8 with the budget divided by 64,
which again streams with one fence: the landscape sources upscaled to the
portrait height, the rotated portrait ones identity copies.  Each canvas is
held to the float64 reference of its own sources (``stitchbench/
reference/``: within 1 uint8 step on resampled values, exact on copies and
background), the spans of the path are checked (``prepare``, ``streamed``
with its ``stream.*`` phases, ``readback``: their tree, their back-to-back
boundaries and their counts), and a budget below the canvas's bytes bands
the same canvas.
"""

import os
import threading
import time

import numpy as np
import pytest

from imagestitching_tpu_torch import RuntimeConfig, api
from imagestitching_tpu_torch.config import MemoryBudget
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.runtime import pipeline, spans, tiler
from stitchbench import deploy, harness
from stitchbench.reference.stitch import compare

CONFIG = harness.load_json(os.path.join(
    harness.ROOT, "stitchbench", "configs", "phone48mp_h6_max.json"))
OPTIONS = deploy.options(CONFIG)
SCALE = 8
SMALL = deploy.shapes(CONFIG, SCALE)
# the full-size job's budget, scaled with its area
BUDGET = MemoryBudget(hbm_bytes=MemoryBudget().hbm_bytes // SCALE ** 2)
ENGINES = ["auto", "torch"]
# the six placements: landscape ones resampled, rotated portrait ones copied
COPIED = [False, True, False, True, False, True]


def _plan(shapes):
    return solve([ImageSpec(w, h, o) for w, h, o in shapes], OPTIONS)


def _fence_after(plan, budget):
    """For each drawn source, whether the streamed rung's fence fires after
    it: the uploaded bytes since the last fence pass ``_fence_limit``."""
    limit = pipeline._fence_limit(plan, 3, RuntimeConfig(budget=budget))
    fired, inflight = [], 0
    for p in plan.placements:
        inflight += p.raw_h * p.raw_w * 3
        fired.append(inflight > limit)
        if fired[-1]:
            inflight = 0
    return fired


def test_full_size_layout_equals_the_reference_rect_for_rect():
    shapes = deploy.shapes(CONFIG)
    plan = _plan(shapes)
    ref = deploy.layout(CONFIG, shapes)
    assert (plan.canvas_w, plan.canvas_h) == (ref.canvas_w, ref.canvas_h) \
        == (50420, 8064)
    assert len(plan.placements) == len(ref.rects) == 6
    for p, r in zip(plan.placements, ref.rects):
        assert (p.x0, p.y0, p.w, p.h) == (r.x0, r.y0, r.w, r.h)
        assert (p.col_span, p.row_span) == (r.col_span, r.row_span)
        assert (p.raw_w, p.raw_h, p.orientation) == (r.raw_w, r.raw_h,
                                                      r.orientation)
    assert [p.col_span for p in plan.placements] == [
        (0, 10752), (10756, 16804), (16808, 27560), (27564, 33612),
        (33616, 44368), (44372, 50420)]
    assert all(p.row_span == (0, 8064) for p in plan.placements)
    assert [geometry.placement_copy_offsets(p, plan.filter) is not None
            for p in plan.placements] == COPIED


def test_full_size_plan_streams_under_the_default_budget():
    plan = _plan(deploy.shapes(CONFIG))
    budget = MemoryBudget()
    ex = tiler.plan_execution(plan, budget, 3)
    assert ex.strategy == "streamed"
    assert ex.est_peak_bytes <= budget.hbm_bytes \
        < tiler.resident_peak_bytes(plan, 3)
    assert plan.canvas_h * plan.canvas_w * 3 == 1_219_760_640
    # one fence a job, after the fourth 146 MB source
    assert _fence_after(plan, budget) == [False] * 3 + [True] + [False] * 2


@pytest.mark.parametrize("scale,strategy", [(8, "streamed"), (16, "banded")])
def test_small_job_scales_the_full_size_plan(scale, strategy):
    """At 1/8 the scaled budget streams with the full-size job's fence; at
    1/16 the scaled budget is under the streamed estimate and bands."""
    plan = _plan(deploy.shapes(CONFIG, scale))
    budget = MemoryBudget(hbm_bytes=MemoryBudget().hbm_bytes // scale ** 2)
    assert tiler.plan_execution(plan, budget, 3).strategy == strategy
    assert [geometry.placement_copy_offsets(p, plan.filter) is not None
            for p in plan.placements] == COPIED
    if strategy == "streamed":
        assert _fence_after(plan, budget) == _fence_after(
            _plan(deploy.shapes(CONFIG)), MemoryBudget())


def _items(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, 3), np.uint8), o)
            for w, h, o in SMALL]


def _stitch(items, engine, budget=BUDGET):
    """The job through the port's front door, and the records this thread
    wrote under its ``stitch`` root, in the order they were opened."""
    t0 = time.perf_counter_ns()
    out, m = api.stitch(items, options=OPTIONS,
                        config=RuntimeConfig(device="cpu", budget=budget,
                                             engine=engine),
                        return_metrics=True)
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    me = threading.get_ident()
    (root,) = [r for r in records if r.name == "stitch" and not r.parent
               and r.thread == me and r.start_ns >= t0]
    kids = sorted((r for r in records if r.job == root.job
                   and r is not root), key=lambda r: (r.start_ns, r.seq))
    return out, m, root, kids


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("engine", ENGINES)
def test_streamed_job_holds_to_the_reference(engine, seed):
    items = _items(seed)
    out, m, _, _ = _stitch(items, engine)
    assert m.strategy == "streamed"
    layout = deploy.layout(CONFIG, SMALL)
    assert out.shape == (layout.canvas_h, layout.canvas_w, 3)
    got = compare(layout, [a for a, _ in items], out)
    assert got["resampled_max_diff"] <= 1
    assert got["exact_max_diff"] == 0


@pytest.mark.parametrize("engine", ENGINES)
def test_plain_path_spans(engine):
    items = _items(7)
    _, m, root, kids = _stitch(items, engine)
    assert m.strategy == "streamed"
    assert all(r.thread == root.thread for r in kids)

    # under the root: prepare, the rung, the readback, one after another
    top = [r for r in kids if r.parent == root.span]
    assert [r.name for r in top] == ["prepare", "streamed", "readback"]
    prepare, streamed, readback = top
    assert prepare.end_ns <= streamed.start_ns
    assert streamed.end_ns <= readback.start_ns <= readback.end_ns \
        <= root.end_ns
    assert prepare.counts is None
    assert m.prepare_s == (prepare.end_ns - prepare.start_ns) / 1e9
    assert m.readback_s == (readback.end_ns - readback.start_ns) / 1e9
    # a CPU canvas is read back unpinned
    assert set(readback.counts) == {"new_pages", "pinned_new"}
    assert readback.counts["pinned_new"] == 0

    # under the rung: each source's upload and draw, and the fence after
    # the fourth, back to back
    stream = [r for r in kids if r.parent == streamed.span]
    assert len(stream) == len(kids) - 3
    fired = _fence_after(_plan(SMALL), BUDGET)
    want = []
    for f in fired:
        want += ["stream.h2d", "stream.draw"] + ["stream.fence"] * f
    assert [r.name for r in stream] == want
    assert all(b.start_ns == a.end_ns for a, b in zip(stream, stream[1:]))
    assert all(streamed.start_ns <= r.start_ns <= r.end_ns
               <= streamed.end_ns for r in stream)
    sizes = [a.nbytes for a, _ in items]
    assert streamed.counts == {"fences": sum(fired)}
    assert [r.counts for r in stream if r.name == "stream.h2d"] == [
        {"bytes": n} for n in sizes]
    assert all(r.counts is None for r in stream
               if r.name in ("stream.draw", "stream.fence"))


@pytest.mark.parametrize("engine", ENGINES)
def test_a_budget_below_the_canvas_bands_the_same_canvas(engine):
    items = _items(5)
    streamed, m, _, _ = _stitch(items, engine)
    assert m.strategy == "streamed"
    plan = _plan(SMALL)
    tight = MemoryBudget(hbm_bytes=plan.canvas_h * plan.canvas_w * 3 - 1)
    assert tiler.plan_execution(plan, tight, 3).strategy == "banded"
    banded, m, _, kids = _stitch(items, engine, tight)
    assert m.strategy == "banded"
    assert "streamed" not in {r.name for r in kids}
    np.testing.assert_array_equal(banded, streamed)
