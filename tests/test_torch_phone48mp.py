"""Nine 48 MP photos in mode ``max`` (the benchmark's ``phone48mp_max``
configuration) on the port's banded rung, here on the CPU.

At full size the layout is host math alone: the port's ``solve`` equals the
frozen reference's rect for rect (the 8064-wide natural canvas meets the
65,536-row side cap and shrinks to 7211 x 65536), and the default 2 GB
budget bands it in 2048 rows, 35 chunks of kernel #3.

The job itself runs at the configuration's shapes divided by 16 with the
side cap and the budget scaled alike (65,536 / 16 rows, 2 GB / 256), so it
takes ``overlapped/banded`` with 128-row bands and again 35 chunks: every
placement resampled, the landscape sources down and the rotated portrait
ones up.  Without the cap the landscape sources are identity copies (host
blits).  Each canvas is held to the float64 reference of its own sources
(``stitchbench/reference/``: within 1 uint8 step on resampled values,
exact on copies and background), and the rung's ``band.*`` spans are
checked: their tree, their back-to-back boundaries and their counts, the
fill's ``bytes`` the area no placement covers.
"""

import os
import threading
import time

import numpy as np
import pytest

from imagestitching_tpu_torch import RuntimeConfig, api
from imagestitching_tpu_torch.config import CanvasLimits, MemoryBudget
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.runtime import spans, tiler
from stitchbench import deploy, harness
from stitchbench.reference import layout as ref_layout
from stitchbench.reference.stitch import compare

CONFIG = harness.load_json(os.path.join(
    harness.ROOT, "stitchbench", "configs", "phone48mp_max.json"))
OPTIONS = deploy.options(CONFIG)
SCALE = 16
SMALL = deploy.shapes(CONFIG, SCALE)
# the full-size job's side cap and budget, scaled with its sides and area
CAPPED = CanvasLimits(max_side=CanvasLimits().max_side // SCALE)
BUDGET = MemoryBudget(hbm_bytes=MemoryBudget().hbm_bytes // SCALE ** 2)
CHUNK = ("band.crop", "band.h2d", "band.draw", "band.readback")


def _plan(shapes, limits=None):
    return solve([ImageSpec(w, h, o) for w, h, o in shapes], OPTIONS,
                 limits)


def _chunks(plan, band_rows):
    return [WindowPlan(p, plan.filter, band_rows).n_chunks
            for p in plan.placements
            if geometry.placement_copy_offsets(p, plan.filter) is None]


def test_full_size_layout_equals_the_reference_rect_for_rect():
    shapes = deploy.shapes(CONFIG)
    plan = _plan(shapes)
    ref = deploy.layout(CONFIG, shapes)
    assert (plan.canvas_w, plan.canvas_h) == (ref.canvas_w, ref.canvas_h) \
        == (7211, 65536)
    assert len(plan.placements) == len(ref.rects) == 9
    for p, r in zip(plan.placements, ref.rects):
        assert (p.x0, p.y0, p.w, p.h) == (r.x0, r.y0, r.w, r.h)
        assert (p.col_span, p.row_span) == (r.col_span, r.row_span)
        assert (p.raw_w, p.raw_h, p.orientation) == (r.raw_w, r.raw_h,
                                                      r.orientation)


def test_full_size_plan_bands_under_the_default_budget():
    plan = _plan(deploy.shapes(CONFIG))
    ex = tiler.plan_execution(plan, MemoryBudget(), 3)
    assert (ex.strategy, ex.band_rows) == ("banded", 2048)
    assert ex.est_peak_bytes <= MemoryBudget().hbm_bytes
    # every placement resamples: 5 landscape in 3 chunks, 4 portrait in 5
    assert sorted(_chunks(plan, ex.band_rows)) == [3] * 5 + [5] * 4


def test_small_job_scales_the_full_size_plan():
    plan = _plan(SMALL, CAPPED)
    ex = tiler.plan_execution(plan, BUDGET, 3)
    assert (ex.strategy, ex.band_rows) == ("banded", 2048 // SCALE)
    assert sum(_chunks(plan, ex.band_rows)) == 35


def _items(seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (h, w, 3), np.uint8), o)
            for w, h, o in SMALL]


def _stitch(items, limits):
    """The job through the port's front door, and the records this thread
    wrote under its ``stitch`` root."""
    t0 = time.perf_counter_ns()
    out, m = api.stitch(items, options=OPTIONS,
                        config=RuntimeConfig(device="cpu", budget=BUDGET),
                        limits=limits, return_metrics=True)
    records, dropped = spans.snapshot(t0, time.perf_counter_ns())
    assert not dropped
    me = threading.get_ident()
    (root,) = [r for r in records if r.name == "stitch" and not r.parent
               and r.thread == me and r.start_ns >= t0]
    return out, m, root, [r for r in records if r.job == root.job
                          and r is not root]


CASES = [("capped", CAPPED, 4096), ("uncapped", None, None)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case,limits,side", CASES,
                         ids=[c for c, _, _ in CASES])
def test_banded_job_holds_to_the_reference(case, limits, side, seed,
                                           monkeypatch):
    del case
    items = _items(seed)
    out, m, _, _ = _stitch(items, limits)
    assert m.strategy == "overlapped/banded"
    if side is not None:
        # the frozen reference's side cap, scaled as the port's limits are
        monkeypatch.setattr(ref_layout, "MAX_SIDE", side)
    layout = deploy.layout(CONFIG, SMALL)
    assert out.shape == (layout.canvas_h, layout.canvas_w, 3)
    got = compare(layout, [a for a, _ in items], out)
    assert got["resampled_max_diff"] <= 1
    assert got["exact_max_diff"] == 0


@pytest.mark.parametrize("case,limits,side", CASES,
                         ids=[c for c, _, _ in CASES])
def test_band_spans(case, limits, side):
    del case, side
    plan = _plan(SMALL, limits)
    band_rows = tiler.plan_execution(plan, BUDGET, 3).band_rows
    per_placement = _chunks(plan, band_rows)
    blits = len(plan.placements) - len(per_placement)
    _, _, root, kids = _stitch(_items(7), limits)

    (banded,) = [r for r in kids if r.name == "banded"]
    assert banded.parent == root.span
    assert banded.counts == {"chunks": sum(per_placement),
                             "band_rows": band_rows}
    band = [r for r in kids if r.name.startswith("band.")]
    assert band and all(r.parent == banded.span and r.job == root.job
                        for r in band)
    assert all(banded.start_ns <= r.start_ns <= r.end_ns <= banded.end_ns
               for r in band)
    names = [r.name for r in band]
    assert names.count("band.fill") == 1 and names[0] == "band.fill"
    assert names.count("band.blit") == blits
    assert names.count("band.prepare") == len(per_placement)
    assert all(names.count(c) == sum(per_placement) for c in CHUNK)

    # after each prepare its chunks' phases, each starting at the reading
    # that closed the one before
    i = 0
    for n in per_placement:
        while band[i].name != "band.prepare":
            i += 1
        run = band[i:i + 1 + 4 * n]
        assert [r.name for r in run[1:]] == list(CHUNK) * n
        assert all(b.start_ns == a.end_ns for a, b in zip(run, run[1:]))
        i += 1 + 4 * n
    # the fill writes the background only where no placement lands
    (fill,) = [r for r in band if r.name == "band.fill"]
    bare = np.ones((plan.canvas_h, plan.canvas_w), bool)
    for p in plan.placements:
        bare[slice(*p.row_span), slice(*p.col_span)] = False
    assert fill.counts == {"bytes": int(bare.sum()) * 3}
    if limits is not None:
        assert 0 < fill.counts["bytes"] < plan.canvas_h * plan.canvas_w * 3
    for r in band:
        if r.name in ("band.crop", "band.h2d"):
            assert r.counts["bytes"] > 0
        elif r.name != "band.fill":
            assert r.counts is None
    crops = [r.counts["bytes"] for r in band if r.name == "band.crop"]
    assert crops == [r.counts["bytes"] for r in band if r.name == "band.h2d"]
