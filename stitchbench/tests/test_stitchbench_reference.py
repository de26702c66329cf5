"""The frozen reference and the comparison that decides ``correct``.

The reference (``stitchbench/reference``) imports nothing of the port;
these tests hold it to the port's own layout solver and float64 oracle,
and to canvases worked out by hand.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch import StitchOptions
from imagestitching_tpu_torch.core import oracle
from imagestitching_tpu_torch.core.layout import ImageSpec, solve

from stitchbench.reference import layout as ref_layout
from stitchbench.reference import stitch as ref

CASES = [
    ([(40, 30, 1), (30, 40, 6), (25, 17, 3), (17, 25, 8)], "vertical", "min",
     4),
    ([(40, 30, 2), (31, 45, 5), (60, 20, 7), (9, 9, 4)], "horizontal", "max",
     3.5),
    ([(40, 30, 1), (33, 21, 6), (12, 50, 1)], "vertical", "original", 0),
    ([(64, 48, 1)] * 3 + [(48, 64, 6)], "horizontal", "min", 20),
]


@pytest.mark.parametrize("shapes,direction,mode,gap", CASES)
def test_layout_equals_port_solver(shapes, direction, mode, gap):
    plan = solve([ImageSpec(*s) for s in shapes],
                 StitchOptions(direction=direction, mode=mode, gap=gap))
    lay = ref_layout.solve(shapes, direction, mode, gap)
    assert (lay.canvas_w, lay.canvas_h) == (plan.canvas_w, plan.canvas_h)
    for r, p in zip(lay.rects, plan.placements):
        assert (r.x0, r.y0, r.w, r.h) == (p.x0, p.y0, p.w, p.h)
        assert (r.col_span, r.row_span) == (p.col_span, p.row_span)


@pytest.mark.parametrize("shapes,direction,mode,gap", CASES)
def test_render_equals_port_oracle(shapes, direction, mode, gap):
    rng = np.random.default_rng(7)
    raws = [rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in shapes]
    plan = solve([ImageSpec(*s) for s in shapes],
                 StitchOptions(direction=direction, mode=mode, gap=gap))
    want = oracle.stitch(plan, raws)
    got = ref.render(ref_layout.solve(shapes, direction, mode, gap), raws)
    assert np.array_equal(got.numpy(), want)


def test_hand_worked_canvas():
    # a 2x1 source drawn at width 4 (2x up) above a 4x2 copy, gap 1:
    # bilinear with half-pixel centres gives 10, 10+2.5, 10+7.5, 20
    a = np.array([[[10, 0, 255], [20, 100, 0]]], np.uint8)        # 1x2
    b = np.full((2, 4, 3), 7, np.uint8)
    lay = ref_layout.solve([(2, 1, 1), (4, 2, 1)], "vertical", "max", 1)
    assert (lay.canvas_w, lay.canvas_h) == (4, 5)
    out = ref.render(lay, [a, b]).numpy()
    assert out[0, :, 0].tolist() == [10, 13, 18, 20]       # 12.5 -> 13
    assert out[0, :, 2].tolist() == [255, 191, 64, 0]      # 191.25, 63.75
    assert out[1].tolist() == out[0].tolist()              # 2 rows of a
    assert (out[2] == 255).all()                           # the gap
    assert (out[3:] == 7).all()


def test_orientation_hand_worked():
    # orientation 6 (rotate 90 clockwise) of a 2x3 raw: a copy
    raw = np.arange(6, dtype=np.uint8).reshape(2, 3, 1).repeat(3, axis=2)
    lay = ref_layout.solve([(3, 2, 6)], "vertical", "min", 0)
    assert (lay.canvas_w, lay.canvas_h) == (2, 3)
    out = ref.render(lay, [raw]).numpy()[..., 0]
    assert out.tolist() == [[3, 0], [4, 1], [5, 2]]
    assert ref.is_copy(lay.rects[0])


def _job(seed=3):
    shapes = [(40, 30, 1), (40, 30, 6), (40, 30, 3)]
    rng = np.random.default_rng(seed)
    raws = [rng.integers(0, 256, (h, w, 3), np.uint8) for w, h, _ in shapes]
    return ref_layout.solve(shapes, "vertical", "min", 4), raws


def test_compare_sound_and_faulty_canvases():
    lay, raws = _job()
    good = ref.render(lay, raws).numpy()
    assert ref.compare(lay, raws, good) == {
        "resampled_max_diff": 0.0, "mismatch_ppm": 0.0,
        "exact_max_diff": 0.0}
    off = good.copy()
    r0, r1 = lay.rects[0].row_span
    off[r0, 0, 0] ^= 1                       # one resampled value off by 1
    got = ref.compare(lay, raws, off)
    assert got["resampled_max_diff"] == 1.0 and got["mismatch_ppm"] > 0
    gap = good.copy()
    gap[r1, 0, 1] = 0                        # the gap row below rect 0
    assert ref.compare(lay, raws, gap)["exact_max_diff"] == 255.0
    copy = good.copy()
    c0 = lay.rects[1].row_span[0]
    copy[c0, 3, 2] += 1                      # the rotated copy
    assert ref.is_copy(lay.rects[1])
    assert ref.compare(lay, raws, copy)["exact_max_diff"] == 1.0
    _, other = _job(4)                       # a batch-mate's canvas
    assert ref.compare(lay, raws, ref.render(lay, other).numpy())[
        "resampled_max_diff"] > 1.0
    assert ref.compare(lay, raws, good[:-1])["exact_max_diff"] == 255.0


def test_bfloat16_control_is_rejected():
    lay, raws = _job()
    got = ref.compare(lay, raws, ref.render(lay, raws, dtype=torch.bfloat16))
    assert got["resampled_max_diff"] > 1.0
    assert got["mismatch_ppm"] > 100_000
