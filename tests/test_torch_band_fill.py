"""The banded rung's host canvas: the background is written only where no
drawn placement's rect lands (``runtime.pipeline._fill_uncovered``).

On a canvas preset to a sentinel, every pixel inside a drawn rect keeps
the sentinel and every other pixel reads the background, for 3-channel
jobs on a grey and a coloured background and for 1-channel ones; the
count of bytes written is the uncovered area's.  Both banded paths (the
kernel path on the CPU window version, ``engine="auto"``, and the plain
executor, ``engine="torch"``) then give canvases byte-equal to those of
the full background fill they replaced, kept here as ``_full_fill``.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from imagestitching_tpu_torch import StitchOptions
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.runtime import pipeline
from stitchbench import deploy, harness

CPU = torch.device("cpu")
SENTINEL = 77
GREY, COLOUR = (255, 255, 255), (10, 200, 30)


def _full_fill(plan, channels, drawn):
    """The fill the banded rung had before: the whole canvas."""
    del drawn
    out = np.empty((plan.canvas_h, plan.canvas_w, channels), np.uint8)
    out[:] = np.asarray(plan.background[:channels], np.uint8)
    return out, out.nbytes


def _shift(p, rows=0, col_span=None):
    """``p`` moved up by ``rows`` (its rect and its continuous box alike),
    or with another ``col_span``."""
    kw = dict(y0=p.y0 - rows,
              row_span=(p.row_span[0] - rows, p.row_span[1] - rows))
    if col_span is not None:
        kw["col_span"] = col_span
    return dataclasses.replace(p, **kw)


def _overlapping(plan):
    """Every placement after the first moved 5 rows up: each overlaps the
    one before, and the canvas's last rows are left bare."""
    return dataclasses.replace(plan, placements=tuple(
        p if i == 0 else _shift(p, rows=5)
        for i, p in enumerate(plan.placements)))


def _one_empty(plan):
    """Placement 1 with an empty column span: it covers nothing."""
    c0 = plan.placements[1].col_span[0]
    return dataclasses.replace(plan, placements=tuple(
        _shift(p, col_span=(c0, c0)) if i == 1 else p
        for i, p in enumerate(plan.placements)))


# (name, specs, options, plan transform)
PLANS = {
    "vertical-original": (
        [(40, 30, 1), (25, 20, 1), (33, 50, 6)],
        dict(direction="vertical", mode="original", gap=3), None),
    "horizontal-original": (
        [(30, 40, 1), (20, 25, 3), (50, 33, 1)],
        dict(direction="horizontal", mode="original", gap=2), None),
    "gapless-strip": (
        [(32, 24, 1)] * 3,
        dict(direction="vertical", mode="min", gap=0), None),
    "overlapping": (
        [(36, 28, 1), (48, 30, 1), (30, 30, 8)],
        dict(direction="vertical", mode="min", gap=0), _overlapping),
    "overlapping-nested": (
        [(48, 30, 1), (24, 30, 1), (40, 30, 1)],
        dict(direction="vertical", mode="original", gap=0), _overlapping),
    "empty-span": (
        [(36, 28, 1), (48, 30, 1), (30, 30, 1)],
        dict(direction="vertical", mode="max", gap=1), _one_empty),
}
# (channels, background)
COLOURS = [(3, GREY), (3, COLOUR), (1, COLOUR), (1, GREY)]


def _plan(name, background):
    specs, kw, transform = PLANS[name]
    plan = solve([ImageSpec(*s) for s in specs],
                 StitchOptions(background=background, supersample=False,
                               **kw))
    return transform(plan) if transform else plan


def _covered(plan, drawn):
    mask = np.zeros((plan.canvas_h, plan.canvas_w), bool)
    for p in plan.placements:
        if p.index in drawn:
            (r0, r1), (c0, c1) = p.row_span, p.col_span
            mask[r0:r1, c0:c1] = True
    return mask


def _drawable(plan):
    return {p.index for p in plan.placements
            if p.row_span[1] > p.row_span[0]
            and p.col_span[1] > p.col_span[0]}


@pytest.mark.parametrize("channels,background", COLOURS,
                         ids=["rgb-grey", "rgb-colour", "gray-colour",
                              "gray-grey"])
@pytest.mark.parametrize("name", list(PLANS))
def test_fill_leaves_drawn_rects_alone(name, channels, background):
    plan = _plan(name, background)
    drawn = {p.index for p in plan.placements}
    out = np.full((plan.canvas_h, plan.canvas_w, channels), SENTINEL,
                  np.uint8)
    written = pipeline._fill_uncovered(out, plan, drawn)
    covered = _covered(plan, drawn)
    assert (out[covered] == SENTINEL).all()
    assert (out[~covered] == np.asarray(background[:channels],
                                        np.uint8)).all()
    assert written == int((~covered).sum()) * channels
    if name == "gapless-strip":
        assert covered.all() and written == 0
    else:
        assert 0 < written < out.nbytes


def test_fill_of_the_empty_span_is_where_its_rows_are_bare():
    plan = _plan("empty-span", COLOUR)
    (r0, r1) = plan.placements[1].row_span
    out = np.full((plan.canvas_h, plan.canvas_w, 3), SENTINEL, np.uint8)
    pipeline._fill_uncovered(out, plan, {0, 1, 2})
    assert r1 > r0 and (out[r0:r1] == COLOUR).all()


def test_fill_skips_only_the_drawn_placements():
    plan = _plan("vertical-original", COLOUR)
    out = np.full((plan.canvas_h, plan.canvas_w, 3), SENTINEL, np.uint8)
    written = pipeline._fill_uncovered(out, plan, {0, 2})
    covered = _covered(plan, {0, 2})
    assert (out[covered] == SENTINEL).all()
    assert (out[~covered] == COLOUR).all()
    (r0, r1), (c0, c1) = plan.placements[1].row_span, \
        plan.placements[1].col_span
    assert (out[r0:r1, c0:c1] == COLOUR).all()
    assert written == int((~covered).sum()) * 3


def test_fill_with_nothing_drawn_is_the_whole_canvas():
    plan = _plan("horizontal-original", COLOUR)
    out, written = pipeline._host_canvas(plan, 3, set())
    assert (out == COLOUR).all() and written == out.nbytes


def test_full_size_48mp_plan_fills_its_36_gap_rows():
    """The ``phone48mp_max`` job at full size: all nine rects span the
    canvas's width, so the fill is the 8 gaps and the 7 rows at the bottom.
    The canvas here is a zero-stride view of one pixel: only the bytes the
    fill writes are touched, not the 1.42 GB of a real one."""
    config = harness.load_json(os.path.join(
        harness.ROOT, "stitchbench", "configs", "phone48mp_max.json"))
    plan = solve([ImageSpec(*s) for s in deploy.shapes(config)],
                 deploy.options(config))
    view = np.lib.stride_tricks.as_strided(
        np.zeros(3, np.uint8), (plan.canvas_h, plan.canvas_w, 3), (0, 0, 1))
    assert view.flags.writeable
    written = pipeline._fill_uncovered(view, plan, _drawable(plan))
    bare = plan.canvas_h - sum(p.row_span[1] - p.row_span[0]
                               for p in plan.placements)
    assert all(p.col_span == (0, plan.canvas_w) for p in plan.placements)
    assert bare == 36
    assert written == bare * plan.canvas_w * 3 == 778_788


def _images(plan, channels, seed):
    rng = np.random.default_rng(seed)
    shape = (lambda p: (p.raw_h, p.raw_w)) if channels == 1 else \
        (lambda p: (p.raw_h, p.raw_w, channels))
    return [rng.integers(0, 256, shape(p), np.uint8)
            for p in plan.placements]


@pytest.mark.parametrize("channels,background", COLOURS[:3],
                         ids=["rgb-grey", "rgb-colour", "gray-colour"])
@pytest.mark.parametrize("engine", ["auto", "torch"])
@pytest.mark.parametrize("name", list(PLANS))
def test_banded_paths_equal_the_full_fill(name, engine, channels,
                                            background, monkeypatch):
    plan = _plan(name, background)
    imgs = _images(plan, channels, seed=len(name) + channels)

    def banded():
        out, _ = pipeline._run_banded(plan, imgs, channels, 8, engine, CPU,
                                      pipeline._noop)
        return out

    got = banded()
    monkeypatch.setattr(pipeline, "_host_canvas", _full_fill)
    want = banded()
    assert got.shape == want.shape == (plan.canvas_h, plan.canvas_w,
                                       channels)
    np.testing.assert_array_equal(got, want)
