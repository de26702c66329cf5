"""The port's own copies of the JAX package's host layers, held equal to
their originals on the same inputs.

The port imports nothing of :mod:`imagestitching_tpu`: it keeps its own
copies of the layout solver, the grid planner, the f64 taps, the oracle,
the tiler, the codec, the decode pool, the caches, the logger, the host
half of the overlap detector and ``api.prepare``
(``imagestitching_tpu_torch/{core,runtime,imgio,ops/overlap}``,
``config.py``, ``api.py``).  Those copies are the layout contract, so a
drift between a copy and its original is a fault.  The behaviour tests
feed one seeded input (numpy ``default_rng``) to both and ask for
equality: plans field by field, taps, canvases and decoded pixels bit for
bit, byte counts exactly.  No tolerance.  The last tests hold each copy's
code, parsed with ``ast`` and with its docstrings taken out, equal to its
original's, module by module (and function by function for
``ops/overlap.py``).
"""

import ast
import dataclasses
import os

import numpy as np
import pytest

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import geometry as jax_geometry
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle as jax_oracle
from imagestitching_tpu.imgio import codec as jax_codec
from imagestitching_tpu.runtime import tiler as jax_tiler
from imagestitching_tpu_torch import api, config
from imagestitching_tpu_torch.core import geometry, layout, oracle
from imagestitching_tpu_torch.imgio import codec
from imagestitching_tpu_torch.runtime import tiler

_GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_v1.npz")
# tests/test_golden.py's job
_GOLDEN_SHAPES = [(40, 30, 1), (24, 36, 6), (32, 32, 3), (28, 44, 8)]
_GOLDEN_OPTS = dict(direction="horizontal", mode="min", gap=3.5,
                    supersample=False, background=(250, 128, 7))
_FILTERS = ("bilinear", "triangle", "box", "lanczos3")


def _random_job(seed):
    """``(shapes, option kwargs, limits kwargs or None)`` of a seeded job:
    2-6 images of 1-300 px a side, any orientation and filter, a
    fractional gap, supersampling and canvas caps on some seeds."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 7))
    shapes = [(int(rng.integers(1, 301)), int(rng.integers(1, 301)),
               int(rng.integers(1, 9))) for _ in range(n)]
    opts = dict(direction=("vertical", "horizontal")[seed % 2],
                mode=("min", "max", "original")[seed % 3],
                gap=float(np.round(rng.uniform(0, 12), 2)),
                supersample=bool(rng.integers(0, 2)),
                filter=_FILTERS[int(rng.integers(0, 4))],
                background=tuple(int(v) for v in rng.integers(0, 256, 3)))
    limits = None
    if rng.integers(0, 2):
        side = int(rng.integers(64, 600))
        limits = dict(max_side=side,
                      max_pixels=int(side * rng.integers(64, side + 1)),
                      max_supersample=float(rng.choice([1.0, 2.2, 2.6])))
    return shapes, opts, limits


def _both(shapes, opts, limits=None):
    """``(port plan, JAX plan)`` of one job, each from its own types."""
    port = layout.solve(
        [layout.ImageSpec(w, h, o) for w, h, o in shapes],
        config.StitchOptions(**opts),
        None if limits is None else config.CanvasLimits(**limits))
    ref = jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(**opts),
        None if limits is None else jax_config.CanvasLimits(**limits))
    return port, ref


def _assert_plans_equal(got, want):
    assert type(got) is not type(want)          # two packages, two types
    for f in dataclasses.fields(want):
        if f.name == "placements":
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert len(got.placements) == len(want.placements)
    for p, q in zip(got.placements, want.placements):
        for f in dataclasses.fields(q):
            assert getattr(p, f.name) == getattr(q, f.name), (q.index, f.name)
    assert got.signature() == want.signature()


def _images(shapes, seed, c=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, c), np.uint8) for w, h, _ in shapes]


# ---------------------------------------------------------------------------
# config and layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["CanvasLimits", "MemoryBudget",
                                  "StitchOptions"])
def test_config_types_have_the_same_fields_and_defaults(name):
    got, want = getattr(config, name), getattr(jax_config, name)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
        (f.name, f.default) for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got()) == dataclasses.asdict(want())
    if name == "CanvasLimits":
        assert dataclasses.asdict(got.reference_ios()) == dataclasses.asdict(
            want.reference_ios())
        assert dataclasses.asdict(got.reference_android(2048)) == \
            dataclasses.asdict(want.reference_android(2048))


def test_config_constants_equal():
    for name in ("DIRECTIONS", "MODES", "SUPPORTED_TYPES"):
        assert getattr(config, name) == getattr(jax_config, name)


@pytest.mark.parametrize("kw", [dict(direction="diagonal"), dict(mode="x"),
                                dict(gap=-1.0), dict(filter="cubic"),
                                dict(merge_threshold=-0.5),
                                dict(background=(1, 2)),
                                dict(background=[1, 2, 3]),
                                dict(background=(0, 0, 256))])
def test_options_validate_alike(kw):
    def outcome(cls):
        try:
            return ("ok", dataclasses.asdict(cls(**kw).validate()))
        except ValueError as e:
            return ("error", str(e))

    assert outcome(config.StitchOptions) == outcome(jax_config.StitchOptions)


def test_solve_matches_jax_on_the_golden_job():
    port, ref = _both(_GOLDEN_SHAPES, _GOLDEN_OPTS)
    _assert_plans_equal(port, ref)


@pytest.mark.parametrize("seed", range(24))
def test_solve_matches_jax_field_by_field(seed):
    """Seeded random jobs over both directions, the three modes, the four
    filters, fractional gaps, supersampling and canvas caps."""
    port, ref = _both(*_random_job(seed))
    _assert_plans_equal(port, ref)


@pytest.mark.parametrize("direction", ["vertical", "horizontal"])
@pytest.mark.parametrize("mode", ["min", "max", "original"])
def test_solve_matches_jax_in_every_direction_and_mode(direction, mode):
    shapes = [(1920, 1080, 1), (1080, 1920, 6), (1440, 1080, 3),
              (1280, 960, 8), (97, 61, 5), (1, 1, 1)]
    for supersample in (False, True):
        opts = dict(direction=direction, mode=mode, gap=4.75,
                    supersample=supersample, max_images=None)
        for limits in (None, dict(max_side=4096, max_pixels=4096 * 4096,
                                  max_supersample=2.6)):
            _assert_plans_equal(*_both(shapes, opts, limits))


def test_solve_errors_alike():
    for shapes, opts in (([], {}),
                         ([(10, 10, 1)] * 10, {}),
                         ([(10, 10, 9)], {})):
        errors = []
        for mod, cfg in ((layout, config), (jax_layout, jax_config)):
            with pytest.raises(ValueError) as e:
                mod.solve([mod.ImageSpec(*s) for s in shapes],
                          cfg.StitchOptions(**opts))
            errors.append(str(e.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# geometry and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", _FILTERS)
def test_filter_taps_and_source_band_match_jax(kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    for _ in range(40):
        m = int(rng.integers(1, 400))
        length = float(rng.uniform(0.5, 3.0) * m if rng.integers(0, 2)
                       else rng.uniform(0.02, 1.0) * m)
        a = float(rng.uniform(-2.0, 50.0))
        lo = int(rng.integers(0, 60))
        hi = lo + int(rng.integers(0, 300))
        i0, w = geometry.filter_taps(lo, hi, a, length, m, kind)
        j0, jw = jax_geometry.filter_taps(lo, hi, a, length, m, kind)
        assert i0.dtype == j0.dtype and w.dtype == jw.dtype
        np.testing.assert_array_equal(i0, j0)
        np.testing.assert_array_equal(w, jw)
        assert geometry.source_band(lo, hi, a, length, m, kind) == \
            jax_geometry.source_band(lo, hi, a, length, m, kind)
        np.testing.assert_array_equal(
            geometry.filter_matrix(lo, hi, a, length, m, kind),
            jax_geometry.filter_matrix(lo, hi, a, length, m, kind))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_helpers_match_jax(orientation):
    img = np.random.default_rng(orientation).integers(
        0, 256, (7, 11, 3), np.uint8)
    np.testing.assert_array_equal(
        geometry.orient_array(img, orientation),
        jax_geometry.orient_array(img, orientation))
    assert geometry.display_size(11, 7, orientation) == \
        jax_geometry.display_size(11, 7, orientation)


def test_oracle_reproduces_the_golden_fixture_bit_exact():
    z = np.load(_GOLDEN)
    imgs = [z[f"img{i}"] for i in range(len(_GOLDEN_SHAPES))]
    port, _ = _both(_GOLDEN_SHAPES, _GOLDEN_OPTS)
    np.testing.assert_array_equal(oracle.stitch(port, imgs), z["out"])


@pytest.mark.parametrize("seed", range(8))
def test_oracle_stitch_is_bit_equal(seed):
    shapes, opts, limits = _random_job(100 + seed)
    port, ref = _both(shapes, opts, limits)
    if port.canvas_w * port.canvas_h > 600_000:
        port, ref = _both(shapes, dict(opts, supersample=False),
                          dict(max_side=400, max_pixels=160_000,
                               max_supersample=1.0))
    imgs = _images(shapes, seed, c=1 + 2 * (seed % 2))
    np.testing.assert_array_equal(oracle.stitch(port, imgs),
                                  jax_oracle.stitch(ref, imgs))
    mid = port.canvas_h // 2
    np.testing.assert_array_equal(
        oracle.stitch_rows(port, imgs, mid - 3, mid + 5),
        jax_oracle.stitch_rows(ref, imgs, mid - 3, mid + 5))
    assert geometry.plan_copy_offsets(port) == \
        jax_geometry.plan_copy_offsets(ref)


# ---------------------------------------------------------------------------
# the tiler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_tiler_matches_jax(seed):
    """``resident_peak_bytes``, ``min_feasible_bytes`` and the strategy and
    band of ``plan_execution`` at budgets across every rung, and the band
    ranges of the chosen band height."""
    shapes, opts, _ = _random_job(200 + seed)
    shapes = [(w * 8, h * 8, o) for w, h, o in shapes]
    port, ref = _both(shapes, opts)
    for c in (1, 3):
        resident = tiler.resident_peak_bytes(port, c)
        assert resident == jax_tiler.resident_peak_bytes(ref, c)
        floor = tiler.min_feasible_bytes(port, c)
        assert floor == jax_tiler.min_feasible_bytes(ref, c)
        canvas = c * port.canvas_w * port.canvas_h
        for hbm in (resident, resident - 1, canvas + canvas // 2,
                    max(floor, canvas // 2), floor, floor - 1):
            got = _execution(tiler, config, port, hbm, c)
            assert got == _execution(jax_tiler, jax_config, ref, hbm, c)
            if got.get("band_rows"):
                assert tiler.band_ranges(port, got["band_rows"]) == \
                    jax_tiler.band_ranges(ref, got["band_rows"])
        assert "error" in _execution(tiler, config, port, floor - 1, c)


def _execution(tiler_mod, config_mod, plan, hbm, c):
    """``plan_execution``'s plan as a dict, or the MemoryError it raises."""
    try:
        return dataclasses.asdict(tiler_mod.plan_execution(
            plan, config_mod.MemoryBudget(hbm), c))
    except MemoryError as e:
        return {"error": str(e)}


# ---------------------------------------------------------------------------
# the codec and prepare
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt,channels", [("png", 3), ("png", 1),
                                          ("jpeg", 3)])
def test_codec_round_trips_match_jax(tmp_path, fmt, channels):
    arr = np.random.default_rng(7).integers(0, 256, (37, 53, channels),
                                            np.uint8)
    blob = codec.encode_bytes(arr, fmt)
    assert blob == jax_codec.encode_bytes(arr, fmt)
    got, want = codec.decode(blob), jax_codec.decode(blob)
    assert got[1] == want[1] == 1
    np.testing.assert_array_equal(got[0], want[0])
    if fmt == "png":
        np.testing.assert_array_equal(got[0], np.broadcast_to(
            arr, arr.shape[:2] + (3,)))
    rgb = np.ascontiguousarray(np.broadcast_to(arr, arr.shape[:2] + (3,)))
    ext = "jpg" if fmt == "jpeg" else fmt
    mine = codec.encode(tmp_path / f"port.{ext}", rgb)
    theirs = jax_codec.encode(tmp_path / f"jax.{ext}", rgb)
    with open(mine, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(codec.decode(mine)[0],
                                  jax_codec.decode(mine)[0])
    assert dataclasses.asdict(codec.get_image_info(mine)) == \
        dataclasses.asdict(jax_codec.get_image_info(mine))


def _items(tmp_path):
    """Files, bytes, plain and oriented arrays, gray, RGBA and LA arrays."""
    rng = np.random.default_rng(31)
    a = rng.integers(0, 256, (20, 30, 3), np.uint8)
    path = tmp_path / "a.png"
    jax_codec.encode(path, a)
    return [str(path), path, jax_codec.encode_bytes(a[::-1], "jpeg"),
            rng.integers(0, 256, (16, 24, 3), np.uint8),
            (rng.integers(0, 256, (12, 18, 3), np.uint8), 6),
            rng.integers(0, 256, (10, 14), np.uint8),
            rng.integers(0, 256, (9, 13, 4), np.uint8),
            rng.integers(0, 256, (8, 12, 2), np.uint8),
            rng.uniform(0, 255, (6, 7, 3)).astype(np.float32)]


def test_prepare_matches_jax(tmp_path):
    items = _items(tmp_path)
    got = api.prepare(items, config.RuntimeConfig(device="cpu"))
    want = jax_api.prepare(items, jax_config.RuntimeConfig())
    assert len(got[0]) == len(want[0]) == len(items)
    for a, b in zip(got[0], want[0]):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert [dataclasses.astuple(s) for s in got[1]] == [
        dataclasses.astuple(s) for s in want[1]]
    assert got[2] == want[2] == []
    for a, b in zip(api._unify_channels(got[0][3:6]),
                    jax_api._unify_channels(want[0][3:6])):
        np.testing.assert_array_equal(a, b)


def test_prepare_skips_the_same_failures_as_jax(tmp_path):
    items = [b"not an image", _items(tmp_path)[3], str(tmp_path / "none.png")]
    got = api.prepare(items, config.RuntimeConfig(device="cpu"), "skip")
    want = jax_api.prepare(items, jax_config.RuntimeConfig(), "skip")
    # failures come in the order the decodes finish
    got_f, want_f = sorted(got[2], key=lambda f: f[0]), sorted(
        want[2], key=lambda f: f[0])
    assert [i for i, _ in got_f] == [i for i, _ in want_f] == [0, 2]
    assert [type(e) for _, e in got_f] == [type(e) for _, e in want_f]
    np.testing.assert_array_equal(got[0][0], want[0][0])


def test_prepare_reads_a_tensor_back_like_its_array():
    """The port's ``_load_one`` takes a ``torch.Tensor`` where the original
    took a JAX array: it equals the same pixels as a numpy array."""
    import torch

    arr = np.random.default_rng(5).integers(0, 256, (9, 11, 4), np.uint8)
    images, specs, _ = api.prepare(
        [torch.from_numpy(arr), (torch.from_numpy(arr[:, :, :3]), 8)],
        config.RuntimeConfig(device="cpu"))
    want, _, _ = jax_api.prepare([arr, (arr[:, :, :3], 8)],
                                 jax_config.RuntimeConfig())
    for a, b in zip(images, want):
        np.testing.assert_array_equal(a, b)
    assert [s.orientation for s in specs] == [1, 8]


# ---------------------------------------------------------------------------
# the code of each copy, docstrings stripped
# ---------------------------------------------------------------------------

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Host modules the port copies whole.  ``imgio/native.py`` (its build
#: paths) and ``config.py`` (the port's ``RuntimeConfig``) differ by design
#: and are held by the behaviour tests above.
_COPIES = ("core/layout", "core/geometry", "core/oracle", "core/grid",
           "imgio/codec", "imgio/heif", "runtime/decoding", "runtime/cache",
           "runtime/artifacts", "runtime/logger", "runtime/tiler")

#: Functions of ``ops/overlap.py`` the port keeps as they are (its device
#: scorer and ``merge_arrays``'s device argument are its own).
_OVERLAP_HOST = ("_scores_numpy", "detect_pair", "detect_trims",
                 "apply_trims")


def _strip_docstrings(tree):
    """``tree`` with the docstring of the module and of every class and
    function taken out."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant) and isinstance(
                    body[0].value.value, str):
                node.body = body[1:] or [ast.Pass()]
    return tree


def _tree(package, module):
    path = os.path.join(_ROOT, package, module + ".py")
    with open(path) as f:
        return _strip_docstrings(ast.parse(f.read(), path))


@pytest.mark.parametrize("module", _COPIES)
def test_host_copy_code_equals_its_original(module):
    """A copy's code, docstrings and comments aside, is its original's: a
    silent edit to either one fails here."""
    assert ast.dump(_tree("imagestitching_tpu_torch", module)) == ast.dump(
        _tree("imagestitching_tpu", module))


@pytest.mark.parametrize("name", _OVERLAP_HOST)
def test_overlap_host_function_equals_its_original(name):
    def function(package):
        found = [n for n in _tree(package, "ops/overlap").body
                 if isinstance(n, ast.FunctionDef) and n.name == name]
        assert len(found) == 1, (package, name)
        return ast.dump(found[0])

    assert function("imagestitching_tpu_torch") == function(
        "imagestitching_tpu")


def test_docstring_strip_sees_code_changes():
    """The comparison is not blind: one changed constant in a copy's code
    makes the dumps differ, and a changed docstring does not."""
    src = 'def f(x):\n    """Doc."""\n    return x + 1\n'
    same = _strip_docstrings(ast.parse(src.replace("Doc.", "Other.")))
    other = _strip_docstrings(ast.parse(src.replace("+ 1", "+ 2")))
    want = ast.dump(_strip_docstrings(ast.parse(src)))
    assert ast.dump(same) == want and ast.dump(other) != want
