"""The port's grid collage (``core/grid.py``, ``api.stitch_grid``) on the
CPU: twins of tests/test_grid.py, each held against the JAX package on the
same seeded numpy inputs.

The planner is the port's own copy of ``imagestitching_tpu/core/grid.py``:
its ``GridPlan`` equals JAX's field by field (the column plans too), in both
orders, with the same errors.  ``stitch_grid`` runs each column through the
port's pipeline on ``RuntimeConfig(device="cpu")`` (the kernel's plain
version); it is held within 1 uint8 step of JAX's ``stitch_grid``
(``engine="xla"``) and of the float64 oracle assembled per column from
JAX's plan, and bit-exact where every column is a pure copy.  The mesh case
(tests/test_grid.py:162) is in tests/test_torch_parallel.py.
"""

import base64
import dataclasses
import io
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
from PIL import Image

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import grid as jax_grid
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle as jax_oracle
from imagestitching_tpu_torch import (CanvasLimits, RuntimeConfig,
                                      StitchOptions, api)
from imagestitching_tpu_torch.core import grid
from imagestitching_tpu_torch.core.layout import ImageSpec
from imagestitching_tpu_torch.imgio import codec
from imagestitching_tpu_torch.runtime import pipeline
from imagestitching_tpu_torch.serve.http import StitchHTTPServer
from imagestitching_tpu_torch.serve.server import StitchServer

CPU = RuntimeConfig(device="cpu")
JAX_XLA = jax_config.RuntimeConfig(engine="xla")
rng = np.random.default_rng(31)


def noise(h, w, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def _jax_opts(opts):
    return jax_config.StitchOptions(**dataclasses.asdict(opts))


def _jax_limits(limits):
    return None if limits is None else jax_config.CanvasLimits(
        **dataclasses.asdict(limits))


def _plans(shapes, cols, opts, limits=None, order="balance"):
    """``(port GridPlan, JAX GridPlan)`` of one job, each from its own
    types."""
    port = grid.plan_grid([ImageSpec(w, h) for w, h in shapes], cols, opts,
                          limits, order)
    ref = jax_grid.plan_grid([jax_layout.ImageSpec(w, h) for w, h in shapes],
                             cols, _jax_opts(opts), _jax_limits(limits),
                             order)
    return port, ref


def _assert_grid_plans_equal(got, want):
    assert type(got) is not type(want)          # two packages, two types
    for f in dataclasses.fields(want):
        if f.name == "col_plans":
            continue
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert len(got.col_plans) == len(want.col_plans)
    for p, q in zip(got.col_plans, want.col_plans):
        for f in dataclasses.fields(q):
            if f.name == "placements":
                continue
            assert getattr(p, f.name) == getattr(q, f.name), f.name
        for a, b in zip(p.placements, q.placements):
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert p.signature() == q.signature()


def grid_oracle(gplan, disp, valign="top"):
    """Independent assembly (tests/test_grid.py:19-32): the float64 oracle
    of each column of the JAX package's plan, pasted on a background."""
    canvas = np.empty((gplan.canvas_h, gplan.canvas_w, 3), np.uint8)
    canvas[:] = np.asarray(gplan.background, np.uint8)
    gap_px = int(np.floor(gplan.gap + 0.5))
    x = 0
    for idx_list, plan in zip(gplan.columns, gplan.col_plans):
        col = jax_oracle.stitch(plan, [disp[i] for i in idx_list])
        y = ((gplan.canvas_h - col.shape[0]) // 2 if valign == "center"
             else 0)
        canvas[y:y + col.shape[0], x:x + col.shape[1]] = col
        x += gplan.col_width + gap_px
    return canvas


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _both(imgs, cols, opts, limits=None, **kw):
    """``(port grid, JAX grid, oracle grid)`` of one job."""
    got = api.stitch_grid(imgs, cols=cols, options=opts, config=CPU,
                          limits=limits, **kw)
    theirs = jax_api.stitch_grid(imgs, cols=cols, options=_jax_opts(opts),
                                 config=JAX_XLA, limits=_jax_limits(limits),
                                 **kw)
    _, ref = _plans([(a.shape[1], a.shape[0]) for a in imgs], cols, opts,
                    limits, kw.get("order", "balance"))
    return got, theirs, grid_oracle(ref, imgs, kw.get("valign", "top"))


# ------------------------------------------------------------------ planner

@pytest.mark.parametrize("order", ["balance", "preserve"])
def test_plan_grid_balance_vs_preserve(order):
    specs = [(100, 300), (100, 50), (100, 50), (100, 50)]
    port, ref = _plans(specs, 2, StitchOptions(), order=order)
    _assert_grid_plans_equal(port, ref)
    assert port.columns == {"balance": ((0,), (1, 2, 3)),
                            "preserve": ((0, 2), (1, 3))}[order]


def test_plan_grid_cols_clamped_and_widths_identical():
    port, ref = _plans([(80, 60), (120, 90)], 5, StitchOptions(gap=4))
    _assert_grid_plans_equal(port, ref)
    assert port.cols == 2
    assert port.col_plans[0].canvas_w == port.col_width == 80   # mode=min


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("order", ["balance", "preserve"])
def test_plan_grid_matches_jax_field_by_field(seed, order):
    """Seeded jobs: 1-9 images of 5-400 px, 1-5 columns, the three modes,
    fractional gaps, backgrounds and canvas caps on some seeds."""
    r = np.random.default_rng(500 + seed)
    shapes = [(int(r.integers(5, 401)), int(r.integers(5, 401)))
              for _ in range(int(r.integers(1, 10)))]
    opts = StitchOptions(mode=("min", "max", "original")[seed % 3],
                         gap=float(np.round(r.uniform(0, 12), 2)),
                         background=tuple(int(v) for v in
                                          r.integers(0, 256, 3)))
    limits = None
    if seed % 2:
        side = int(r.integers(40, 500))
        limits = CanvasLimits(max_side=side,
                              max_pixels=int(side * r.integers(40, side + 1)))
    _assert_grid_plans_equal(*_plans(shapes, int(r.integers(1, 6)), opts,
                                     limits, order))


def _error(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("specs,cols,opt_kw,order", [
    ([(10, 10)], 0, {}, "balance"),
    ([(10, 10)], 2, dict(direction="horizontal"), "balance"),
    ([(10, 10)], 2, dict(supersample=True), "balance"),
    ([(10, 10)], 2, {}, "shuffle"),
    ([], 2, {}, "balance"),
    ([(10, 10)] * 10, 3, {}, "balance"),                # max_images
], ids=["cols0", "horizontal", "supersample", "order", "empty",
        "max-images"])
def test_plan_grid_validation(specs, cols, opt_kw, order):
    opts = StitchOptions(**opt_kw)
    port = _error(grid.plan_grid, [ImageSpec(w, h) for w, h in specs], cols,
                  opts, order=order)
    ref = _error(jax_grid.plan_grid,
                 [jax_layout.ImageSpec(w, h) for w, h in specs], cols,
                 _jax_opts(opts), order=order)
    assert port == ref


def test_plan_grid_rounding_never_overshoots_caps():
    """Twin of tests/test_grid.py:208-230, each plan equal to JAX's."""
    for lim in (CanvasLimits(max_side=211), CanvasLimits(max_pixels=10550)):
        port, ref = _plans([(70, 50)] * 3, 3, StitchOptions(gap=0.7), lim)
        _assert_grid_plans_equal(port, ref)
        assert max(port.canvas_w, port.canvas_h) <= lim.max_side
        assert port.canvas_w * port.canvas_h <= lim.max_pixels
    r = np.random.default_rng(4207)
    for _ in range(60):
        n = int(r.integers(1, 8))
        sp = [(int(r.integers(5, 200)), int(r.integers(5, 200)))
              for _ in range(n)]
        lim = CanvasLimits(max_side=int(r.integers(20, 400)),
                           max_pixels=int(r.integers(2_000, 200_000)))
        port, ref = _plans(sp, int(r.integers(1, 5)),
                           StitchOptions(gap=float(r.uniform(0, 9))), lim)
        _assert_grid_plans_equal(port, ref)
        assert max(port.canvas_w, port.canvas_h) <= lim.max_side
        assert port.canvas_w * port.canvas_h <= lim.max_pixels


# ---------------------------------------------------------------- stitching

def test_stitch_grid_equal_tiles_exact():
    imgs = [noise(50, 40) for _ in range(4)]
    got, m = api.stitch_grid(imgs, cols=2, options=StitchOptions(gap=0),
                             config=CPU, return_metrics=True)
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_api.stitch_grid(
        imgs, cols=2, options=jax_config.StitchOptions(gap=0)))
    assert m.strategy == "grid(host-blit,host-blit)"


def test_stitch_grid_parity_vs_oracle_columns():
    imgs = [noise(int(rng.integers(40, 160)), int(rng.integers(30, 120)))
            for _ in range(7)]
    got, theirs, want = _both(imgs, 3, StitchOptions(
        gap=5, background=(10, 200, 30)))
    assert _maxdiff(got, theirs) <= 1 and _maxdiff(got, want) <= 1


def test_stitch_grid_original_mode_and_fractional_gap():
    imgs = [noise(60, 50), noise(40, 30), noise(80, 70)]
    got, theirs, want = _both(imgs, 2, StitchOptions(
        mode="original", gap=2.5, background=(0, 0, 0)))
    assert got.shape[1] == 2 * 70 + 3            # original -> max width
    assert _maxdiff(got, theirs) <= 1 and _maxdiff(got, want) <= 1


def test_stitch_grid_canvas_caps_scale_whole_grid():
    imgs = [noise(300, 200) for _ in range(4)]
    got, theirs, want = _both(imgs, 2, StitchOptions(gap=4),
                              limits=CanvasLimits(max_side=250))
    assert max(got.shape[:2]) <= 250
    assert _maxdiff(got, theirs) <= 1 and _maxdiff(got, want) <= 1


@pytest.mark.parametrize("order", ["balance", "preserve"])
def test_stitch_grid_valign_center(order):
    imgs = [noise(200, 50), noise(50, 50), noise(90, 70)]
    got, theirs, want = _both(imgs, 2, StitchOptions(
        gap=0, background=(255, 0, 0)), valign="center", order=order)
    assert _maxdiff(got, theirs) <= 1 and _maxdiff(got, want) <= 1
    two = api.stitch_grid(imgs[:2], cols=2, config=CPU, valign="center",
                          options=StitchOptions(gap=0,
                                                background=(255, 0, 0)))
    # column 1 is 50 rows in a 200-row canvas -> 75 red rows above it
    assert np.array_equal(two[:75, 50:], np.broadcast_to(
        [255, 0, 0], (75, 50, 3)))
    assert np.array_equal(two[75:125, 50:], imgs[1])


def test_stitch_grid_grayscale_and_rgba():
    gray = rng.integers(0, 256, (40, 40), np.uint8)
    rgb = noise(40, 40)
    got = api.stitch_grid([gray, rgb], cols=2, options=StitchOptions(gap=0),
                          config=CPU)
    assert np.array_equal(got[:, :40], np.repeat(gray[:, :, None], 3, 2))
    rgba = noise(40, 40, 4)
    got4 = api.stitch_grid([rgba], cols=1, options=StitchOptions(gap=0),
                           config=CPU)
    np.testing.assert_array_equal(got4, jax_api.stitch_grid(
        [rgba], cols=1, options=jax_config.StitchOptions(gap=0)))
    al = rgba[:, :, 3:].astype(np.float32) / 255.0
    flat = np.clip(np.floor(rgba[:, :, :3] * al + 255.0 * (1 - al) + 0.5),
                   0, 255).astype(np.uint8)
    assert np.array_equal(got4, flat)


def test_stitch_grid_rejects_merge_overlap():
    with pytest.raises(ValueError) as e:
        api.stitch_grid([noise(40, 40)], cols=1, config=CPU,
                        options=StitchOptions(merge_overlap=True))
    with pytest.raises(ValueError) as j:
        jax_api.stitch_grid([noise(40, 40)], cols=1,
                            options=jax_config.StitchOptions(
                                merge_overlap=True))
    assert str(e.value) == str(j.value)


def test_stitch_grid_exif_orientation():
    a = noise(60, 40)
    b_disp = noise(80, 40)
    b_raw = b_disp[::-1, ::-1].copy()        # EXIF 3 = rotate 180
    got = api.stitch_grid([a, (b_raw, 3)], cols=1,
                          options=StitchOptions(gap=0), config=CPU)
    assert np.array_equal(got, np.concatenate([a, b_disp], axis=0))


def test_stitch_grid_resampled_columns_run_on_the_pipeline():
    """Mixed widths: every column resamples through ``pipeline.run`` on the
    configured device, and the metrics name each column's strategy."""
    imgs = [noise(180, 90), noise(150, 120), noise(160, 100),
            noise(140, 110)]
    opts = StitchOptions(gap=3, background=(5, 5, 5))
    got, m = api.stitch_grid(imgs, cols=2, options=opts, config=CPU,
                             return_metrics=True)
    assert m.strategy == "grid(resident,resident)"
    assert m.h2d_bytes == sum(a.nbytes for a in imgs)
    _, _, want = _both(imgs, 2, opts)
    assert _maxdiff(got, want) <= 1


def test_stitch_grid_aggregates_stage_wait_max(monkeypatch):
    real_run = pipeline.run
    vals = iter([0.25, 0.75, 0.5])

    def run_patched(plan, imgs, config, progress=None, **kw):
        out, m = real_run(plan, imgs, config, progress, **kw)
        m.stage_wait_max_s = next(vals, 0.0)
        return out, m

    monkeypatch.setattr(pipeline, "run", run_patched)
    _, m = api.stitch_grid([noise(40, 30) for _ in range(6)], cols=3,
                           options=StitchOptions(gap=0), config=CPU,
                           return_metrics=True)
    assert m.stage_wait_max_s == 0.75


def test_stitch_grid_cuda_device_without_cuda_raises():
    """The default device is the card: a resampled column on a host without
    one raises, never runs on the CPU instead."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.stitch_grid([noise(40, 30), noise(50, 20)], cols=2)


# ------------------------------------------------------------ http and cli

def _post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/stitch", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.asarray(Image.open(io.BytesIO(r.read())))


def _payload(imgs, **kw):
    return {"images": [base64.b64encode(codec.encode_bytes(a, "png")).decode()
                       for a in imgs], **kw}


def test_http_grid():
    imgs = [noise(50, 40) for _ in range(4)]
    with StitchHTTPServer(port=0, config=CPU, max_wait_s=0.005) as srv:
        out = _post(srv.port, _payload(imgs, grid_cols=2, gap=0))
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    assert np.array_equal(out, want)


def test_http_grid_inherits_server_config_and_admission():
    """Grid jobs over HTTP inherit the server's RuntimeConfig (here: canvas
    caps via config.limits) and count against max_queue (503 when full)."""
    imgs = [noise(120, 100) for _ in range(4)]
    payload = _payload(imgs, grid_cols=2, gap=2)
    capped = StitchServer(config=RuntimeConfig(
        device="cpu", limits=CanvasLimits(max_side=64)))
    with StitchHTTPServer(port=0, server=capped) as srv:
        out = _post(srv.port, payload)
        assert max(out.shape[:2]) <= 64
        want = jax_api.stitch_grid(
            imgs, cols=2, options=jax_config.StitchOptions(gap=2),
            config=JAX_XLA, limits=jax_config.CanvasLimits(max_side=64))
        assert _maxdiff(out, want) <= 1
    capped.close()

    full = StitchServer(config=CPU, max_queue=0)
    with StitchHTTPServer(port=0, server=full) as srv:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.port, payload)
        assert ei.value.code == 503
    full.close()


def test_cli_grid(tmp_path):
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = []
    imgs = [noise(60, 50) for _ in range(4)]
    for i, a in enumerate(imgs):
        f = tmp_path / f"g{i}.png"
        Image.fromarray(a).save(f)
        paths.append(str(f))
    out = tmp_path / "grid.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.cli", *paths,
         "-o", str(out), "--grid-cols", "2", "--gap", "0", "--device", "cpu",
         "--valign", "center", "--grid-order", "preserve", "--json",
         "--metrics"],
        cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["metrics"]["strategy"].startswith("grid(")
    got = np.asarray(Image.open(out))
    want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                      np.vstack([imgs[1], imgs[3]])])
    assert np.array_equal(got, want)
