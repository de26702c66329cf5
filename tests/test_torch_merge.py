"""The port's auto-overlap merge (``StitchOptions.merge_overlap``,
``ops/overlap.py``) on the CPU: twins of tests/test_merge_overlap.py, each
held against the JAX package on the same seeded numpy inputs.

Tolerances: trims equal to JAX's ``detect_trims(device=False)`` (the numpy
scorer); the port's torch scorer (float64, here on the CPU) within 1e-9 of
``_scores_numpy``; a merged stitch equal bit for bit to the stitch of the
pre-trimmed strips and to the capture they were cut from.  The port's jobs
run on ``RuntimeConfig(device="cpu")``.  A fault of the scorer propagates
from ``stitch_arrays`` and from ``StitchServer.submit``: nothing falls back
to the numpy scorer.
"""

import base64
import io
import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle as jax_oracle
from imagestitching_tpu.ops import overlap as jax_overlap
from imagestitching_tpu_torch import RuntimeConfig, StitchOptions, api
from imagestitching_tpu_torch.core.layout import ImageSpec
from imagestitching_tpu_torch.imgio import codec
from imagestitching_tpu_torch.ops import overlap
from imagestitching_tpu_torch.runtime.logger import get_logger
from imagestitching_tpu_torch.serve.http import StitchHTTPServer
from imagestitching_tpu_torch.serve.server import StitchServer

CPU = RuntimeConfig(device="cpu")
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
rng = np.random.default_rng(99)


def noise(h, w, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def split_with_overlap(base, heights, o):
    """Cut ``base`` into strips of the given heights where consecutive
    strips share exactly ``o`` rows."""
    out, top = [], 0
    for h in heights:
        out.append(base[top:top + h])
        top += h - o
    return out


def _pair(a, b, **kw):
    """The port's ``detect_pair`` with the torch scorer on the CPU, after
    checking it against the numpy scorer's and JAX's ``device=False``."""
    got = overlap.detect_pair(a, b, device="cpu", **kw)
    assert got == overlap.detect_pair(a, b, device=False, **kw)
    assert got == jax_overlap.detect_pair(a, b, device=False, **kw)
    return got


# ---------------------------------------------------------------- detection

def test_detect_pair_exact_overlap():
    a, b = split_with_overlap(noise(600, 80), [300, 250], 70)
    assert _pair(a, b) == 70


def test_detect_pair_no_overlap():
    assert _pair(noise(200, 64), noise(200, 64)) == 0


def test_detect_pair_respects_threshold():
    a, b = split_with_overlap(noise(400, 64), [200, 200], 60)
    b = b.copy()
    wob = rng.integers(-1, 2, b[:60].shape)
    b[:60] = np.clip(b[:60].astype(np.int16) + wob, 0, 255).astype(np.uint8)
    assert _pair(a, b, threshold=2.0) == 60
    assert _pair(a, b, threshold=0.0) == 0


def test_detect_pair_shape_mismatch_and_tiny():
    assert _pair(noise(200, 64), noise(200, 65)) == 0
    assert _pair(noise(3, 64), noise(3, 64)) == 0


def test_detect_pair_never_empties_b():
    a = noise(300, 48)
    b = np.concatenate([a[261:], noise(1, 48)], axis=0)   # 40 rows
    assert _pair(a, b, max_frac=1.0) == b.shape[0] - 1 == 39


def test_detect_trims_chain_and_apply():
    base = noise(860, 72)
    parts = split_with_overlap(base, [300, 320, 340], 50)
    trims = overlap.detect_trims(parts, "vertical", device="cpu")
    assert trims == [0, 50, 50] == jax_overlap.detect_trims(
        parts, "vertical", device=False)
    cropped = overlap.apply_trims(parts, trims, "vertical")
    assert np.array_equal(np.concatenate(cropped, axis=0), base)


def test_detect_trims_horizontal():
    base = noise(80, 700)
    a, b = base[:, :380], base[:, 330:]
    trims = overlap.detect_trims([a, b], "horizontal", device="cpu")
    assert trims == [0, 50] == jax_overlap.detect_trims(
        [a, b], "horizontal", device=False)
    cropped = overlap.apply_trims([a, b], trims, "horizontal")
    assert np.array_equal(np.concatenate(cropped, axis=1), base)


@pytest.mark.parametrize("seed", range(10))
def test_detect_trims_match_jax_on_seeded_captures(seed):
    """Seeded captures: 2-5 strips of 1 or 3 channels, each sharing 0 or
    32 to half its height with the one before, both directions, +-1 level
    of noise on some seeds."""
    r = np.random.default_rng(700 + seed)
    direction = ("vertical", "horizontal")[seed % 2]
    c = (1, 3)[seed % 3 != 0]
    n = int(r.integers(2, 6))
    heights = [int(r.integers(70, 160)) for _ in range(n)]
    width = int(r.integers(16, 90))
    parts = []
    for h in heights:
        o = 0
        if parts and r.integers(0, 4):
            o = int(r.integers(32, min(h, len(parts[-1])) // 2 + 1))
        top = parts[-1][-o:] if o else np.zeros((0, width, c), np.uint8)
        strip = np.concatenate(
            [top, r.integers(0, 256, (h - len(top), width, c), np.uint8)])
        if seed % 4 == 3:
            strip = np.clip(strip.astype(np.int16)
                            + r.integers(-1, 2, strip.shape), 0,
                            255).astype(np.uint8)
        parts.append(strip)
    if direction == "horizontal":
        parts = [np.ascontiguousarray(p.transpose(1, 0, 2)) for p in parts]
    got = overlap.detect_trims(parts, direction, device="cpu")
    assert got == jax_overlap.detect_trims(parts, direction, device=False)
    assert got == overlap.detect_trims(parts, direction, device=False)


@pytest.mark.parametrize("shape,k", [((130, 64, 3), 32), ((97, 37, 1), 9),
                                     ((1266, 117, 3), 32)])
def test_torch_scorer_matches_scores_numpy(shape, k):
    region = rng.integers(0, 256, shape, np.uint8)
    template = rng.integers(0, 256, (k,) + shape[1:], np.uint8)
    want = overlap._scores_numpy(region, template)
    np.testing.assert_array_equal(want, jax_overlap._scores_numpy(region,
                                                                  template))
    got = overlap._scores(region, template, "cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-9
    assert int(np.argmin(got)) == int(np.argmin(want))


def test_scorer_device_argument():
    assert overlap.scorer_device(False) is None
    assert overlap.scorer_device(None) is None
    assert overlap.scorer_device("cpu") == torch.device("cpu")
    assert overlap.scorer_device(torch.device("cpu")) == torch.device("cpu")


def test_device_true_without_cuda_raises():
    """``device=True`` means the card: without one the scorer raises, it
    never takes the numpy scorer instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    a, b = split_with_overlap(noise(300, 40), [160, 160], 20)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overlap.detect_pair(a, b)


# ------------------------------------------------------------- integration

def test_stitch_arrays_merge_matches_pretrimmed():
    base = noise(680, 96)
    parts = split_with_overlap(base, [250, 260, 250], 40)
    get_logger().clear()
    got = api.stitch_arrays(parts, options=StitchOptions(merge_overlap=True),
                            config=CPU)
    assert [e["trims"] for e in get_logger().ring()
            if e["tag"] == "stitch.merge"] == [[0, 40, 40]]
    want = api.stitch_arrays([parts[0], parts[1][40:], parts[2][40:]],
                             options=StitchOptions(), config=CPU)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, base)


def test_stitch_arrays_merge_with_orientation():
    base = noise(600, 64)
    a, b = split_with_overlap(base, [300, 350], 50)
    b_rot = b[::-1, ::-1].copy()
    specs = [ImageSpec(a.shape[1], a.shape[0], 1),
             ImageSpec(b_rot.shape[1], b_rot.shape[0], 3)]
    got = api.stitch_arrays([a, b_rot], specs=specs, config=CPU,
                            options=StitchOptions(merge_overlap=True))
    np.testing.assert_array_equal(got, base)


def test_stitch_merge_mixed_widths_resampled():
    imgs = [noise(120, 100), noise(130, 80)]
    got = api.stitch_arrays(imgs, options=StitchOptions(merge_overlap=True),
                            config=CPU)
    plan = jax_layout.solve(
        [jax_layout.ImageSpec(i.shape[1], i.shape[0]) for i in imgs],
        jax_config.StitchOptions())
    want = jax_oracle.stitch(plan, imgs)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    theirs = jax_api.stitch_arrays(imgs, options=jax_config.StitchOptions(
        merge_overlap=True), config=jax_config.RuntimeConfig(engine="xla"))
    assert np.abs(got.astype(int) - theirs.astype(int)).max() <= 1


def test_stitch_merge_horizontal_equals_jax():
    base = noise(70, 500)
    parts = [base[:, :200], base[:, 170:360], base[:, 330:]]
    opts = dict(direction="horizontal", merge_overlap=True, gap=2)
    got = api.stitch_arrays(parts, options=StitchOptions(**opts), config=CPU)
    np.testing.assert_array_equal(got, jax_api.stitch_arrays(
        parts, options=jax_config.StitchOptions(**opts)))


def test_stitch_files_merge_end_to_end(tmp_path):
    base = noise(640, 90)
    parts = split_with_overlap(base, [280, 260, 220], 60)
    paths = []
    for i, p in enumerate(parts):
        f = tmp_path / f"s{i}.png"
        Image.fromarray(p).save(f)
        paths.append(str(f))
    opts = StitchOptions(merge_overlap=True)
    got = api.stitch(paths, options=opts, config=CPU)
    np.testing.assert_array_equal(got, base)
    out = api.stitch_to_file(paths, tmp_path / "out.png", options=opts,
                             config=CPU)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), base)


def test_server_merge_overlap():
    base = noise(500, 64)
    a, b = split_with_overlap(base, [260, 290], 50)
    with StitchServer(max_batch=4, config=CPU) as srv:
        out = srv.submit([a, b], StitchOptions(merge_overlap=True)).result(
            timeout=30)
    np.testing.assert_array_equal(out, base)


def test_cli_merge_overlap(tmp_path):
    base = noise(420, 70)
    a, b = split_with_overlap(base, [240, 230], 50)
    pa, pb = tmp_path / "a.png", tmp_path / "b.png"
    Image.fromarray(a).save(pa)
    Image.fromarray(b).save(pb)
    out = tmp_path / "o.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.cli", str(pa),
         str(pb), "-o", str(out), "--merge-overlap", "--device", "cpu"],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    np.testing.assert_array_equal(np.asarray(Image.open(out)), base)


def test_http_merge_overlap():
    base = noise(460, 72)
    a, b = split_with_overlap(base, [250, 260], 50)
    payload = {
        "images": [base64.b64encode(codec.encode_bytes(x, "png")).decode()
                   for x in (a, b)],
        "merge_overlap": "true",
    }
    with StitchHTTPServer(port=0, config=CPU, max_wait_s=0.005) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.asarray(Image.open(io.BytesIO(r.read())))
    np.testing.assert_array_equal(out, base)


def test_merge_threshold_validation():
    with pytest.raises(ValueError):
        StitchOptions(merge_threshold=-1.0).validate()


# ---------------------------------------------------------- no fallback

def _boom(*a, **k):
    raise RuntimeError("scorer fault")


def test_scorer_fault_propagates_from_stitch_arrays(monkeypatch):
    monkeypatch.setattr(overlap, "_scores_torch", _boom)
    parts = split_with_overlap(noise(300, 40), [160, 160], 20)
    with pytest.raises(RuntimeError, match="scorer fault"):
        api.stitch_arrays(parts, options=StitchOptions(merge_overlap=True),
                          config=CPU)


def test_scorer_fault_propagates_from_server_submit(monkeypatch):
    monkeypatch.setattr(overlap, "_scores_torch", _boom)
    parts = split_with_overlap(noise(300, 40), [160, 160], 20)
    with StitchServer(config=CPU) as srv:
        with pytest.raises(RuntimeError, match="scorer fault"):
            srv.submit(parts, StitchOptions(merge_overlap=True))
        assert srv.stats()["pending"] == 0
        assert srv.stats()["jobs"] == 0
