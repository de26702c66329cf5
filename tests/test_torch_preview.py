"""The port's preview (``api.preview_size``, ``api.make_preview``) on the
CPU: twins of tests/test_preview.py, each held against the JAX package on
the same seeded numpy inputs.

``preview_size`` equals JAX's on a seeded sweep with half-up ties.
``make_preview(device="cpu")`` draws the preview as one bilinear placement
through ``cuda_resize.resize_place``, whose plain version runs on a CPU
tensor; it is held within 1 uint8 step of JAX's ``make_preview(device=True)``
(an f32 XLA resize) and of the float64 host path.  ``device=False`` is the
float64 host path of both packages, bit for bit.  A fault of the kernel's
wrapper propagates: nothing falls back to the host.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu import api as jax_api
from imagestitching_tpu_torch import api
from imagestitching_tpu_torch.ops import cuda_resize

rng = np.random.default_rng(29)


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def test_preview_size_aspect_and_floor():
    assert api.preview_size(400, 200, 100) == (100, 180)  # floored at 180
    assert api.preview_size(400, 1600, 100) == (100, 400)
    assert api.preview_size(1000, 10, 500)[1] == 180


def test_preview_size_rounds_half_up():
    assert api.preview_size(2, 5, 1, min_height=1) == (1, 3)    # 2.5 -> 3
    assert api.preview_size(4, 10, 1, min_height=1) == (1, 3)   # 2.5 -> 3
    assert api.preview_size(4, 6, 2, min_height=1) == (2, 3)    # 3.0 -> 3


@pytest.mark.parametrize("seed", range(4))
def test_preview_size_matches_jax(seed):
    """Seeded sizes, half of them half-up ties: with ``box_w = width / 2``
    and an odd height, ``box_w * height / width`` ends in .5."""
    r = np.random.default_rng(seed)
    for _ in range(500):
        if r.integers(0, 2):
            width = 2 * int(r.integers(1, 2500))
            box_w = width // 2
            height = 2 * int(r.integers(0, 2000)) + 1
        else:
            width = int(r.integers(0, 5000))
            box_w = int(r.integers(1, 1200))
            height = int(r.integers(0, 40000))
        min_h = int(r.choice([1, 2, 180]))
        assert api.preview_size(width, height, box_w, min_h) == \
            jax_api.preview_size(width, height, box_w, min_h)


def test_make_preview_downscale():
    img = np.full((400, 800, 3), 77, np.uint8)
    prev = api.make_preview(img, 200, device="cpu")
    assert prev.shape == (180, 200, 3)  # 200*400/800=100 -> floor 180
    np.testing.assert_array_equal(prev, np.full((180, 200, 3), 77))


def test_make_preview_matches_oracle_resample():
    img = rng.integers(0, 256, (64, 128, 3), np.uint8)
    prev = api.make_preview(img, 32, min_height=1, device="cpu")
    assert prev.shape == (16, 32, 3)
    img2 = np.repeat(np.repeat(prev, 2, axis=0), 2, axis=1)
    back = api.make_preview(img2, 32, min_height=1, device="cpu")
    assert _maxdiff(back, prev) <= 1


@pytest.mark.parametrize("shape,box_w", [((333, 517, 3), 120),
                                         ((700, 90, 3), 45),
                                         ((241, 1003, 1), 250)])
def test_make_preview_device_matches_host(shape, box_w):
    img = rng.integers(0, 256, shape, np.uint8)
    dev = api.make_preview(img, box_w, device="cpu")
    host = api.make_preview(img, box_w, device=False)
    theirs = jax_api.make_preview(img, box_w, device=True)
    assert _maxdiff(dev, host) <= 1
    assert _maxdiff(dev, theirs) <= 1
    np.testing.assert_array_equal(host, jax_api.make_preview(
        img, box_w, device=False))


def test_make_preview_accepts_tensor():
    img = rng.integers(0, 256, (90, 45, 3), np.uint8)
    dev = api.make_preview(torch.from_numpy(img), 30, min_height=1,
                           device="cpu")
    host = api.make_preview(torch.from_numpy(img), 30, min_height=1,
                            device=False)
    assert _maxdiff(dev, host) <= 1
    np.testing.assert_array_equal(host, jax_api.make_preview(
        img, 30, min_height=1, device=False))


def test_make_preview_flattens_alpha_and_keeps_gray():
    rgba = rng.integers(0, 256, (40, 60, 4), np.uint8)
    got = api.make_preview(rgba, 30, min_height=1, device="cpu")
    assert got.shape == (20, 30, 3)
    assert _maxdiff(got, jax_api.make_preview(rgba, 30, min_height=1)) <= 1
    gray = rng.integers(0, 256, (40, 60), np.uint8)
    got = api.make_preview(gray, 30, min_height=1, device="cpu")
    assert got.shape == (20, 30, 1)
    np.testing.assert_array_equal(
        api.make_preview(gray, 30, min_height=1, device=False),
        jax_api.make_preview(gray, 30, min_height=1, device=False))
    assert _maxdiff(got, jax_api.make_preview(gray, 30, min_height=1)) <= 1


@pytest.mark.parametrize("h,w", [(1, 37), (37, 1), (1, 1), (3, 500)])
def test_make_preview_degenerate_shapes(h, w):
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    box_w = 12
    pw, ph = api.preview_size(w, h, box_w, min_height=2)
    dev = api.make_preview(img, box_w, min_height=2, device="cpu")
    host = api.make_preview(img, box_w, min_height=2, device=False)
    assert dev.shape == (ph, pw, 3) == host.shape
    assert _maxdiff(dev, host) <= 1
    assert _maxdiff(dev, jax_api.make_preview(img, box_w, min_height=2,
                                              device=True)) <= 1
    np.testing.assert_array_equal(host, jax_api.make_preview(
        img, box_w, min_height=2, device=False))


def test_make_preview_upscale_matches_oracle():
    img = rng.integers(0, 256, (9, 7, 3), np.uint8)
    dev = api.make_preview(img, 50, min_height=1, device="cpu")
    host = api.make_preview(img, 50, min_height=1, device=False)
    assert dev.shape == host.shape == (round(50 * 9 / 7), 50, 3)
    assert _maxdiff(dev, host) <= 1
    assert _maxdiff(dev, jax_api.make_preview(img, 50, min_height=1)) <= 1


def test_make_preview_is_one_placement(monkeypatch):
    """One call of the kernel's wrapper per preview: the whole image at
    orientation 1 onto a fresh ``(ph, pw, C)`` canvas at (0, 0), with
    K = 2 bilinear taps."""
    calls = []
    real = cuda_resize.resize_place

    def spy(src, orientation, ri0, rw, ci0, cw, canvas, r0, c0):
        calls.append((tuple(src.shape), orientation, rw.shape[1],
                      cw.shape[1], tuple(canvas.shape), r0, c0))
        real(src, orientation, ri0, rw, ci0, cw, canvas, r0, c0)

    monkeypatch.setattr(cuda_resize, "resize_place", spy)
    img = rng.integers(0, 256, (400, 100, 3), np.uint8)
    api.make_preview(img, 25, device="cpu")
    assert calls == [((400, 100, 3), 1, 2, 2, (180, 25, 3), 0, 0)]


def test_kernel_fault_propagates(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("resize_place kernel launch failed: boom")

    monkeypatch.setattr(cuda_resize, "resize_place", boom)
    img = rng.integers(0, 256, (40, 60, 3), np.uint8)
    with pytest.raises(RuntimeError, match="boom"):
        api.make_preview(img, 30, device="cpu")
    assert api.make_preview(img, 30, device=False).shape == (180, 30, 3)


def test_make_preview_default_device_is_the_card():
    """``device=True`` (the default) draws on ``cuda``: without a card it
    raises, it never takes the host path instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    img = rng.integers(0, 256, (40, 60, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        api.make_preview(img, 30)
