"""The port's streaming export on the CPU: band readback overlapped with the
native incremental encoder (``runtime/export.py``), ``stitch_to_file``'s
``stream=`` front door with its fallbacks, and the pure-copy export
``stream_blit_to_file`` with its ack window -- twins of tests/test_export.py
and tests/test_backpressure.py:173-257, against the JAX package's same
calls on the same seeded inputs.

Tolerances: a streamed PNG decodes equal to the canvas it was given and to
the monolithic file; a streamed JPEG equals the monolithic encoder's bytes at
equal quality; where both packages only copy pixels (the blit paths) their
files decode equal, and where they resample the port's file is within 1
uint8 step of the JAX package's.  A CPU tensor canvas takes the tensor
branch (the same code as a CUDA one, without pinning or streams).
"""

import dataclasses
import functools
import os
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.runtime import export as jax_export
from imagestitching_tpu_torch import (CanvasLimits, MemoryBudget,
                                      RuntimeConfig, StitchOptions, api)
from imagestitching_tpu_torch.core import geometry, oracle
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.imgio import codec, native
from imagestitching_tpu_torch.runtime import export
from imagestitching_tpu_torch.runtime.logger import StitchLogger, set_logger

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native codec unavailable")

CPU = RuntimeConfig(device="cpu")
JAX_XLA = jax_config.RuntimeConfig(engine="xla")


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _canvas(rng, h=300, w=217):
    return rng.integers(0, 256, (h, w, 3), np.uint8)


def _decode(path):
    return codec.decode(open(path, "rb").read())[0]


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


class _Bands:
    """An in-memory writer: keeps a copy of every band it is given."""

    def __init__(self, delay_s=0.0):
        self.bands, self.closed, self.delay_s = [], False, delay_s

    def write(self, band):
        time.sleep(self.delay_s)
        self.bands.append(np.array(band, copy=True))

    def close(self):
        self.closed = True

    def joined(self):
        return np.concatenate(self.bands, axis=0)


# ---------------------------------------------------------------- pipeline

@needs_native
def test_stream_to_png_host_and_tensor_match(tmp_path):
    """Twin of tests/test_export.py:114-128."""
    arr = _canvas(_rng("host-tensor"), 500, 301)
    ph1 = export.stream_to_png(arr, str(tmp_path / "h.png"), band_rows=128)
    ph2 = export.stream_to_png(torch.from_numpy(arr), str(tmp_path / "d.png"),
                               band_rows=128)
    assert not ph1["overlapped"] and ph2["overlapped"]
    assert ph2["readback_s"] > 0 and ph2["encode_s"] > 0
    assert ph2["wall_s"] >= ph2["encode_s"]
    np.testing.assert_array_equal(_decode(tmp_path / "h.png"), arr)
    np.testing.assert_array_equal(_decode(tmp_path / "d.png"), arr)
    import jax.numpy as jnp
    jax_export.stream_to_png(jnp.asarray(arr), str(tmp_path / "j.png"),
                             band_rows=128)
    np.testing.assert_array_equal(_decode(tmp_path / "j.png"),
                                  _decode(tmp_path / "d.png"))


@needs_native
def test_stream_to_png_tail_band_not_multiple(tmp_path):
    """Twin of tests/test_export.py:131-140: 130 rows in 64-row bands."""
    arr = _canvas(_rng("tail"), 130, 257)
    p = str(tmp_path / "t.png")
    export.stream_to_png(torch.from_numpy(arr), p, band_rows=64)
    np.testing.assert_array_equal(_decode(p), arr)


@needs_native
@pytest.mark.parametrize("tensor", [False, True])
def test_stream_to_png_rejects_non_rgb(tmp_path, tensor):
    gray = np.zeros((8, 8, 1), np.uint8)
    with pytest.raises(ValueError, match="3-channel"):
        export.stream_to_png(torch.from_numpy(gray) if tensor else gray,
                             str(tmp_path / "g.png"))
    assert not os.path.exists(tmp_path / "g.png")


@pytest.mark.parametrize("h,band,depth", [(130, 64, 3), (97, 10, 2),
                                          (5, 64, 3), (64, 64, 1)])
def test_stream_device_bands_join_to_the_canvas(h, band, depth):
    """``_stream_device`` hands the writer every band top to bottom, the
    tail band trimmed; the ring of ``depth`` buffers is reused, and
    ``readback_s`` and ``encode_s`` are filled."""
    arr = _canvas(_rng(f"bands{h}"), h, 33)
    writer = _Bands()
    phases = {"readback_s": 0.0, "encode_s": 0.0}
    progress = []
    export._stream_device(torch.from_numpy(arr), writer, h, 33, 3, band,
                          phases, lambda ph, f: progress.append((ph, f)),
                          depth=depth)
    assert writer.closed
    assert [b.shape[0] for b in writer.bands] == [
        min(band, h - r) for r in range(0, h, band)]
    np.testing.assert_array_equal(writer.joined(), arr)
    assert phases["readback_s"] > 0 and phases["encode_s"] > 0
    assert progress[-1] == ("export", 1.0)


def test_stream_device_rejects_a_canvas_of_another_shape():
    with pytest.raises(ValueError, match="is not"):
        export._stream_device(torch.zeros((4, 5, 3), dtype=torch.uint8),
                              _Bands(), 4, 6, 3, 2, {"readback_s": 0.0,
                                                     "encode_s": 0.0},
                              lambda *a: None)


@needs_native
def test_writer_error_removes_the_partial_file(tmp_path, monkeypatch):
    """An error inside the band loop aborts the writer and removes the
    file."""
    arr = _canvas(_rng("abort"), 200, 40)
    p = tmp_path / "x.png"
    real = native.PngStreamWriter.write
    calls = []

    def write(self, band):
        calls.append(1)
        if len(calls) == 2:
            raise OSError("disk full (simulated)")
        return real(self, band)

    monkeypatch.setattr(native.PngStreamWriter, "write", write)
    with pytest.raises(OSError, match="disk full"):
        export.stream_to_png(torch.from_numpy(arr), str(p), band_rows=64)
    assert not p.exists()


@needs_native
def test_stream_to_png_fuzz_geometry(tmp_path):
    """Twin of tests/test_export.py:273-287: random canvas and band sizes,
    host and tensor canvases, always lossless."""
    rng = _rng("fuzz")
    for trial in range(8):
        h = int(rng.integers(1, 400))
        w = int(rng.integers(1, 300))
        band = int(rng.integers(1, h + 32))
        arr = rng.integers(0, 256, (h, w, 3), np.uint8)
        p = str(tmp_path / f"f{trial}.png")
        canvas = torch.from_numpy(arr) if trial % 2 else arr
        export.stream_to_png(canvas, p, band_rows=band)
        assert np.array_equal(_decode(p), arr), (h, w, band, trial)


@needs_native
def test_jpeg_stream_of_a_tensor_matches_monolithic_bytes(tmp_path):
    arr = _canvas(_rng("jpeg"), 200, 160)
    p = str(tmp_path / "s.jpg")
    ph = export.stream_to_jpeg(torch.from_numpy(arr), p, quality=92,
                               band_rows=77)
    assert ph["overlapped"]
    assert open(p, "rb").read() == native.encode_jpeg(arr, quality=92)


def test_band_rows_for_matches_jax():
    for w in (1, 217, 4000, 30000):
        assert export.band_rows_for(w) == jax_export.band_rows_for(w)


# ---------------------------------------------------------------- api

def _sources(tmp_path, n=3, name="src"):
    rng = _rng(name)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
            for w, h in [(300, 200), (250, 320), (300, 200)][:n]]
    paths = [codec.encode(str(tmp_path / f"{name}{i}.png"), a)
             for i, a in enumerate(imgs)]
    return imgs, paths


@needs_native
def test_stitch_to_file_stream_matches_monolithic(tmp_path):
    """Twin of tests/test_export.py:161-171, and within 1 of the JAX
    package's streamed file."""
    _, paths = _sources(tmp_path)
    p1, m1 = api.stitch_to_file(paths, str(tmp_path / "s.png"), gap=4,
                                config=CPU, return_metrics=True)
    p2 = api.stitch_to_file(paths, str(tmp_path / "m.png"), gap=4,
                            config=CPU, stream=False)
    np.testing.assert_array_equal(_decode(p1), _decode(p2))
    assert m1.export_s > 0 and m1.encode_s > 0 and m1.readback_s > 0
    assert m1.strategy == "resident"
    jp = jax_api.stitch_to_file(paths, str(tmp_path / "j.png"), gap=4,
                                config=JAX_XLA)
    assert _maxdiff(_decode(p1), _decode(jp)) <= 1


@needs_native
def test_stitch_to_file_stream_overlapped_big_task(tmp_path):
    """Twin of tests/test_export.py:174-189: 9 files go through
    ``run_overlapped(keep_on_device=True)`` and the tensor branch."""
    imgs, paths = _sources(tmp_path)
    paths = paths * 3
    p, m = api.stitch_to_file(paths, str(tmp_path / "o.png"), gap=2,
                              config=CPU, return_metrics=True)
    assert m.strategy == "overlapped" and m.export_s > 0
    got = _decode(p)
    plan = solve([ImageSpec(a.shape[1], a.shape[0]) for a in imgs * 3],
                 StitchOptions(gap=2))
    assert _maxdiff(got, oracle.stitch(plan, imgs * 3)) <= 1
    np.testing.assert_array_equal(got, api.stitch(
        paths, gap=2, config=dataclasses.replace(CPU, overlap="never")))
    jp = jax_api.stitch_to_file(paths, str(tmp_path / "j.png"), gap=2,
                                config=JAX_XLA)
    assert _maxdiff(got, _decode(jp)) <= 1


@needs_native
def test_stitch_to_file_stream_banded_strategy_host_canvas(tmp_path):
    """Twin of tests/test_export.py:192-205: a tiny budget composites on the
    host; the streaming writer takes the host canvas."""
    _, paths = _sources(tmp_path)
    cfg = dataclasses.replace(CPU, budget=MemoryBudget(hbm_bytes=256 << 10))
    p, m = api.stitch_to_file(paths, str(tmp_path / "b.png"), gap=4,
                              config=cfg, return_metrics=True)
    assert m.strategy == "banded"
    p2 = api.stitch_to_file(paths, str(tmp_path / "b2.png"), gap=4,
                            config=CPU, stream=False)
    np.testing.assert_array_equal(_decode(p), _decode(p2))


def test_stitch_to_file_stream_rejects_unstreamable_format(tmp_path):
    _, paths = _sources(tmp_path, 2)
    with pytest.raises(ValueError, match="streaming encoder"):
        api.stitch_to_file(paths, str(tmp_path / "x.webp"), stream=True,
                           config=CPU)


def test_stitch_to_file_validates_arguments(tmp_path):
    _, paths = _sources(tmp_path, 2)
    with pytest.raises(ValueError, match="stream must be"):
        api.stitch_to_file(paths, str(tmp_path / "x.png"), stream="Auto",
                           config=CPU)
    with pytest.raises(TypeError, match="keep_on_device"):
        api.stitch_to_file(paths, str(tmp_path / "x.png"),
                           keep_on_device=True, config=CPU)


@needs_native
def test_stitch_to_file_stream_true_rejects_grayscale(tmp_path):
    rng = _rng("gray")
    gray = [(rng.integers(0, 256, (40, 30), np.uint8), 1) for _ in range(2)]
    with pytest.raises(ValueError, match="RGB"):
        api.stitch_to_file(gray, str(tmp_path / "g.png"), stream=True,
                           config=CPU)


@needs_native
def test_stitch_to_file_grayscale_falls_back(tmp_path):
    """Twin of tests/test_export.py:290-295, equal to the JAX file."""
    rng = _rng("gray-auto")
    imgs = [(rng.integers(0, 256, (40, 30), np.uint8), 1) for _ in range(2)]
    p = api.stitch_to_file(imgs, str(tmp_path / "g.png"), config=CPU)
    jp = jax_api.stitch_to_file(imgs, str(tmp_path / "j.png"))
    back = _decode(p)
    assert back.shape[0] > 40
    np.testing.assert_array_equal(back, _decode(jp))


@needs_native
def test_stitch_to_file_stream_jpeg(tmp_path):
    """Twin of tests/test_export.py:240-248: streamed JPEG bytes equal the
    monolithic encoder's."""
    _, paths = _sources(tmp_path)
    p1, m1 = api.stitch_to_file(paths, str(tmp_path / "s.jpg"), gap=4,
                                quality=90, config=CPU, return_metrics=True)
    p2 = api.stitch_to_file(paths, str(tmp_path / "m.jpg"), gap=4,
                            quality=90, stream=False, config=CPU)
    assert m1.export_s > 0
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_stitch_to_file_native_fallback(tmp_path, monkeypatch):
    """Twin of tests/test_export.py:251-261: without the native codec
    ``"auto"`` takes the monolithic encoder and says so once."""
    _, paths = _sources(tmp_path, 2)
    log = StitchLogger()
    set_logger(log)
    monkeypatch.setattr(api, "_native_available", lambda: False)
    try:
        p = api.stitch_to_file(paths, str(tmp_path / "f.png"), gap=1,
                               config=CPU)
        api.stitch_to_file(paths, str(tmp_path / "f3.png"), gap=1,
                           config=CPU)
    finally:
        set_logger(StitchLogger())
    p2 = api.stitch_to_file(paths, str(tmp_path / "f2.png"), gap=1,
                            stream=False, config=CPU)
    np.testing.assert_array_equal(_decode(p), _decode(p2))
    assert [e["tag"] for e in log.ring()].count(
        "export.native_missing_monolithic") == 1
    assert not any(e["tag"].startswith("export.stream") for e in log.ring())


def test_stream_true_without_native_raises(tmp_path, monkeypatch):
    """``stream=True`` requires the native codec: its absence is an error,
    not a silent move to the monolithic encoder."""
    _, paths = _sources(tmp_path, 2)
    monkeypatch.setattr(api, "_native_available", lambda: False)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="native codec unavailable"):
        api.stitch_to_file(paths, str(tmp_path / "t.png"), stream=True,
                           config=CPU)
    assert not (tmp_path / "t.png").exists()


# ------------------------------------------------------- pure-blit export

def _both_files(tmp_path, items, name, **kw):
    """The port's and the JAX package's ``stitch_to_file`` on ``items``:
    (port path, port metrics, JAX path)."""
    port_kw = dict(kw)
    jax_kw = dict(kw)
    if "options" in kw:
        jax_kw["options"] = jax_config.StitchOptions(
            **dataclasses.asdict(kw["options"]))
    p, m = api.stitch_to_file(items, str(tmp_path / f"{name}.png"),
                              config=port_kw.pop("config", CPU),
                              return_metrics=True, **port_kw)
    jax_kw.pop("config", None)
    jp, jm = jax_api.stitch_to_file(items, str(tmp_path / f"{name}-j.png"),
                                    return_metrics=True, **jax_kw)
    assert jm.strategy == m.strategy
    return p, m, jp


def _png_files(tmp_path, imgs, name):
    return [codec.encode(str(tmp_path / f"{name}{i}.png"), a)
            for i, a in enumerate(imgs)]


def _oracle_file(items, out_png, specs, opts):
    plan = solve(specs, opts)
    imgs = [np.asarray(it[0]) if isinstance(it, tuple)
            else it if isinstance(it, np.ndarray) else _decode(it)
            for it in items]
    np.testing.assert_array_equal(_decode(out_png), oracle.stitch(plan, imgs))


@needs_native
def test_blit_stream_equal_sizes_vertical(tmp_path):
    rng = _rng("blit-v")
    imgs = [rng.integers(0, 256, (120, 200, 3), np.uint8) for _ in range(4)]
    paths = _png_files(tmp_path, imgs, "v")
    p, m, jp = _both_files(tmp_path, paths, "out", gap=7)
    assert m.strategy == "host-blit-stream"
    assert m.compute_s == 0 and m.readback_s == 0 and m.h2d_bytes == 0
    _oracle_file(paths, p, [ImageSpec(200, 120)] * 4, StitchOptions(gap=7))
    np.testing.assert_array_equal(_decode(p), _decode(jp))


@needs_native
def test_blit_stream_original_mode_offsets_background(tmp_path):
    rng = _rng("blit-o")
    imgs = [rng.integers(0, 256, (60, 200, 3), np.uint8),
            rng.integers(0, 256, (80, 120, 3), np.uint8)]
    paths = _png_files(tmp_path, imgs, "o")
    opts = StitchOptions(mode="original", gap=3, background=(10, 200, 30))
    p, m, jp = _both_files(tmp_path, paths, "out", options=opts)
    assert m.strategy == "host-blit-stream"
    _oracle_file(paths, p, [ImageSpec(a.shape[1], a.shape[0]) for a in imgs],
                 opts)
    np.testing.assert_array_equal(_decode(p), _decode(jp))


@needs_native
def test_blit_stream_exif_orientation(tmp_path):
    rng = _rng("blit-e")
    a = rng.integers(0, 256, (90, 140, 3), np.uint8)
    b = rng.integers(0, 256, (140, 90, 3), np.uint8)   # rot90 -> 90x140
    items = [(a, 1), (b, 6)]
    opts = StitchOptions(mode="original", gap=2)
    p, m, jp = _both_files(tmp_path, items, "out", options=opts)
    assert m.strategy == "host-blit-stream"
    _oracle_file(items, p, [ImageSpec(140, 90, 1), ImageSpec(90, 140, 6)],
                 opts)
    np.testing.assert_array_equal(_decode(p), _decode(jp))


@needs_native
def test_blit_stream_horizontal(tmp_path):
    rng = _rng("blit-h")
    imgs = [rng.integers(0, 256, (150, 90, 3), np.uint8) for _ in range(3)]
    paths = _png_files(tmp_path, imgs, "h")
    opts = StitchOptions(direction="horizontal", gap=4)
    p, m, jp = _both_files(tmp_path, paths, "out", options=opts)
    assert m.strategy == "host-blit-stream"
    _oracle_file(paths, p, [ImageSpec(90, 150)] * 3, opts)
    np.testing.assert_array_equal(_decode(p), _decode(jp))


@needs_native
def test_blit_stream_jpeg_extension(tmp_path):
    rng = _rng("blit-j")
    imgs = [rng.integers(0, 256, (64, 64, 3), np.uint8) for _ in range(2)]
    paths = _png_files(tmp_path, imgs, "j")
    p, m = api.stitch_to_file(paths, str(tmp_path / "j.jpg"), gap=2,
                              config=CPU, return_metrics=True)
    assert m.strategy == "host-blit-stream"
    assert _decode(p).shape == (m.canvas_h, m.canvas_w, 3)
    jp = jax_api.stitch_to_file(paths, str(tmp_path / "jj.jpg"), gap=2)
    assert open(p, "rb").read() == open(jp, "rb").read()


@needs_native
def test_blit_stream_skipped_for_resample_jobs(tmp_path):
    _, paths = _sources(tmp_path)
    _, m = api.stitch_to_file(paths, str(tmp_path / "r.png"), gap=4,
                              config=CPU, return_metrics=True)
    assert m.strategy != "host-blit-stream"


@needs_native
def test_blit_stream_skipped_for_on_error_skip(tmp_path):
    rng = _rng("blit-s")
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = _png_files(tmp_path, imgs, "s")
    _, m = api.stitch_to_file(paths, str(tmp_path / "s.png"),
                              on_error="skip", config=CPU,
                              return_metrics=True)
    assert m.strategy != "host-blit-stream"


def _corrupt_after_header(path):
    raw = bytearray(open(path, "rb").read())
    raw[40:] = b"\0" * (len(raw) - 40)
    open(path, "wb").write(bytes(raw))


@needs_native
def test_blit_stream_decode_failure_cleans_up(tmp_path):
    rng = _rng("blit-f")
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = _png_files(tmp_path, imgs, "f")
    _corrupt_after_header(paths[1])     # the header probe passes
    out = str(tmp_path / "fail.png")
    with pytest.raises(Exception):
        api.stitch_to_file(paths, out, config=CPU)
    assert not os.path.exists(out)


@needs_native
def test_blit_stream_skipped_for_overlap_never(tmp_path):
    rng = _rng("blit-n")
    imgs = [rng.integers(0, 256, (50, 80, 3), np.uint8) for _ in range(2)]
    paths = _png_files(tmp_path, imgs, "n")
    _, m = api.stitch_to_file(paths, str(tmp_path / "n.png"),
                              config=dataclasses.replace(CPU,
                                                         overlap="never"),
                              return_metrics=True)
    assert m.strategy != "host-blit-stream"


@needs_native
def test_blit_stream_zero_area_corrupt_image_still_raises(tmp_path):
    rng = _rng("blit-z")
    wide = rng.integers(0, 256, (1, 1000, 3), np.uint8)   # scales to 0 rows
    tall = rng.integers(0, 256, (50, 50, 3), np.uint8)
    p_wide = codec.encode(str(tmp_path / "w.png"), wide)
    p_tall = codec.encode(str(tmp_path / "t.png"), tall)
    _corrupt_after_header(p_wide)
    out = str(tmp_path / "z.png")
    with pytest.raises(Exception):
        api.stitch_to_file([p_tall, p_wide], out, mode="min", config=CPU)
    assert not os.path.exists(out)


@needs_native
def test_blit_stream_touches_no_device(tmp_path):
    """The pure-copy export needs no device: a ``cuda`` config on a host
    without one still writes the file."""
    rng = _rng("blit-d")
    imgs = [rng.integers(0, 256, (40, 64, 3), np.uint8) for _ in range(9)]
    paths = _png_files(tmp_path, imgs, "d")
    p, m = api.stitch_to_file(paths, str(tmp_path / "d.png"), gap=1,
                              config=RuntimeConfig(device="cuda"),
                              return_metrics=True)
    assert m.strategy == "host-blit-stream"
    _oracle_file(paths, p, [ImageSpec(64, 40)] * 9, StitchOptions(gap=1))


# --------------------------------------------------- ack-window backpressure

class _LiveTracker:
    """Counts live decoded arrays: +1 at creation, -1 at GC (finalizer)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.live = self.peak = self.created = 0

    def make(self, shape, fill):
        arr = np.full(shape, fill, np.uint8)
        with self.lock:
            self.live += 1
            self.created += 1
            self.peak = max(self.peak, self.live)
        weakref.finalize(arr, self._dec)
        return arr

    def _dec(self):
        with self.lock:
            self.live -= 1


@needs_native
def test_stream_blit_peak_residency_bounded(tmp_path):
    """Twin of tests/test_backpressure.py:173-210: a tall vertical strip
    streams with peak decoded sources about the window, not O(n)."""
    n, w, h = 24, 4096, 512
    tracker = _LiveTracker()
    plan = solve([ImageSpec(w, h)] * n,
                 StitchOptions(direction="vertical", mode="min",
                               supersample=False, max_images=None))
    copies = geometry.plan_copy_offsets(plan)
    assert copies is not None
    loaders = [(lambda k=k: tracker.make((h, w, 3), (7 * k + 3) % 251))
               for k in range(n)]
    out = tmp_path / "strip.png"
    window = 6
    phases = export.stream_blit_to_file(plan, loaders, str(out), "png", 1,
                                        copies, decode_threads=4,
                                        window=window)
    assert phases["wall_s"] > 0 and phases["overlapped"]
    assert tracker.created == n
    assert tracker.peak <= window + 2, tracker.peak
    got = _decode(out)
    assert got.shape == (plan.canvas_h, plan.canvas_w, 3)
    for k in (0, n // 2, n - 1):
        r = plan.placements[k].row_span[0] + h // 2
        assert (got[r] == (7 * k + 3) % 251).all(), k


def test_blit_routing_has_no_total_bytes_cap():
    """Twin of tests/test_backpressure.py:213-230."""
    assert not hasattr(api, "_BLIT_MAX_SRC_BYTES")
    n, w, h = 200, 4000, 3000
    limits = CanvasLimits(max_side=1 << 24, max_pixels=1 << 34)
    plan = solve([ImageSpec(w, h)] * n,
                 StitchOptions(direction="vertical", mode="min",
                               supersample=False, max_images=None), limits)
    assert plan.canvas_h == n * h
    copies = api._blit_copies(plan, RuntimeConfig().validate())
    assert copies is not None and len(copies) == n
    assert api._blit_copies(plan, RuntimeConfig(engine="torch")) is None


@needs_native
def test_stream_blit_decode_error_still_aborts(tmp_path):
    """Twin of tests/test_backpressure.py:233-256."""
    n, w, h = 6, 256, 64
    plan = solve([ImageSpec(w, h)] * n,
                 StitchOptions(direction="vertical", mode="min",
                               supersample=False))
    copies = geometry.plan_copy_offsets(plan)

    def bad():
        raise OSError("truncated")

    loaders = [(lambda: np.zeros((h, w, 3), np.uint8))] * (n - 1) + [bad]
    out = tmp_path / "x.png"
    with pytest.raises(OSError):
        export.stream_blit_to_file(plan, loaders, str(out), "png", 1,
                                   copies, decode_threads=3, window=3)
    assert not out.exists()


@needs_native
def test_stream_blit_equals_jax_file(tmp_path):
    """The port's pure-copy export and the JAX package's on the same plan
    and loaders write files that decode equal."""
    from imagestitching_tpu.core import geometry as jax_geometry
    from imagestitching_tpu.core import layout as jax_layout

    rng = _rng("blit-eq")
    imgs = [rng.integers(0, 256, (70, 90, 3), np.uint8) for _ in range(5)]
    loaders = [functools.partial(lambda a: a, a) for a in imgs]
    opts = StitchOptions(gap=3, background=(1, 2, 3))
    plan = solve([ImageSpec(90, 70)] * 5, opts)
    jplan = jax_layout.solve([jax_layout.ImageSpec(90, 70)] * 5,
                             jax_config.StitchOptions(
                                 **dataclasses.asdict(opts)))
    export.stream_blit_to_file(plan, loaders, str(tmp_path / "p.png"), "png",
                               6, geometry.plan_copy_offsets(plan), 2)
    jax_export.stream_blit_to_file(jplan, loaders, str(tmp_path / "j.png"),
                                   "png", 6,
                                   jax_geometry.plan_copy_offsets(jplan), 2)
    np.testing.assert_array_equal(_decode(tmp_path / "p.png"),
                                  _decode(tmp_path / "j.png"))
