"""The port's command line, ``python -m imagestitching_tpu_torch.cli``, on the
CPU (``--device cpu``): twins of tests/test_api_cli.py:199-298, 354-361,
444-452 and tests/test_recovery.py:120-150, each run beside the JAX
package's CLI on the same files.

The port's CLI runs in a subprocess where the test is about the command
itself, and in-process (``cli.main(argv)``) elsewhere; the JAX CLI runs
in-process.  Tolerances: outputs that only copy pixels, or that come from
the float64 oracle engine, decode equal to the JAX CLI's; resampled
outputs within 1 uint8 step; the port's streamed and monolithic files
decode equal.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from imagestitching_tpu import cli as jax_cli
from imagestitching_tpu_torch import cli
from imagestitching_tpu_torch.imgio import codec

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _png(path, w, h, seed):
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(path)
    return path


def _run(main, argv):
    """(exit code, stdout, stderr) of ``main(argv)`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main([str(a) for a in argv])
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def run_port(*argv):
    return _run(cli.main, argv)


def run_jax(*argv):
    return _run(jax_cli.main, argv)


def run_port_process(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.cli",
         *map(str, argv)], cwd=_ROOT, env=env, capture_output=True,
        text=True, timeout=300)


def _decoded(path):
    return codec.decode(open(path, "rb").read())[0]


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _both(tmp_path, inputs, *flags, jax_flags=()):
    """Run both CLIs on ``inputs`` with ``flags`` (the port's with
    ``--device cpu``); returns (port result JSON, port output, JAX output)."""
    po, jo = tmp_path / "port.png", tmp_path / "jax.png"
    rc, out, err = run_port(*inputs, "-o", po, "--device", "cpu", *flags)
    assert rc == 0, err
    jrc, _, jerr = run_jax(*inputs, "-o", jo, *flags, *jax_flags)
    assert jrc == 0, jerr
    return (json.loads(out) if "--json" in flags else None,
            _decoded(po), _decoded(jo))


def test_cli_basic(tmp_path):
    """The command in a subprocess: two equal-width files stack into 32x40,
    decoded equal to the JAX CLI's output."""
    a = _png(tmp_path / "a.png", 32, 16, 1)
    b = _png(tmp_path / "b.png", 32, 24, 2)
    out = tmp_path / "out.png"
    r = run_port_process(a, b, "-o", out, "--device", "cpu", "--json")
    assert r.returncode == 0, r.stderr
    res = json.loads(r.stdout)
    assert (res["width"], res["height"]) == (32, 40)
    assert codec.get_image_info(out).raw_h == 40
    jo = tmp_path / "jax.png"
    assert run_jax(a, b, "-o", jo)[0] == 0
    np.testing.assert_array_equal(_decoded(out), _decoded(jo))


def test_cli_options(tmp_path):
    a = _png(tmp_path / "a.png", 20, 10, 3)
    res, got, want = _both(tmp_path, [a, a], "--direction", "horizontal",
                           "--mode", "original", "--gap", "5",
                           "--background", "0,0,0", "--engine", "oracle",
                           "--json")
    assert (res["width"], res["height"]) == (45, 10)
    np.testing.assert_array_equal(got, want)


def test_cli_stream_matches_no_stream(tmp_path):
    a = _png(tmp_path / "a.png", 32, 16, 4)
    b = _png(tmp_path / "b.png", 40, 24, 5)
    o1, o2 = tmp_path / "s.png", tmp_path / "m.png"
    r1 = run_port(a, b, "-o", o1, "--device", "cpu", "--gap", "3", "--json")
    r2 = run_port(a, b, "-o", o2, "--device", "cpu", "--gap", "3",
                  "--no-stream", "--json")
    assert r1[0] == 0 and r2[0] == 0, (r1[2], r2[2])
    np.testing.assert_array_equal(_decoded(o1), _decoded(o2))
    jo = tmp_path / "j.png"
    assert run_jax(a, b, "-o", jo, "--engine", "xla", "--gap", "3")[0] == 0
    assert _maxdiff(_decoded(o1), _decoded(jo)) <= 1


def test_cli_bad_inputs(tmp_path):
    a = _png(tmp_path / "a.png", 8, 8, 6)
    rc, _, err = run_port(a, "-o", tmp_path / "o.png", "--device", "cpu",
                          "--background", "purple")
    assert rc == 2 and "background" in err
    rc, _, err = run_port(tmp_path / "missing.png", "-o", tmp_path / "o.png",
                          "--device", "cpu", "--engine", "oracle")
    assert rc == 1 and "error" in err.lower()
    assert run_jax(tmp_path / "missing.png", "-o", tmp_path / "j.png",
                   "--engine", "oracle")[0] == 1


def test_cli_max_pixels_scale_down(tmp_path):
    a = _png(tmp_path / "a.png", 100, 100, 7)
    res, got, want = _both(tmp_path, [a, a], "--max-pixels", "5000",
                           "--engine", "oracle", "--json")
    assert res["width"] * res["height"] <= 5000
    np.testing.assert_array_equal(got, want)


def test_cli_runtime_flags(tmp_path):
    """Twin of tests/test_api_cli.py:267-283; the metrics carry the JAX
    CLI's keys."""
    a = _png(tmp_path / "a.png", 60, 40, 8)
    flags = ("--hbm-budget", "0.001", "--decode-threads", "2",
             "--decode-timeout", "15", "--overlap", "never", "--metrics",
             "--json")
    rc, out, err = run_port(a, a, "-o", tmp_path / "o.png", "--device",
                            "cpu", *flags)
    assert rc == 0, err
    res = json.loads(out)
    assert res["width"] == 60 and res["height"] == 80
    m = res["metrics"]
    assert m["strategy"] in ("resident", "streamed", "banded", "host-blit")
    assert m["canvas_w"] == 60 and m["canvas_h"] == 80
    jrc, jout, jerr = run_jax(a, a, "-o", tmp_path / "j.png", "--engine",
                              "xla", *flags)
    assert jrc == 0, jerr
    assert set(m) == set(json.loads(jout)["metrics"])
    np.testing.assert_array_equal(_decoded(tmp_path / "o.png"),
                                  _decoded(tmp_path / "j.png"))


def test_cli_overlap_always_metrics(tmp_path):
    a = _png(tmp_path / "a.png", 30, 30, 9)
    b = _png(tmp_path / "b.png", 26, 30, 10)
    res, got, want = _both(tmp_path, [a, b, a], "--overlap", "always",
                           "--metrics", "--json", jax_flags=("--engine",
                                                             "xla"))
    assert res["metrics"]["strategy"] == "overlapped"
    assert res["metrics"]["h2d_bytes"] > 0
    assert _maxdiff(got, want) <= 1


def test_cli_nine_files_overlapped_and_streamed(tmp_path):
    """A 9-file job takes the overlapped scheduler and the streamed export;
    its file equals ``--overlap never --no-stream`` and the JAX CLI's within
    1."""
    files = [_png(tmp_path / f"{i}.png", 40 + 3 * i, 30 + 2 * (i % 4), i)
             for i in range(9)]
    res, got, want = _both(tmp_path, files, "--gap", "2", "--metrics",
                           "--json", jax_flags=("--engine", "xla"))
    assert res["metrics"]["strategy"] == "overlapped"
    assert res["metrics"]["export_s"] > 0
    assert _maxdiff(got, want) <= 1
    o2 = tmp_path / "never.png"
    rc, _, err = run_port(*files, "-o", o2, "--device", "cpu", "--gap", "2",
                          "--overlap", "never", "--no-stream")
    assert rc == 0, err
    np.testing.assert_array_equal(got, _decoded(o2))


def test_cli_hbm_budget_auto(tmp_path):
    a = _png(tmp_path / "a.png", 16, 16, 11)
    res, got, want = _both(tmp_path, [a], "--hbm-budget", "auto", "--json")
    assert (res["width"], res["height"]) == (16, 16)
    np.testing.assert_array_equal(got, want)


def test_cli_decode_window_zero_usage_error(tmp_path):
    """Twin of tests/test_api_cli.py:444-452."""
    a = _png(tmp_path / "a.png", 8, 8, 12)
    rc, _, err = run_port(a, a, "-o", tmp_path / "o.png", "--device", "cpu",
                          "--decode-window", "0")
    assert rc == 2 and "decode-window" in err and "Traceback" not in err
    assert run_jax(a, a, "-o", tmp_path / "j.png", "--decode-window",
                   "0")[0] == 2


def test_cli_parity_profile_android(tmp_path):
    """Twin of tests/test_recovery.py:120-137."""
    a = _png(tmp_path / "a.png", 600, 300, 13)
    res, got, want = _both(tmp_path, [a] * 2, "--direction", "horizontal",
                           "--parity-profile", "android", "--engine",
                           "oracle", "--json")
    assert (res["width"], res["height"]) == (1200, 300)
    np.testing.assert_array_equal(got, want)
    rc, out, err = run_port(*([a] * 8), "-o", tmp_path / "o8.png",
                            "--device", "cpu", "--direction", "horizontal",
                            "--parity-profile", "android", "--engine",
                            "oracle", "--json")
    assert rc == 0, err
    assert json.loads(out)["width"] <= 4096


def test_cli_parity_profile_with_supersample(tmp_path):
    """Twin of tests/test_recovery.py:140-148."""
    a = _png(tmp_path / "a.png", 100, 100, 14)
    res, got, want = _both(tmp_path, [a], "--parity-profile", "ios",
                           "--supersample", "--engine", "oracle", "--json")
    assert res["width"] == 220
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flag", [["--grid-cols", "2"], ["--merge-overlap"]])
def test_cli_extensions_not_yet_ported(tmp_path, flag):
    """``--grid-cols 2`` on four equal tiles writes their blit mosaic (twin
    of tests/test_grid.py:296-317); ``--merge-overlap`` on two strips cut
    with 50 shared rows writes the capture (tests/test_merge_overlap.py:
    170-190); each decoded equal to the JAX CLI's file."""
    rng = np.random.default_rng(15)
    if flag[0] == "--grid-cols":
        imgs = [rng.integers(0, 256, (60, 50, 3), np.uint8)
                for _ in range(4)]
        want = np.hstack([np.vstack([imgs[0], imgs[2]]),
                          np.vstack([imgs[1], imgs[3]])])
        flags = [*flag, "--gap", "0"]
    else:
        want = rng.integers(0, 256, (420, 70, 3), np.uint8)
        imgs = [want[:240], want[190:]]
        flags = flag
    paths = []
    for i, a in enumerate(imgs):
        paths.append(tmp_path / f"in{i}.png")
        Image.fromarray(a).save(paths[-1])
    res, got, theirs = _both(tmp_path, paths, *flags, "--json",
                             "--metrics")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, theirs)
    assert (res["width"], res["height"]) == (want.shape[1], want.shape[0])
    if flag[0] == "--grid-cols":
        assert res["metrics"]["strategy"] == "grid(host-blit,host-blit)"
        assert res["metrics"]["encode_s"] > 0


@pytest.mark.parametrize("argv", [[], ["--hbm-budget", "auto"]])
def test_cli_cuda_device_without_cuda_fails(tmp_path, argv):
    """The default device is the card; without one the job (or the budget
    probe) fails with exit 1 and never runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    a = _png(tmp_path / "a.png", 30, 20, 16)
    b = _png(tmp_path / "b.png", 24, 20, 17)
    out = tmp_path / "o.png"
    rc, _, err = run_port(a, b, "-o", out, *argv)
    assert rc == 1 and "CUDA is not available" in err
    assert not out.exists()


@pytest.mark.parametrize("argv,needle", [
    (["--engine", "cuda", "--device", "cpu"], "CUDA device"),
    (["--engine", "pallas", "--device", "cpu"], "invalid choice")])
def test_cli_engine_flags(tmp_path, argv, needle):
    a = _png(tmp_path / "a.png", 8, 8, 18)
    rc, _, err = run_port(a, "-o", tmp_path / "o.png", *argv)
    assert rc in (1, 2) and needle in err


def test_cli_help_names_the_port_flags():
    rc, out, _ = run_port("--help")
    assert rc == 0
    assert "--device" in out and "auto,cuda,torch,oracle" in out.replace(
        " ", "").replace("{", "").replace("}", "")
