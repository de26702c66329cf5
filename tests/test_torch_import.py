"""The port stands apart from JAX, and ``chip_smoke.py`` refuses to report
without a card.

The test process itself has JAX loaded (tests/conftest.py imports it), so
the import checks run in fresh subprocesses.
"""

import os
import re
import shutil
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PORT = os.path.join(_ROOT, "imagestitching_tpu_torch")

_IMPORT_ONLY = """
import sys
import imagestitching_tpu_torch
assert "jax" not in sys.modules and "torch" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "torch"))
"""

_CPU_STITCH = """
import sys
import numpy as np
import imagestitching_tpu_torch as itt
rng = np.random.default_rng(0)
items = [(rng.integers(0, 256, (30, 40, 3), np.uint8), 6),
         (rng.integers(0, 256, (20, 50, 3), np.uint8), 1)]
out, m = itt.stitch(items, direction="horizontal", gap=2,
                    config=itt.RuntimeConfig(device="cpu"),
                    return_metrics=True)
assert m.strategy == "resident" and out.shape[0] == 20, (m, out.shape)
import torch
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""

_CPU_LADDER = """
import sys
import numpy as np
import imagestitching_tpu_torch as itt
from imagestitching_tpu.core.layout import ImageSpec, solve
from imagestitching_tpu.runtime import tiler
rng = np.random.default_rng(1)
specs = [ImageSpec(60, 40, 1), ImageSpec(40, 30, 6)]
imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8) for s in specs]
opts = itt.StitchOptions(gap=2)
plan = solve(specs, opts)
canvas = 3 * plan.canvas_w * plan.canvas_h
for strategy, hbm in (("streamed", tiler.resident_peak_bytes(plan) - 1),
                      ("banded", max(canvas // 2,
                                     tiler.min_feasible_bytes(plan)))):
    cfg = itt.RuntimeConfig(device="cpu",
                            budget=itt.MemoryBudget(hbm_bytes=hbm))
    out, m = itt.stitch_arrays(imgs, specs, opts, cfg, return_metrics=True)
    assert m.strategy == strategy, m
import torch
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""


_SERVE_IMPORT = """
import sys
import imagestitching_tpu_torch.parallel.batch
import imagestitching_tpu_torch.serve.http
from imagestitching_tpu_torch import StitchHTTPServer, StitchServer
assert "torch" in sys.modules
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""


@pytest.mark.parametrize("script", [_IMPORT_ONLY, _CPU_STITCH,
                                    _CPU_LADDER, _SERVE_IMPORT],
                         ids=["import", "cpu-stitch", "cpu-ladder",
                              "serve-import"])
def test_port_never_loads_jax(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    files = [os.path.join(d, f) for d, _, fs in os.walk(_PORT)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(_ROOT, "chip_smoke.py"))
    assert len(files) >= 9
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_kernel_source_is_in_the_package():
    with open(os.path.join(_PORT, "csrc", "resize_place.cu")) as f:
        src = f.read()
    assert 'extern "C"' in src and "int resize_place_launch(" in src
    assert "int resize_place_batch_launch(" in src
    assert "int resize_place_window_launch(" in src


def test_server_module_runs_with_help():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.serve.http",
         "--help"], cwd=_ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--max-batch" in proc.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without CUDA (this host), or in a directory that holds only the
    script, chip_smoke.py exits non-zero and prints no result."""
    script = os.path.join(_ROOT, "chip_smoke.py")
    cwd = _ROOT
    if where == "alone":
        cwd = str(tmp_path)
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
