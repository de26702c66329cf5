"""The port stands apart from JAX and from the JAX package, and
``chip_smoke.py`` refuses to report without a card.

The test process itself has JAX loaded (tests/conftest.py imports it), so
the import checks run in fresh subprocesses: once as they are, and once
more with a ``sys.meta_path`` finder that makes ``imagestitching_tpu``
unimportable, so the port's entry points (the CPU stitch, the ladder, the
server, ``serve.http --help``, the CLI's ``--help``, the staged-band
profiler's ``--help``, a CPU CLI job, the
top-level names, the extensions: grid, merge and preview, and the mesh
paths: a space-sharded job and a batch over a jobs mesh of ``cpu``
devices) are shown to run on its own copies of the host layers.  An AST walk over every module
of the port and over ``chip_smoke.py`` finds no import of ``jax`` or
``imagestitching_tpu``; the port's top level exports the JAX package's
names, eagerly and lazily, under the same split.
"""

import ast
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
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.runtime import tiler
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


_CPU_CLI = """
import os
import sys
import tempfile
import numpy as np
from PIL import Image
from imagestitching_tpu_torch import cli
rng = np.random.default_rng(2)
with tempfile.TemporaryDirectory() as td:
    paths = []
    for i in range(7):
        paths.append(os.path.join(td, f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, (20 + i, 30 + 2 * i, 3),
                                     np.uint8)).save(paths[-1])
    out = os.path.join(td, "out.png")
    assert cli.main([*paths, "-o", out, "--device", "cpu", "--gap", "2",
                     "--json", "--metrics"]) == 0
    assert os.path.getsize(out) > 0
import torch
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""


_TOP_LEVEL = """
import sys
from imagestitching_tpu_torch import (
    CanvasLimits, DIRECTIONS, ImageSpec, LayoutPlan, MemoryBudget, MODES,
    Placement, RuntimeConfig, StitchOptions, SUPPORTED_TYPES, solve)
plan = solve([ImageSpec(40, 30, 6), ImageSpec(20, 10)], StitchOptions(gap=2))
assert isinstance(plan, LayoutPlan) and DIRECTIONS[0] == "vertical"
assert "torch" not in sys.modules and "jax" not in sys.modules
from imagestitching_tpu_torch import (ArtifactStore, make_preview, prepare,
                                      preview_size, stitch_grid)
assert preview_size(400, 200, 100) == (100, 180)
"""


_CPU_EXTENSIONS = """
import sys
import numpy as np
import imagestitching_tpu_torch as itt
rng = np.random.default_rng(3)
cpu = itt.RuntimeConfig(device="cpu")
imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
        for h, w in ((40, 30), (25, 50), (30, 20), (44, 36))]
grid, m = itt.stitch_grid(imgs, cols=2, options=itt.StitchOptions(gap=2),
                          config=cpu, return_metrics=True)
assert m.strategy.startswith("grid(") and grid.ndim == 3, m
base = rng.integers(0, 256, (300, 40, 3), np.uint8)
opts = itt.StitchOptions(merge_overlap=True)
out = itt.stitch_arrays([base[:180], base[140:]], options=opts, config=cpu)
assert np.array_equal(out, base)
prev = itt.make_preview(grid, 20, min_height=1, device="cpu")
assert prev.shape[1] == 20, prev.shape
import torch
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""


_CPU_MESH = """
import sys
import numpy as np
import imagestitching_tpu_torch as itt
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.parallel import batch, mesh, sharding
rng = np.random.default_rng(4)
specs = [ImageSpec(60, 40, 6), ImageSpec(40, 30)]
imgs = [rng.integers(0, 256, (s.raw_h, s.raw_w, 3), np.uint8) for s in specs]
cfg = itt.RuntimeConfig(device="cpu",
                        mesh=mesh.make_mesh((1, 4), devices=["cpu"] * 4))
out, m = itt.stitch_arrays(imgs, specs, itt.StitchOptions(gap=2), cfg,
                           return_metrics=True)
assert m.strategy == "space-sharded", m
plan = solve(specs, itt.StitchOptions(gap=2))
stacks = [np.stack([a] * 4) for a in imgs]
got = batch.BatchedStitch(plan, 4, mesh=mesh.make_mesh(
    devices=["cpu"] * 2))(stacks)
assert np.array_equal(got[3], out)
import torch
assert not torch.cuda.is_initialized()
assert "jax" not in sys.modules, sorted(
    m for m in sys.modules if m.split(".")[0] == "jax")
"""


@pytest.mark.parametrize("script", [_IMPORT_ONLY, _CPU_STITCH,
                                    _CPU_LADDER, _SERVE_IMPORT, _CPU_CLI,
                                    _TOP_LEVEL, _CPU_EXTENSIONS, _CPU_MESH],
                         ids=["import", "cpu-stitch", "cpu-ladder",
                              "serve-import", "cpu-cli", "top-level",
                              "cpu-extensions", "cpu-mesh"])
def test_port_never_loads_jax(script):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=_ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


# Makes the JAX package unimportable in the subprocess it starts; the
# port (``imagestitching_tpu_torch``) is another name and stays importable.
_NO_JAX_PACKAGE = """
import sys


class _NoJaxPackage:
    def find_spec(self, name, path=None, target=None):
        if name == "imagestitching_tpu" or name.startswith(
                "imagestitching_tpu."):
            raise ModuleNotFoundError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _NoJaxPackage())
"""

_SERVE_HELP = """
import runpy
runpy.run_module("imagestitching_tpu_torch.serve.http", run_name="__main__")
"""

_CLI_HELP = """
import runpy
runpy.run_module("imagestitching_tpu_torch.cli", run_name="__main__")
"""

_PROFILER_HELP = """
import runpy
runpy.run_module("imagestitching_tpu_torch.tools.profile_bf16_stage",
                 run_name="__main__")
"""

# what ``--help`` of each module must print
_HELP_NEEDLE = {_SERVE_HELP: "--max-batch", _CLI_HELP: "--device",
                _PROFILER_HELP: "--reps"}


@pytest.mark.parametrize("script,argv", [
    (_IMPORT_ONLY, []), (_CPU_STITCH, []), (_CPU_LADDER, []),
    (_SERVE_IMPORT, []), (_SERVE_HELP, ["--help"]), (_CLI_HELP, ["--help"]),
    (_CPU_CLI, []), (_TOP_LEVEL, []), (_CPU_EXTENSIONS, []),
    (_CPU_MESH, []), (_PROFILER_HELP, ["--help"])],
    ids=["import", "cpu-stitch", "cpu-ladder", "serve-import", "serve-help",
         "cli-help", "cpu-cli", "top-level", "cpu-extensions", "cpu-mesh",
         "profiler-help"])
def test_port_runs_without_the_jax_package(script, argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    check = ("\nassert not [m for m in sys.modules if m == "
             "'imagestitching_tpu' or m.startswith('imagestitching_tpu.')]\n")
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_PACKAGE + script + check, *argv],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    if argv:
        assert _HELP_NEEDLE[script] in proc.stdout


def _sources():
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(_PORT)
                   for f in fs if f.endswith(".py"))
    return files + [os.path.join(_ROOT, "chip_smoke.py")]


def test_no_port_source_imports_jax():
    pattern = re.compile(r"^\s*(import\s+jax|from\s+jax)\b", re.M)
    files = _sources()
    assert len(files) >= 9
    for module in ("core/grid.py", "ops/overlap.py", "api.py",
                   "parallel/mesh.py", "parallel/sharding.py",
                   "ops/staged_resize.py", "tools/profile_bf16_stage.py"):
        assert os.path.join(_PORT, module) in files, module
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def _foreign(name):
    return any(name == m or name.startswith(m + ".")
               for m in ("jax", "jaxlib", "imagestitching_tpu"))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, _ROOT))
def test_no_port_module_imports_the_jax_package(path):
    """Every ``import`` and ``from ... import`` of the port and of
    ``chip_smoke.py``, at any depth: none names ``jax`` or
    ``imagestitching_tpu`` (relative imports stay inside the port)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _foreign(node.module or ""):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


def test_kernel_source_is_in_the_package():
    with open(os.path.join(_PORT, "csrc", "resize_place.cu")) as f:
        src = f.read()
    assert 'extern "C"' in src
    for entry in ("resize_place_args_size", "resize_place_prepare",
                  "resize_place_run", "resize_place_window_run"):
        assert f"int {entry}(" in src, entry
    # one launch form: the one-shot shells and their bindings are gone
    with open(os.path.join(_PORT, "ops", "_build.py")) as f:
        build = f.read()
    for form in ("", "_batch", "_window"):
        shell = f"resize_place{form}_launch"
        assert shell not in src and shell not in build, shell
    with open(os.path.join(_PORT, "csrc", "resize_place_staged.cu")) as f:
        src = f.read()
    assert 'extern "C"' in src and "int resize_place_staged_run(" in src
    assert "int resize_place_staged_prepare(StagedArgs* a)" in src
    assert "cp.async.bulk.tensor.2d" in src and "cuTensorMapEncodeTiled" in src


def test_cli_module_runs_with_help():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.cli", "--help"],
        cwd=_ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "--device" in proc.stdout and "--overlap" in proc.stdout


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


def _lazy_names(path):
    """The names the package's module ``__getattr__`` resolves: every
    string it compares ``name`` with."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "__getattr__")
    return {n.value for n in ast.walk(fn)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and n.value.isidentifier()}


def test_top_level_names_equal_the_jax_package():
    """The port exports what ``imagestitching_tpu`` exports, eagerly and
    lazily, under the same split, and every name resolves."""
    import imagestitching_tpu
    import imagestitching_tpu_torch

    assert imagestitching_tpu_torch.__all__ == imagestitching_tpu.__all__
    lazy = _lazy_names(os.path.join(_PORT, "__init__.py"))
    assert lazy == _lazy_names(os.path.join(
        _ROOT, "imagestitching_tpu", "__init__.py"))
    assert {"stitch_grid", "make_preview", "preview_size", "prepare",
            "ArtifactStore"} <= lazy
    constants = ("DIRECTIONS", "MODES", "SUPPORTED_TYPES")
    for name in (set(imagestitching_tpu.__all__) | lazy) - set(constants):
        assert getattr(imagestitching_tpu_torch, name).__module__.startswith(
            "imagestitching_tpu_torch."), name
    for name in constants:
        assert getattr(imagestitching_tpu_torch, name) == getattr(
            imagestitching_tpu, name)
    with pytest.raises(AttributeError):
        imagestitching_tpu_torch.no_such_name
