"""The entry point as a check starts it: no result without a card, and
none in a directory that holds only the benchmark."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from stitchbench.harness import ROOT

ARGS = ["--workload", "phone12mp_exif.arrays", "--seed", "2147483659",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, *extra):
    return subprocess.run([sys.executable, "stitchbench/run.py", *ARGS,
                           *extra], cwd=cwd, capture_output=True, text=True,
                          timeout=240)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would measure")
    out = _run(ROOT)
    assert out.returncode == 2
    assert "needs 1 CUDA card" in out.stderr
    assert out.stdout.strip() == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(os.path.join(ROOT, "stitchbench"),
                    tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    out = _run(tmp_path, "--rehearse")
    assert out.returncode != 0
    assert "imagestitching_tpu_torch" in out.stderr
    assert not any(line.startswith("{")
                   for line in out.stdout.splitlines())


def test_rehearsal_line_ends_with_the_checks():
    out = _run(ROOT, "--rehearse")
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    tail = out.stderr.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    assert all(" limit " in t for t in tail)
