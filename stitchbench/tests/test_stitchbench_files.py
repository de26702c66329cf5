"""The benchmark's files: ``BENCHMARK.json`` against the contract's shape,
every name leading to its file, and a cell, a configuration and a metric
added as new files only."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

from stitchbench import harness
from stitchbench.harness import ROOT, Cell

SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
BENCH = os.path.join(ROOT, "stitchbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "stitchbench/run.py"]
    assert SPEC["paths"] == ["stitchbench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_keys_names_and_lines():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    seen = set()
    for group, want in keys.items():
        for e in SPEC[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add((group, e["name"]))
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
                    assert "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert [m for m in SPEC["end_to_end"] if m["name"] == "setup_s"]
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for cell in CELLS:
        c = Cell(cell)
        names = [m["name"] for m in c.metrics(False)]
        assert "setup_s" in names and len(names) >= 2
        layers = c.metrics(True)
        assert layers
        for m in layers:
            # the metric it moves is reported in every cell that lists it
            assert m["moves"] in names, (cell, m["name"])
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_names_lead_to_files():
    for c in SPEC["configs"]:
        cfg = harness.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("stitchbench/configs/")
        assert cfg["source"] == c["source"]
        assert set(cfg["correct"]) == {"resampled_max_diff",
                                       "exact_max_diff", "mismatch_ppm"}
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for cell in CELLS:
        c = Cell(cell)
        assert c.workload["config"] == c.entry["config"]
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{c.kind}.py"))
        for m in c.metrics(False) + c.metrics(True):
            assert callable(c.reader(m["name"]).read)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _py_files(top):
    for d, _, files in os.walk(top):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_jax_and_a_reference_without_the_port():
    for path in _py_files(BENCH):
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, \
                (path, name)
    for path in _py_files(os.path.join(BENCH, "reference")):
        for name in _imports(path):
            assert name.split(".")[0] != "imagestitching_tpu_torch", path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    fake = object()
    for name in ("imagestitching_tpu_torch", "imagestitching_tpu_torch.api",
                 "jaxtyping", "flaxen", "jax_like"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert harness.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "imagestitching_tpu.core", fake)
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    assert harness.loaded_forbidden() == ["imagestitching_tpu", "jax"]


def _fixture_config(name, like, **fields):
    cfg = harness.load_json(os.path.join(BENCH, "configs", f"{like}.json"))
    cfg.update(name=name, **fields)
    return cfg


FIXTURES = {
    # a phone cell under a budget given in bytes, small enough that the
    # port bands the canvas; its metric reads the strategy of every job
    "phone4_banded.arrays": (
        _fixture_config("phone4_banded", "phone12mp_exif",
                        shapes=[[400, 300, 1], [300, 400, 1], [500, 300, 6],
                                [200, 200, 3]],
                        runtime={"budget": 1_000_000}),
        {"kind": "closed_stitch",
         "params": {"inputs": "arrays", "pool_jobs": 3, "check_jobs": 2}},
        "job_ms_p50", "banded_share.fixture",
        "def read(rec):\n"
        "    jobs = [j for j in rec['jobs'] if j['ok']]\n"
        "    return 100.0 * sum('banded' in j['m']['strategy']\n"
        "                       for j in jobs) / len(jobs)\n",
        100.0),
    # a server cell whose server fields pass to StitchServer: flushes of
    # at most 2 jobs, though 4 clients wait
    "serve4_pairs.closed4": (
        _fixture_config("serve4_pairs", "serve64_1080p",
                        shapes=[[64, 48, 1], [80, 60, 6], [64, 64, 1]],
                        server={"max_batch": 2, "max_wait_s": 0.05,
                                "max_queue": 64},
                        runtime={"budget": 1 << 30}),
        {"kind": "closed_server",
         "params": {"clients": 4, "pool_jobs": 4, "warm_batches": [2],
                    "check_jobs": 4}},
        "jobs_per_s", "flush_jobs.fixture",
        "def read(rec):\n"
        "    d = rec['server']\n"
        "    return d['jobs'] / d['batches']\n",
        None),
}


def test_a_cell_config_and_metric_added_as_new_files_only(tmp_path):
    """A checkout with new configurations, cells and per-layer metrics,
    each as new files and new ``BENCHMARK.json`` entries, runs the new
    cells with no existing file edited: a budget in bytes and the server's
    own fields are data."""
    shutil.copytree(BENCH, tmp_path / "stitchbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "imagestitching_tpu_torch"),
               tmp_path / "imagestitching_tpu_torch")
    before = {p: open(p, "rb").read() for p in _py_files(
        tmp_path / "stitchbench")}
    spec = json.loads(json.dumps(SPEC))
    for cell, (cfg, workload, e2e, metric, code, _) in FIXTURES.items():
        name = cfg["name"]
        (tmp_path / f"stitchbench/configs/{name}.json").write_text(
            json.dumps(cfg))
        (tmp_path / f"stitchbench/workloads/{cell}.json").write_text(
            json.dumps({"config": name, **workload}))
        (tmp_path / f"stitchbench/metrics/{metric}.py").write_text(code)
        spec["configs"].append({**spec["configs"][0], "name": name,
                                "file": f"stitchbench/configs/{name}.json"})
        spec["workloads"].append({"name": cell, "config": name,
                                  "traffic": cell.split(".")[1], "chips": 1,
                                  "why": "a fixture"})
        for m in spec["end_to_end"]:
            if m["name"] == e2e:
                m["workloads"].append(cell)
        spec["per_layer"].append({"name": metric, "unit": "%",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "api", "moves": e2e,
                                  "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for cell, (_, _, e2e, metric, _, want) in FIXTURES.items():
        for trace in ("0", "1"):
            out = subprocess.run(
                [sys.executable, "stitchbench/run.py", "--workload", cell,
                 "--seed", "2147483659", "--seconds", "1", "--trace", trace,
                 "--rehearse"], cwd=tmp_path, capture_output=True,
                text=True, timeout=240)
            assert out.returncode == 0, out.stderr[-2000:]
            line = json.loads(out.stdout.strip().splitlines()[-1])
            assert line["correct"] is True, line["checks"]
            got = line["metrics"]
            if trace == "0":
                assert set(got) == {e2e, "setup_s"}
                continue
            assert set(got) == {metric}
            if want is not None:
                assert got[metric]["value"] == want
            else:
                assert 1.0 <= got[metric]["value"] <= 2.0
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
