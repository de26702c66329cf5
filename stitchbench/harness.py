"""The benchmark's machinery that no cell owns: loading a cell by name,
percentiles, spans, the device trace's reduction, the import check and the
result line.

A cell is found by its name alone: ``workloads/<cell>.json`` names its
configuration and its traffic kind; the configuration's file is the one
``BENCHMARK.json`` gives; the traffic kind is ``traffic/<kind>.py``; each
metric is ``metrics/<metric>.py``.  Adding a cell, a configuration or a
metric adds files and ``BENCHMARK.json`` entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: Top-level module names that must not be loaded in a run, compared whole
#: (``imagestitching_tpu_torch`` is the port and allowed).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "imagestitching_tpu")


class BenchError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file)."""


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the file ``path`` as a fresh module called ``name``."""
    if not os.path.isfile(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with everything it names, loaded from
    the files its name leads to."""

    def __init__(self, name: str, root: str = ROOT):
        self.bench_dir = os.path.join(root, "stitchbench")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        entry = [w for w in self.spec["workloads"] if w["name"] == name]
        if not entry:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entry[0]
        self.name = name
        self.workload = load_json(
            os.path.join(self.bench_dir, "workloads", f"{name}.json"))
        cfg = [c for c in self.spec["configs"]
               if c["name"] == self.entry["config"]][0]
        self.config = load_json(os.path.join(root, cfg["file"]))
        self.kind = self.workload["kind"]
        self.params = dict(self.workload["params"])
        self.chips = int(self.entry["chips"])

    def traffic(self):
        return load_module(os.path.join(self.bench_dir, "traffic",
                                        f"{self.kind}.py"),
                           f"stitchbench_traffic_{self.kind}")

    def metrics(self, trace: bool) -> List[dict]:
        """The metrics this cell reports: its ``end_to_end`` ones, or with
        ``trace`` its ``per_layer`` ones (a metric without ``workloads``
        belongs to every cell)."""
        group = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in group
                if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{metric}.py"),
                           "stitchbench_metric_" + metric.replace(".", "_"))


# ------------------------------------------------------------- statistics

def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile by linear interpolation between order
    statistics (``statistics.quantiles(..., method="inclusive")``)."""
    if not values:
        raise ValueError("no samples")
    if len(values) == 1:
        return float(values[0])
    return float(statistics.quantiles(values, n=100,
                                      method="inclusive")[int(q) - 1])


def job_ms(rec) -> List[float]:
    """Milliseconds of every job of the window that completed."""
    return [(j["end"] - j["start"]) * 1e3 for j in rec["jobs"] if j["ok"]]


def rate(rec) -> Optional[float]:
    """Jobs completed per second: every job started in the window, over
    the time from the window's start to the last result, so the jobs in
    flight at the window's end count with the time they took."""
    done = [j for j in rec["jobs"] if j["ok"]]
    if not done:
        return None
    return len(done) / (max(j["end"] for j in done) - rec["t0"])


def mean_ms(rec, field: str) -> Optional[float]:
    """Mean over the window's jobs of a ``StitchMetrics`` field, in ms."""
    vals = [j["m"][field] for j in rec["jobs"] if j["ok"] and j.get("m")]
    return sum(vals) / len(vals) * 1e3 if vals else None


# ----------------------------------------------------------------- spans

class Spans:
    """Host spans from the benchmark's own calls: (name, start, end) in
    ``perf_counter_ns``, kept in memory."""

    def __init__(self):
        self.items: List[tuple] = []

    def span(self, name: str):
        return _Span(self, name)


class _Span:
    __slots__ = ("spans", "name", "t0")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        self.spans.items.append((self.name, self.t0, time.perf_counter_ns()))


# ----------------------------------------------------------------- trace

class Trace:
    """``torch.profiler`` over the measured window, CPU and CUDA, with an
    anchor that maps ``perf_counter_ns`` onto the trace's clock."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self._torch = torch

    def __enter__(self):
        self.prof.__enter__()
        from torch.profiler import record_function
        self.anchor_ns = time.perf_counter_ns()
        with record_function("stitchbench.anchor"):
            pass
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self._torch.cuda.synchronize()
        self.prof.__exit__(*exc)

    def reduce(self, spans: Spans, t0: float, t_end: float) -> dict:
        """Busy seconds (union of kernels, copies and sets on the device)
        inside [t0, t_end] (``perf_counter`` seconds), the summed seconds
        of the work on the device, the device operations by name, and the
        idle gaps named by the host span open across them."""
        from torch.autograd import DeviceType

        offset = None
        dev = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                dev.append((e.name(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
            elif offset is None and e.name() == "stitchbench.anchor":
                offset = e.start_ns() - self.anchor_ns
        if offset is None:
            raise BenchError("the trace lost its anchor event")
        lo = int(t0 * 1e9) + offset
        hi = int(t_end * 1e9) + offset
        return reduce_device(dev, lo, hi,
                             [(n, a + offset, b + offset)
                              for n, a, b in spans.items])


def is_transfer(name: str) -> bool:
    """A copy between host and device; every other device operation
    (kernels, sets, device-to-device copies) is work on the device."""
    return name.startswith("Memcpy") and ("HtoD" in name or "DtoH" in name)


def reduce_device(events, lo: int, hi: int, spans) -> dict:
    """Reduce device events ``(name, start_ns, end_ns)`` clipped to
    [lo, hi] ns: busy (their union), the summed seconds of the work on the
    device (every operation but host transfers), seconds by name, and the
    ten longest idle gaps, each named by the host span (``(name, start_ns,
    end_ns)``) that covers most of it ("none" where none)."""
    clipped = sorted((max(a, lo), min(b, hi), n) for n, a, b in events
                     if b > lo and a < hi)
    by_name: Dict[str, float] = {}
    work_s = 0.0
    for a, b, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        if not is_transfer(n):
            work_s += (b - a) / 1e9
    busy, gaps, cur = 0, [], lo
    for a, b, _ in clipped:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if hi > cur:
        gaps.append((cur, hi))

    def label(g0, g1):
        best, name = 0, "none"
        for n, a, b in spans:
            cover = min(b, g1) - max(a, g0)
            if cover > best:
                best, name = cover, n
        return name

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy / 1e9, "window_s": (hi - lo) / 1e9,
        "work_s": work_s,
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: -x[1])[:10],
        "idle_gaps": [[label(a, b), (b - a) / 1e9] for a, b in gaps[:10]],
    }


# --------------------------------------------------------------- results

def loaded_forbidden() -> List[str]:
    """Modules loaded in this process whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def device_block(device, chips: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


class Reservoir:
    """A sample of finished jobs drawn from the seed: up to ``k`` in each
    stratum by reservoir sampling under a lock, so every finished job of a
    stratum is equally likely.  ``keep`` makes what is held of an accepted
    value; it runs outside the lock."""

    def __init__(self, k: int, seed: int, keep=None):
        import random

        self.k, self.keep = k, keep
        self.rng = random.Random(seed)
        self.strata: Dict[object, list] = {}     # stratum -> [seen, items]
        self.lock = threading.Lock()

    def offer(self, key, value, stratum=None) -> None:
        with self.lock:
            st = self.strata.setdefault(stratum, [0, []])
            seen, held = st
            if len(held) < self.k:
                slot = len(held)
                held.append(None)
            else:
                j = self.rng.randrange(seen + 1)
                slot = j if j < self.k else None
            st[0] = seen + 1
        if slot is None:
            return
        if self.keep is not None:
            value = self.keep(value)
        with self.lock:
            held[slot] = (key, value)

    @property
    def items(self) -> List[tuple]:
        return [item for _, (_, held) in sorted(self.strata.items(),
                                                key=lambda kv: repr(kv[0]))
                for item in held if item is not None]


def batch_position(out) -> Optional[int]:
    """The index of a job's canvas within the batch array that it is a
    view of (a server's flush), or None where it is no such view."""
    import numpy as np

    base = getattr(out, "base", None)
    if (not isinstance(out, np.ndarray) or not isinstance(base, np.ndarray)
            or base.ndim != out.ndim + 1 or base.shape[1:] != out.shape):
        return None
    offset = (out.__array_interface__["data"][0]
              - base.__array_interface__["data"][0])
    if offset % base.strides[0]:
        return None
    return offset // base.strides[0]


def check(traffic) -> Dict[str, float]:
    """The compared numbers, worst over the finished jobs that the traffic
    sampled: each canvas against the reference of its own job's sources
    (``traffic.sources(idx)``, which the reference reads itself)."""
    import numpy as np

    from . import deploy
    from .reference.stitch import compare

    worst: Dict[str, float] = {}
    if not traffic.sample.items:
        return {"resampled_max_diff": 255.0, "mismatch_ppm": 1e6,
                "exact_max_diff": 255.0}
    for idx, out in traffic.sample.items:
        raws, shapes = traffic.sources(idx)
        got = compare(deploy.layout(traffic.cell.config, shapes), raws,
                      np.asarray(out), traffic.device)
        worst = {k: max(v, worst.get(k, v)) for k, v in got.items()}
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each compared number beside its limit; a number is within when it
    is at most its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def emit(result: dict, checks: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, with the checks as its last key."""
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps({**result, "checks": checks}), flush=True)
