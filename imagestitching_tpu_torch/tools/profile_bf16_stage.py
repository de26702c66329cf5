"""Config 5's slot 0 on kernel #4: source bands staged as uint8 against bf16.

The port's twin of ``benchmarks/profile_bf16_stage.py``.  Run on a CUDA
host, from the root of a checkout:

    python -m imagestitching_tpu_torch.tools.profile_bf16_stage

It solves BASELINE config 5's nine shapes (mode "min", gap 4), prints slot
0's geometry (a 1920x1080 source into a 1024x576 slot: the tile, the band
and, per band dtype, kernel #4's grid, TMA boxes and shared memory), makes
a seeded uint8 source and stages it as uint8 and as bf16
(:func:`..ops.staged_resize.stage_source`, outside any timed window), and
prepares one :class:`..ops.staged_resize.StagedLaunch` per band dtype.
Parity comes first: the two variants, the plain version and kernel #1 on
the same slot must agree bit for bit, or it exits 1.  Then it times each
variant's prepared call in ms per slot and MP/s, by CUDA events (the median
of ``--rounds`` rounds of ``--reps`` launches) and by the profiler's device
busy time, each launch reading the next of enough distinct source copies to
exceed the card's L2 cache, so that the bound is device memory's, and the
host microseconds a launch takes; and prints the speedup (uint8 time over
bf16 time) and the bound.  The last line is a JSON record of the run.
Without CUDA it raises: there is no CPU mode.
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import StitchOptions
from ..core.layout import ImageSpec, solve
from ..ops import cuda_resize, staged_resize, torch_compose
from ..runtime.pipeline import resolve_device

#: BASELINE config 5's nine images (raw width, raw height), as in the JAX
#: script (benchmarks/profile_bf16_stage.py:18).
CONFIG5 = [(1920, 1080)] * 5 + [(1280, 720), (1600, 900), (1920, 1200),
                                (1024, 768)]
#: H100 SXM, HBM3 peak
HBM_BYTES_PER_S = 3.35e12
_NAMES = {torch.uint8: "uint8 bands", torch.bfloat16: "bf16 bands"}


def slot0():
    """Config 5's plan and its slot 0."""
    plan = solve([ImageSpec(w, h) for w, h in CONFIG5],
                 StitchOptions(mode="min", gap=4, supersample=False,
                               max_images=None))
    return plan, plan.placements[0]


def events_ms(fn, reps: int, rounds: int) -> float:
    """Per call of ``fn`` by CUDA events: the median over ``rounds`` runs of
    ``reps`` calls, after ``reps`` warm-up calls."""
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    return statistics.median(samples)


def host_us(fn, reps: int) -> float:
    """Host microseconds per call of ``fn``: the wall clock of ``reps``
    calls with no synchronise among them, over ``reps``, after a warm-up
    call and a synchronise (the device may still run when it stops)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def busy_ms(fn, bound: float, reps: int = 20,
            tries: int = 2) -> Optional[float]:
    """Per call of ``fn``: the device time torch.profiler records (the union
    of its GPU activity) over ``reps`` calls, from the first of up to
    ``tries`` profiles that recorded at least one device activity per call
    and no less than ``bound`` ms a call (the least time the card could
    take).  Late in a process that has taken many profiles, the profiler
    drops GPU records (a trace may hold only some of the launches, or
    none); a trace that falls short is not used.  None (not measured) when
    every try fell short."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, float("-inf")
        for start, stop in spans:
            busy += max(0.0, stop - max(start, end))
            end = max(end, stop)
        ms = busy / 1e3 / reps
        if len(spans) >= reps and ms >= bound:
            return ms
    return None


def run(reps: int = 200, rounds: int = 5, seed: int = 0,
        out=print) -> dict:
    """Parity, then the times of both band dtypes on slot 0 on the current
    card; the record (``ok`` false when parity failed, and then no
    times)."""
    dev = resolve_device("cuda")     # no card: raises, never the CPU
    plan, p = slot0()
    t = torch_compose.placement_taps(p, plan.filter)
    taps = tuple(torch.from_numpy(a).to(dev) for a in (
        t["rows"]["i0"], t["rows"]["w"], t["cols"]["i0"], t["cols"]["w"]))
    ri0, rw, ci0, cw = taps
    n_rows, n_cols = len(ri0), len(ci0)
    m_h, m_w = p.raw_h, p.raw_w          # orientation 1
    sched = staged_resize.staged_schedule(ri0, ci0, rw.shape[1],
                                          cw.shape[1], m_h, m_w, 3)
    tiles = sched.grid[0] * sched.grid[1]
    rng = np.random.default_rng(seed)
    src = torch.from_numpy(rng.integers(0, 256, (m_h, m_w, 3),
                                        np.uint8)).to(dev)
    launches0 = staged_resize.staged_launches
    canvas = torch.empty((n_rows, n_cols, 3), dtype=torch.uint8, device=dev)
    # prepared once per band dtype, the twin of the JAX script's build
    bands = {dt: staged_resize.stage_source(src, dt) for dt in _NAMES}
    launch = {dt: staged_resize.StagedLaunch(b, *taps, canvas, 0, 0,
                                             schedule=sched)
              for dt, b in bands.items()}
    args = {dt: launch[dt].args for dt in _NAMES}
    out(f"device: {torch.cuda.get_device_name(dev)}")
    out(f"slot0: {p.raw_w}x{p.raw_h} -> {n_cols}x{n_rows}, K=({rw.shape[1]},"
        f"{cw.shape[1]}), tile {sched.tile_r}x{sched.tile_c}, band "
        f"{sched.band_h}x{sched.band_w}, grid {sched.grid} = {tiles} tiles, "
        f"ring of {staged_resize.SLOTS} bands; " + "; ".join(
            f"{_NAMES[dt]}: {a.grid} CTAs ({a.per_sm} fit an SM), a band "
            f"row in {a.boxes} TMA boxes of {a.box_bytes} bytes x "
            f"{a.box_rows} rows, shared memory {a.smem_bytes} bytes a CTA"
            for dt, a in args.items()))

    # parity first: both variants, the plain version and kernel #1
    got = {}
    for dt in _NAMES:
        canvas.fill_(0)
        launch[dt](bands[dt])
        got[dt] = canvas.clone()
    plain = staged_resize.resize_place_staged_ref(src, *taps)
    one = torch.zeros_like(canvas)
    cuda_resize.resize_place(src, 1, *taps, one, 0, 0)

    def diff(a, b):
        d = (a.int() - b.int()).abs()
        return int(d.max()), int((d > 0).any(dim=2).sum())

    parity = {"variants": diff(got[torch.uint8], got[torch.bfloat16]),
              "plain": max(diff(g, plain) for g in got.values()),
              "kernel1": diff(got[torch.uint8], one)}
    out(f"variant parity max|diff|: {parity['variants'][0]} (uint8 vs bf16, "
        f"{parity['variants'][1]} differing px) | vs the plain version "
        f"{parity['plain'][0]} ({parity['plain'][1]} px) | vs kernel #1 "
        f"{parity['kernel1'][0]} ({parity['kernel1'][1]} px)")
    record = {"device": torch.cuda.get_device_name(dev),
              "slot": [n_rows, n_cols], "tile": [sched.tile_r, sched.tile_c],
              "band": [sched.band_h, sched.band_w], "grid": list(sched.grid),
              "ctas": args[torch.uint8].grid, "parity": parity,
              "ok": all(v == (0, 0) for v in parity.values())}
    if not record["ok"]:
        return record

    mp = n_rows * n_cols / 1e6
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 * 2 ** 20)
    times = {}
    for dt, name in _NAMES.items():
        nbytes = staged_resize.moved_bytes(src.shape, n_rows, n_cols, dt)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # distinct copies: more source bytes than the L2 holds
        n = l2 // (src.numel() * (1 if dt == torch.uint8 else 2)) + 1
        copies = itertools.cycle([staged_resize.stage_source(src, dt)
                                  for _ in range(n)])
        step = (lambda f=launch[dt]: f(next(copies)))
        ms = events_ms(step, reps, rounds)
        busy = busy_ms(step, bound, reps)
        host = host_us(step, reps)
        times[name] = {"ms": ms, "busy_ms": busy, "bound_ms": bound,
                       "host_us": host, "bytes": nbytes, "copies": n,
                       "ctas": args[dt].grid,
                       "smem_bytes": args[dt].smem_bytes}
        busy_txt = "not measured" if busy is None else (
            f"{busy:.4f} ms ({mp / busy * 1e3:.0f} MP/s)")
        out(f"{name}: {ms:.4f} ms/slot ({mp / ms * 1e3:.0f} MP/s) by CUDA "
            f"events, busy {busy_txt}, bound {bound:.4f} ms ({nbytes} bytes "
            f"at 3.35 TB/s), host {host:.2f} us a launch, {n} source copies")
        del copies
    u8, bf = times[_NAMES[torch.uint8]], times[_NAMES[torch.bfloat16]]
    speedup = u8["ms"] / bf["ms"]
    busy_up = (None if u8["busy_ms"] is None or bf["busy_ms"] is None
               else u8["busy_ms"] / bf["busy_ms"])
    out(f"speedup: {speedup:.2f}x by events, "
        + ("busy not measured" if busy_up is None
           else f"{busy_up:.2f}x by busy time")
        + " (uint8 time over bf16 time; above 1: bf16 staging is faster)")
    record.update(times=times, speedup=speedup, speedup_busy=busy_up,
                  launches=staged_resize.staged_launches - launches0)
    return record


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Kernel #4 on config 5's slot 0: uint8 bands against "
                    "bf16 bands (parity, then times)")
    ap.add_argument("--reps", type=int, default=200,
                    help="launches per timed round (default 200)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds, of which the median (default 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="of the random source (default 0)")
    args = ap.parse_args(argv)
    record = run(args.reps, args.rounds, args.seed)
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
