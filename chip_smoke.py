#!/usr/bin/env python3
"""Drive the PyTorch port (imagestitching_tpu_torch) once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero and prints no result:

1. environment: torch, CUDA, the card's name and power limit (nvidia-smi);
2. build: the resize-and-place kernel from ``imagestitching_tpu_torch/csrc``
   with nvcc for sm_90a;
3. the kernel against its plain PyTorch version on the card, bit for bit
   (bilinear up and down with fractional offsets, all 8 EXIF orientations,
   the triangle/box/lanczos3 filters, 1 and 3 channels), each job also
   against the float64 oracle within 1 step;
4. the slice at real size: BASELINE config 3 (9 photos of 1-3 MP with EXIF
   orientations, horizontal, mode "min", gap 4) through
   ``imagestitching_tpu_torch.stitch`` on ``cuda``, three times, counting
   kernel launches, checked against the oracle;
5. export: ``stitch_to_file(stream=False)`` to PNG, decoded back;
6. kernel and plain-version times (CUDA events, and the profiler's device
   time) at config 3's shapes, and the kernel's store checked bit for bit
   against the plain version's;
7. where a warm config-3 job's time goes on the device (torch.profiler);
8. the batched kernel against its plain version on the card, bit for bit,
   over phase 3's cases at B = 3 with other data per job, and against B
   single launches of the single-job kernel;
9. the batched path at real size: BASELINE config 5 (64 jobs of 9 images,
   vertical, mode "min", gap 4) submitted from threads to
   ``StitchServer`` on ``cuda``: one flush, one batched launch per
   resampled placement (counted), every job equal to the single-job path
   bit for bit, three jobs within 1 step of the oracle with the copy span
   exact; flush wall, jobs/s and MP/s, and a profiled warm flush;
10. batched kernel and plain-version times at config 5's shapes (B = 64);
11. HTTP: ``StitchHTTPServer`` on localhost answers 4 concurrent
    ``POST /stitch`` with what ``imagestitching_tpu_torch.stitch`` gives;
12. the windowed kernel (#3) against its plain version on the card, bit for
    bit, over phase 3's cases in 16-row chunks, and each case's banded
    canvas against the resident one;
13. BASELINE config 4 at real size with EXIF orientations (9 x 4000x3000,
    orientations 1,6,3,8,1,5,2,7,4, vertical, mode "min", gap 4) through
    ``imagestitching_tpu_torch.stitch`` on ``cuda`` under three budgets, one
    per strategy (resident, streamed, banded): launches counted, every
    canvas equal to the resident one, the oracle within 1 around every
    chunk boundary and exact on copy spans, peak device memory under the
    budget; then 9 x 6000x4000 at the default budget, which must run
    streamed and equal a resident run;
14. the OOM ladder on a real ``torch.cuda.OutOfMemoryError``: the config-4
    job under a per-process memory cap that the resident rung cannot meet
    demotes to streamed, and under one below the canvas to banded, both
    equal to the resident canvas;
15. windowed kernel and plain-version times at config 4's chunk shapes, and
    where a streamed and a banded job's time goes (torch.profiler).

Each kernel's launch count is read from its own path: phase 4 for the
single-job kernel, phase 9 for the batched one, phase 13's banded run for
the windowed one, each with the counts set to 0 just before.  The last two
lines are a JSON record of the kernels and the device line ``{"ok": true,
"device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "imagestitching_tpu_torch/csrc/resize_place.cu"
REPLACES = "imagestitching_tpu/ops/pallas_resize.py:410"

# BASELINE config 3 (BASELINE.md:35, benchmarks/run_all.py:97-103):
# (raw width, raw height, EXIF orientation)
CONFIG3 = [(1920, 1080, 1), (1080, 1920, 6), (1440, 1080, 3),
           (1280, 960, 8), (2000, 1500, 1), (1080, 1080, 5),
           (1600, 1200, 2), (1200, 1600, 7), (1920, 1440, 4)]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(line: str) -> None:
    print(line, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        fail(f"nvidia-smi: {e!r}")
    return out.strip().splitlines()[0]


def median_ms(fn, reps=20, inner=10):
    """Per call of ``fn``, by CUDA events: the median over ``reps`` runs of
    ``inner`` calls each, after 3 warm-up calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def device_ms(fn, reps=20):
    """Per call of ``fn``: the device time torch.profiler records (the
    union of its GPU activity), the host wall, and device time by
    activity name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    by_name, busy, end = {}, 0.0, float("-inf")
    for start, stop, name in spans:
        ms = (stop - start) / 1e3 / reps
        by_name[name] = by_name.get(name, 0.0) + ms
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / 1e3 / reps, wall * 1e3 / reps, by_name


def taps_on(p, kind, dev):
    """A placement's taps (ri0, rw, ci0, cw) on ``dev``."""
    import torch
    from imagestitching_tpu_torch.ops import torch_compose

    t = torch_compose.placement_taps(p, kind)
    return tuple(torch.from_numpy(a).to(dev) for a in
                 (t["rows"]["i0"], t["rows"]["w"],
                  t["cols"]["i0"], t["cols"]["w"]))


def src_on(raw, dev):
    import torch

    a = raw if raw.ndim == 3 else raw[..., None]
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def resampled(plan):
    """The placements of ``plan`` that go through a kernel."""
    from imagestitching_tpu.core import geometry

    return [p for p in plan.placements
            if p.row_span[1] > p.row_span[0]
            and p.col_span[1] > p.col_span[0]
            and geometry.placement_copy_offsets(p, plan.filter) is None]


# BASELINE config 5 (BASELINE.md:37, benchmarks/run_all.py:111-121): 64
# concurrent jobs of these 9 images (raw width, raw height), vertical, mode
# "min", gap 4
CONFIG5 = [(1920, 1080)] * 5 + [(1280, 720), (1600, 900), (1920, 1200),
                                (1024, 768)]
BATCH5 = 64
REPLACES_BATCH = "imagestitching_tpu/ops/pallas_resize.py:629"


def phase8_batch_vs_plain(cases, dev, batch=3) -> int:
    """Kernel #2 against its plain version, bit for bit, over the phase-3
    cases at B = ``batch`` with other data per job, and against ``batch``
    single launches of kernel #1.  Returns the worst max |diff|."""
    import torch
    from imagestitching_tpu.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.ops import cuda_resize

    rng = np.random.default_rng(8)
    worst_all, notes = 0, []
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        worst = ndiff = nsingle = 0
        for p in resampled(plan):
            src = torch.from_numpy(rng.integers(
                0, 256, (batch, p.raw_h, p.raw_w, c), np.uint8)).to(dev)
            taps = taps_on(p, plan.filter, dev)
            canvas = torch.zeros((batch, plan.canvas_h, plan.canvas_w, c),
                                 dtype=torch.uint8, device=dev)
            r0, r1 = p.row_span
            c0, c1 = p.col_span
            cuda_resize.resize_place_batch(src, p.orientation, *taps, canvas,
                                           r0, c0)
            ref = cuda_resize.resize_place_batch_ref(src, p.orientation,
                                                     *taps)
            d = (canvas[:, r0:r1, c0:c1].int() - ref.int()).abs()
            worst = max(worst, int(d.max()))
            ndiff += int((d > 0).any(dim=3).sum())
            for b in range(batch):
                one = torch.zeros_like(canvas[b])
                cuda_resize.resize_place(src[b], p.orientation, *taps, one,
                                         r0, c0)
                nsingle += int((one != canvas[b]).any(dim=2).sum())
        check(worst == 0 and ndiff == 0 and nsingle == 0,
              f"{name}: batched kernel vs plain max |diff| {worst}, {ndiff} "
              f"differing pixels, {nsingle} pixels unlike {batch} single "
              "launches (must be exact)")
        worst_all = max(worst_all, worst)
        notes.append(f"{name}:{worst}/{ndiff}/{nsingle}")
    say(f"phase8 batched kernel (B={batch}, other data per job) vs plain and "
        f"vs {batch} single launches (exact): {len(cases)} cases max |diff| "
        f"{worst_all} | case:max_diff/differing_px/unlike_single "
        + " ".join(notes))
    return worst_all


def phase9_config5(dev, smi, budget, shapes=CONFIG5, batch=BATCH5):
    """BASELINE config 5 through ``StitchServer``: ``batch`` jobs submitted
    from threads, one flush, one batched launch per resampled placement,
    every job bit-equal to the single-job path and three within 1 step of
    the oracle.  Returns (plan, host stacks, batched launches)."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    from imagestitching_tpu.core import geometry, oracle
    from imagestitching_tpu.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch import (RuntimeConfig, StitchOptions,
                                          StitchServer)
    from imagestitching_tpu_torch.ops import cuda_resize

    opts = StitchOptions(mode="min", gap=4, max_images=None)
    plan = solve([ImageSpec(w, h) for w, h in shapes], opts)
    n_res = len(resampled(plan))
    copies = [p for p in plan.placements
              if geometry.placement_copy_offsets(p, plan.filter) is not None]
    # other data in every job, made on the card from a seed
    g = torch.Generator(device=dev).manual_seed(5)
    stacks = [torch.randint(0, 256, (batch, h, w, 3), generator=g,
                            dtype=torch.uint8, device=dev).cpu().numpy()
              for w, h in shapes]
    jobs = [[s[j] for s in stacks] for j in range(batch)]
    src_mb = sum(s.nbytes for s in stacks) / 1e6
    canvas_mp = plan.canvas_w * plan.canvas_h / 1e6

    def flush_round():
        with ThreadPoolExecutor(16) as pool:
            futs = list(pool.map(lambda job: server.submit(job, opts), jobs))
        return [f.result(timeout=600) for f in futs]

    server = StitchServer(max_batch=batch, max_wait_s=60.0,
                          config=RuntimeConfig(device=str(dev),
                                               budget=budget))
    try:
        cap = server._batch_cap(plan, 3)
        t0 = time.perf_counter()
        warm = server.warmup([(h, w) for w, h in shapes], opts,
                             batch_sizes=(batch,))
        warm_s = time.perf_counter() - t0
        check(warm["batches"] == [batch], f"warmup ran {warm['batches']}, "
              f"cap {cap}")
        torch.cuda.reset_peak_memory_stats(dev)
        before = server.stats()
        cuda_resize.launches = cuda_resize.batch_launches = 0
        t0 = time.perf_counter()
        outs = flush_round()
        wall = time.perf_counter() - t0
        launches_main = cuda_resize.batch_launches
        single = cuda_resize.launches
        after = server.stats()
        peak_mb = torch.cuda.max_memory_allocated(dev) / 1e6
        flushes = after["batches"] - before["batches"]
        check(flushes == 1 and after["jobs"] - before["jobs"] == batch,
              f"{batch} jobs in {flushes} flushes (cap {cap}), expected 1")
        check(launches_main == n_res and single == 0,
              f"batched launches {launches_main}, single {single}; "
              f"expected {n_res} and 0")
        check(all(o.shape == (plan.canvas_h, plan.canvas_w, 3)
                  for o in outs), f"canvas {outs[0].shape}")
        n_unequal = sum(
            not np.array_equal(o, cuda_resize.stitch(plan, job,
                                                     dev).cpu().numpy())
            for o, job in zip(outs, jobs))
        check(n_unequal == 0, f"{n_unequal} of {batch} served jobs differ "
              "from the single-job path")
        onotes = []
        for j in (0, batch // 2, batch - 1):
            diff = np.abs(outs[j].astype(np.int16)
                          - oracle.stitch(plan, jobs[j]).astype(np.int16))
            copy_max = max((int(diff[p.row_span[0]:p.row_span[1],
                                     p.col_span[0]:p.col_span[1]].max())
                            for p in copies), default=0)
            check(int(diff.max()) <= 1 and copy_max == 0,
                  f"config 5 job {j} vs oracle {int(diff.max())}, copy "
                  f"spans {copy_max}")
            onotes.append(f"job{j}:{int(diff.max())}/{copy_max}")
        del outs
        busy, pwall, by_name = device_ms(flush_round, reps=1)
    finally:
        server.close()
    groups = {"Memcpy HtoD": 0.0, "resize_place": 0.0, "Memcpy DtoH": 0.0}
    for name, ms in by_name.items():
        key = next((k for k in groups if k in name), "other")
        groups[key] = groups.get(key, 0.0) + ms
    say(f"phase9 config5 via StitchServer on cuda ({batch} jobs x "
        f"{len(shapes)} images, canvas {plan.canvas_w}x{plan.canvas_h}x3, "
        f"{n_res} resampled + {len(copies)} copy, sources {src_mb:.1f} MB, "
        f"batch cap {cap}): 1 flush, batched launches {launches_main}, "
        f"single launches {single} | every job equal to cuda_resize.stitch "
        f"| oracle max |diff|/copy spans {' '.join(onotes)} | host wall "
        f"{wall:.4f} s submit to last result, flush "
        f"{after['flush_s'] - before['flush_s']:.4f} s (np.stack "
        f"{after['stack_s'] - before['stack_s']:.4f} s), "
        f"{batch / wall:.4f} jobs/s, {batch * canvas_mp / wall:.4f} output "
        f"MP/s | warmup {warm_s:.4f} s | peak device memory {peak_mb:.1f} "
        f"MB | {smi}")
    say(f"phase9 warm flush under torch.profiler ({batch} jobs): host wall "
        f"{pwall:.4f} ms, device busy {busy:.4f} ms, idle share "
        f"{1 - busy / pwall if pwall else float('nan'):.4f} | device ms "
        + " ".join(f"{k}={v:.4f}" for k, v in groups.items()) + f" | {smi}")
    return plan, stacks, launches_main


def phase10_batch_times(dev, smi, plan, stacks):
    """Kernel #2 and its plain version timed at config 5's placements and
    batch size, its store checked bit for bit.  Returns (max |diff|,
    kernel ms, plain ms) summed over the placements."""
    import torch
    from imagestitching_tpu_torch.ops import cuda_resize

    batch = stacks[0].shape[0]
    canvas = torch.zeros((batch, plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    k_total = p_total = kd_total = pd_total = 0.0
    worst = ndiff = 0
    rows = []
    for p in resampled(plan):
        src = torch.from_numpy(stacks[p.index]).to(dev)
        taps = taps_on(p, plan.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span

        def kernel(src=src, taps=taps, p=p, r0=r0, c0=c0):
            cuda_resize.resize_place_batch(src, p.orientation, *taps, canvas,
                                           r0, c0)

        def plain(src=src, taps=taps, p=p, r0=r0, r1=r1, c0=c0, c1=c1):
            canvas[:, r0:r1, c0:c1] = cuda_resize.resize_place_batch_ref(
                src, p.orientation, *taps)

        plain_a = median_ms(plain, reps=5, inner=2)
        kern_a = median_ms(kernel, reps=5, inner=2)
        got = canvas[:, r0:r1, c0:c1].clone()
        plain()
        d = (got.int() - canvas[:, r0:r1, c0:c1].int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).any(dim=3).sum())
        del got, d
        kern_b = median_ms(kernel, reps=5, inner=2)
        plain_b = median_ms(plain, reps=5, inner=2)
        k_ms = statistics.median([kern_a, kern_b])
        p_ms = statistics.median([plain_a, plain_b])
        k_dev = device_ms(kernel, reps=3)[0]
        p_dev = device_ms(plain, reps=3)[0]
        k_total += k_ms
        p_total += p_ms
        kd_total += k_dev
        pd_total += p_dev
        rows.append(f"#{p.index} {p.raw_w}x{p.raw_h}->{c1 - c0}x{r1 - r0} "
                    f"kernel {k_ms:.4f} ({k_dev:.4f}) plain {p_ms:.4f} "
                    f"({p_dev:.4f})")
    check(worst == 0 and ndiff == 0, f"config 5 batched kernel vs plain max "
          f"|diff| {worst}, {ndiff} differing pixels (must be exact)")
    say(f"phase10 batched times at B={batch} (ms per launch; CUDA events, "
        f"median of 5x2, order plain kernel kernel plain; in brackets the "
        f"profiler's device busy time) on {smi}: " + " | ".join(rows)
        + f" | total kernel {k_total:.4f} ({kd_total:.4f}) plain "
        f"{p_total:.4f} ({pd_total:.4f}) | kernel vs plain max |diff| "
        f"{worst}, differing px {ndiff}")
    return worst, k_total, p_total


REPLACES_WINDOW = "imagestitching_tpu/ops/pallas_resize.py:721"
# BASELINE config 4 (BASELINE.md:36: 9 x 12 MP under a 2 GB budget), with
# the EXIF orientations of config 3 so that five placements resample
ORIENT4 = (1, 6, 3, 8, 1, 5, 2, 7, 4)
CONFIG4 = [(4000, 3000, o) for o in ORIENT4]
CONFIG4_24MP = [(6000, 4000, o) for o in ORIENT4]


def _noop(*_):
    pass


def phase12_window_vs_plain(cases, dev, chunk_rows=16) -> int:
    """Kernel #3 against its plain version, bit for bit, over the phase-3
    cases in ``chunk_rows`` chunks, and each case's banded canvas at that
    chunk height against ``cuda_resize.stitch``.  Returns the worst max
    |diff|."""
    import torch
    from imagestitching_tpu.core import geometry
    from imagestitching_tpu.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan
    from imagestitching_tpu_torch.runtime import pipeline

    rng = np.random.default_rng(12)
    worst_all, notes = 0, []
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        imgs = [rng.integers(0, 256, (h, w, c), np.uint8)
                for w, h, _ in shapes]
        worst = ndiff = chunks = 0
        for p in resampled(plan):
            oriented = geometry.orient_array(imgs[p.index], p.orientation)
            wp = WindowPlan(p, plan.filter, chunk_rows)
            ci0, cw = (torch.from_numpy(a).to(dev) for a in (wp.ci0, wp.cw))
            region = torch.zeros((wp.chunk, wp.n_cols, c), dtype=torch.uint8,
                                 device=dev)
            for g in range(wp.n_chunks):
                _, valid, _ = wp.chunk_window(g)
                crop = torch.from_numpy(wp.stage_crop(oriented, g)).to(dev)
                ri0, rw = (torch.from_numpy(t).to(dev)
                           for t in wp.chunk_taps(g))
                cuda_resize.resize_place_window(crop, ri0, rw, ci0, cw,
                                                region)
                ref = cuda_resize.resize_place_window_ref(crop, ri0, rw, ci0,
                                                          cw)
                d = (region[:valid].int() - ref.int()).abs()
                worst = max(worst, int(d.max()))
                ndiff += int((d > 0).any(dim=2).sum())
                chunks += 1
        banded, _ = pipeline._run_banded(plan, imgs, c, chunk_rows, "auto",
                                         dev, _noop)
        resident = cuda_resize.stitch(plan, imgs, dev).cpu().numpy()
        check(worst == 0 and ndiff == 0, f"{name}: windowed kernel vs plain "
              f"max |diff| {worst}, {ndiff} differing pixels (must be exact)")
        check(np.array_equal(banded, resident), f"{name}: banded canvas "
              "differs from the resident one")
        worst_all = max(worst_all, worst)
        notes.append(f"{name}:{worst}/{ndiff}/{chunks}")
    say(f"phase12 windowed kernel vs plain in {chunk_rows}-row chunks "
        f"(exact), banded canvas equal to resident: {len(cases)} cases max "
        f"|diff| {worst_all} | case:max_diff/differing_px/chunks "
        + " ".join(notes))
    return worst_all


def _config4_job(dev, shapes, seed):
    """(plan, options, raw images, (array, orientation) items) of a
    config-4 job, the pixels made on the card from a seed."""
    import torch
    from imagestitching_tpu.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch import StitchOptions

    opts = StitchOptions(direction="vertical", mode="min", gap=4,
                         max_images=None)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    g = torch.Generator(device=dev).manual_seed(seed)
    imgs = [torch.randint(0, 256, (h, w, 3), generator=g, dtype=torch.uint8,
                          device=dev).cpu().numpy() for w, h, _ in shapes]
    return plan, opts, imgs, [(a, o) for a, (_, _, o) in zip(imgs, shapes)]


def _oracle_spots(plan, imgs, out, band_rows):
    """Max |diff| against ``oracle.stitch_rows`` over 4 rows around every
    chunk boundary and edge of each resampled placement, and over rows at
    both ends and the middle of each copy span (which must be 0)."""
    from imagestitching_tpu.core import geometry, oracle
    from imagestitching_tpu_torch.ops.window import WindowPlan

    def diff(lo, hi):
        want = oracle.stitch_rows(plan, imgs, lo, hi)
        lo = max(0, lo)
        return int(np.abs(out[lo:lo + want.shape[0]].astype(np.int16)
                          - want.astype(np.int16)).max())

    worst = copy_max = 0
    for p in plan.placements:
        r0, r1 = p.row_span
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            mid = (r0 + r1) // 2
            for lo in (r0, mid, r1 - 2):
                copy_max = max(copy_max, diff(lo, lo + 2))
            continue
        wp = WindowPlan(p, plan.filter, band_rows)
        for b in [r0 + a for a, _ in wp.windows] + [r1]:
            worst = max(worst, diff(b - 2, b + 2))
    return worst, copy_max


def phase13_config4(dev, smi, shapes=CONFIG4, big=CONFIG4_24MP):
    """BASELINE config 4 with EXIF orientations through
    ``imagestitching_tpu_torch.stitch`` under three budgets, one per
    strategy; then the 24 MP job at the default budget.  Returns (plan,
    options, images, items, resident canvas, windowed launches of the
    banded run)."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu.runtime import tiler
    from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig
    from imagestitching_tpu_torch.config import budget_from_device
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan

    plan, opts, imgs, items = _config4_job(dev, shapes, 4)
    res = resampled(plan)
    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    src_mb = sum(a.nbytes for a in imgs) / 1e6
    ref, window_main, rows = None, 0, []
    for strategy, budget in (
            ("resident", MemoryBudget()),
            ("streamed", MemoryBudget(
                hbm_bytes=tiler.resident_peak_bytes(plan) - 1)),
            ("banded", MemoryBudget(hbm_bytes=canvas_bytes // 2))):
        ex = tiler.plan_execution(plan, budget)
        check(ex.strategy == strategy, f"budget {budget.hbm_bytes}: the "
              f"tiler picks {ex.strategy}, expected {strategy}")
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_resize.launches = cuda_resize.batch_launches = 0
        cuda_resize.window_launches = 0
        t0 = time.perf_counter()
        out, m = itt.stitch(items, options=opts, config=RuntimeConfig(
            device=str(dev), budget=budget), return_metrics=True)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        launched = (cuda_resize.launches, cuda_resize.batch_launches,
                    cuda_resize.window_launches)
        check(m.strategy == strategy, f"ran {m.strategy}, expected "
              f"{strategy}")
        if strategy == "banded":
            chunks = sum(WindowPlan(p, plan.filter, ex.band_rows).n_chunks
                         for p in res)
            check(launched == (0, 0, chunks), f"banded launches {launched}, "
                  f"expected (0, 0, {chunks})")
            window_main = launched[2]
        else:
            check(launched == (len(res), 0, 0), f"{strategy} launches "
                  f"{launched}, expected ({len(res)}, 0, 0)")
        check(out.shape == (plan.canvas_h, plan.canvas_w, 3),
              f"canvas {out.shape}")
        if ref is None:
            ref = out
        check(np.array_equal(out, ref), f"{strategy} canvas differs from "
              "the resident one")
        check(peak < budget.hbm_bytes, f"{strategy}: peak device memory "
              f"{peak} bytes over the budget {budget.hbm_bytes}")
        worst, copy_max = _oracle_spots(plan, imgs, out, ex.band_rows or 256)
        check(worst <= 1 and copy_max == 0, f"{strategy} vs oracle "
              f"{worst}, copy spans {copy_max}")
        rows.append(f"{strategy} (budget {budget.hbm_bytes / 1e6:.1f} MB"
                    f"{', ' + str(ex.band_rows) + '-row bands' if ex.band_rows else ''}): "
                    f"wall {wall:.4f} s compute {m.compute_s:.4f} s readback "
                    f"{m.readback_s:.4f} s h2d {m.h2d_bytes} bytes | peak "
                    f"{peak / 1e6:.1f} MB est {m.est_peak_bytes / 1e6:.1f} MB "
                    f"| launches #1/#2/#3 {launched[0]}/{launched[1]}/"
                    f"{launched[2]} | oracle spots max |diff| {worst} copy "
                    f"spans {copy_max}")
    say(f"phase13 config4-EXIF via imagestitching_tpu_torch.stitch on cuda "
        f"(9 x {shapes[0][0]}x{shapes[0][1]}, canvas {plan.canvas_w}x"
        f"{plan.canvas_h}x3 {canvas_bytes / 1e6:.1f} MB, {len(res)} "
        f"resampled + {9 - len(res)} copies, sources {src_mb:.1f} MB), every "
        "canvas equal to the resident one | " + " | ".join(rows)
        + f" | {smi}")

    # the 24 MP job at the default budget: streamed, equal to resident
    plan24, opts24, imgs24, items24 = _config4_job(dev, big, 24)
    ex = tiler.plan_execution(plan24, MemoryBudget())
    check(ex.strategy == "streamed", f"24 MP job: the tiler picks "
          f"{ex.strategy}")
    t0 = time.perf_counter()
    out24, m24 = itt.stitch(items24, options=opts24, config=RuntimeConfig(
        device=str(dev)), return_metrics=True)
    wall24 = time.perf_counter() - t0
    check(m24.strategy == "streamed", f"24 MP job ran {m24.strategy}")
    want24, mr = itt.stitch(items24, options=opts24, config=RuntimeConfig(
        device=str(dev), budget=budget_from_device(str(dev))),
        return_metrics=True)
    check(mr.strategy == "resident", f"24 MP resident run: {mr.strategy}")
    check(np.array_equal(out24, want24), "24 MP streamed canvas differs "
          "from the resident one")
    say(f"phase13 24MP job (9 x {big[0][0]}x{big[0][1]}, canvas "
        f"{plan24.canvas_w}x{plan24.canvas_h}x3) at the default "
        f"RuntimeConfig: strategy {m24.strategy} (est "
        f"{m24.est_peak_bytes / 1e6:.1f} MB), wall {wall24:.4f} s compute "
        f"{m24.compute_s:.4f} s readback {m24.readback_s:.4f} s, equal to a "
        f"resident run under budget_from_device ({mr.compute_s:.4f} s "
        f"compute) | {smi}")
    del out24, want24, imgs24, items24
    return plan, opts, imgs, items, ref, window_main


def phase14_ladder(dev, smi, plan, opts, items, ref):
    """The demotion ladder on a real ``torch.cuda.OutOfMemoryError``: a
    per-process memory cap the resident rung cannot meet (the tiler still
    picks resident under ``budget_from_device``) demotes to streamed, and a
    cap below the canvas to banded."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu.runtime.logger import StitchLogger, set_logger
    from imagestitching_tpu_torch import RuntimeConfig
    from imagestitching_tpu_torch.config import budget_from_device

    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    src_max = max(a.nbytes for a, _ in items)
    total = torch.cuda.get_device_properties(dev).total_memory
    cfg = RuntimeConfig(device=str(dev), budget=budget_from_device(str(dev)))
    log = StitchLogger()
    set_logger(log)
    rows = []
    try:
        for expect, headroom, failed in (
                ("streamed", canvas_bytes + 3 * src_max, ["resident"]),
                ("banded", canvas_bytes // 2, ["resident", "streamed"])):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            torch.cuda.set_per_process_memory_fraction(
                (reserved + headroom) / total, dev)
            log.clear()
            t0 = time.perf_counter()
            out, m = itt.stitch(items, options=opts, config=cfg,
                                return_metrics=True)
            wall = time.perf_counter() - t0
            retries = [(e["failed"], e["band"]) for e in log.ring()
                       if e["tag"] == "pipeline.oom_retry"]
            check(m.strategy == expect and [f for f, _ in retries] == failed,
                  f"cap {headroom} bytes over {reserved}: ran {m.strategy} "
                  f"after {retries}, expected {expect} after {failed}")
            check(np.array_equal(out, ref), f"{expect} after OOM differs "
                  "from the resident canvas")
            rows.append(f"cap reserved+{headroom / 1e6:.1f} MB: "
                        f"{m.strategy} after oom_retry {retries}, wall "
                        f"{wall:.4f} s, equal to resident")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        set_logger(StitchLogger())
    say("phase14 OOM ladder on real torch.cuda.OutOfMemoryError (config 4, "
        "budget_from_device so the tiler picks resident): "
        + " | ".join(rows))


def phase15_window_times(dev, smi, plan, opts, items, band_rows=256):
    """Kernel #3 and its plain version timed over every chunk of config 4's
    banded job (crops and taps already on the card), checked bit for bit;
    then a streamed and a banded job under torch.profiler.  Returns (max
    |diff|, kernel ms, plain ms) per job."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu.core import geometry
    from imagestitching_tpu.runtime import tiler
    from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan

    chunks, regions = [], {}
    for p in resampled(plan):
        oriented = geometry.orient_array(items[p.index][0], p.orientation)
        wp = WindowPlan(p, plan.filter, band_rows)
        ci0, cw = (torch.from_numpy(a).to(dev) for a in (wp.ci0, wp.cw))
        regions[p.index] = torch.zeros((wp.chunk, wp.n_cols, 3),
                                       dtype=torch.uint8, device=dev)
        for g in range(wp.n_chunks):
            _, valid, _ = wp.chunk_window(g)
            chunks.append((p.index, valid, torch.from_numpy(
                wp.stage_crop(oriented, g)).to(dev),
                *(torch.from_numpy(t).to(dev) for t in wp.chunk_taps(g)),
                ci0, cw))

    def kernel():
        for idx, _, crop, ri0, rw, ci0, cw in chunks:
            cuda_resize.resize_place_window(crop, ri0, rw, ci0, cw,
                                            regions[idx])

    def plain():
        for idx, valid, crop, ri0, rw, ci0, cw in chunks:
            regions[idx][:valid] = cuda_resize.resize_place_window_ref(
                crop, ri0, rw, ci0, cw)

    plain_a = median_ms(plain, reps=5, inner=1)
    kern_a = median_ms(kernel, reps=5, inner=1)
    kern_b = median_ms(kernel, reps=5, inner=1)
    plain_b = median_ms(plain, reps=5, inner=1)
    k_dev, p_dev = device_ms(kernel, reps=3)[0], device_ms(plain, reps=3)[0]
    worst = ndiff = 0
    for idx, valid, crop, ri0, rw, ci0, cw in chunks:
        cuda_resize.resize_place_window(crop, ri0, rw, ci0, cw, regions[idx])
        want = cuda_resize.resize_place_window_ref(crop, ri0, rw, ci0, cw)
        d = (regions[idx][:valid].int() - want.int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).any(dim=2).sum())
    check(worst == 0 and ndiff == 0, f"config 4 windowed kernel vs plain "
          f"max |diff| {worst}, {ndiff} differing pixels (must be exact)")
    k_ms = statistics.median([kern_a, kern_b])
    p_ms = statistics.median([plain_a, plain_b])
    crop0 = chunks[0][2]
    say(f"phase15 windowed times over config 4's {len(chunks)} chunks of "
        f"{band_rows} rows (crop {tuple(crop0.shape)} -> region "
        f"{band_rows}x{regions[chunks[0][0]].shape[1]}x3; ms per job, CUDA "
        f"events median of 5, order plain kernel kernel plain: "
        f"{plain_a:.4f} {kern_a:.4f} {kern_b:.4f} {plain_b:.4f}) on {smi}: "
        f"kernel {k_ms:.4f} ({k_dev:.4f} busy) plain {p_ms:.4f} "
        f"({p_dev:.4f} busy) | max |diff| {worst}, differing px {ndiff}")
    del chunks, regions

    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    for strategy, budget in (
            ("streamed", MemoryBudget(
                hbm_bytes=tiler.resident_peak_bytes(plan) - 1)),
            ("banded", MemoryBudget(hbm_bytes=canvas_bytes // 2))):
        cfg = RuntimeConfig(device=str(dev), budget=budget)

        def job(cfg=cfg):
            itt.stitch(items, options=opts, config=cfg)

        busy, wall, by_name = device_ms(job, reps=1)
        groups = {"Memcpy HtoD": 0.0, "resize_place": 0.0,
                  "Memcpy DtoH": 0.0}
        for name, ms in by_name.items():
            key = next((k for k in groups if k in name), "other")
            groups[key] = groups.get(key, 0.0) + ms
        say(f"phase15 warm {strategy} config-4 job under torch.profiler on "
            f"{smi}: host wall {wall:.4f} ms, device busy {busy:.4f} ms, "
            f"idle (host) share {1 - busy / wall if wall else float('nan'):.4f}"
            " | device ms " + " ".join(f"{k}={v:.4f}"
                                       for k, v in groups.items()))

    # host parts of the banded job, by host clock: the canvas fill and the
    # blits of the copy placements (rotated sources are strided copies)
    t0 = time.perf_counter()
    out = np.empty((plan.canvas_h, plan.canvas_w, 3), np.uint8)
    out[:] = np.asarray(plan.background[:3], np.uint8)
    fill_s = time.perf_counter() - t0
    blits = []
    for p in plan.placements:
        off = geometry.placement_copy_offsets(p, plan.filter)
        if off is None:
            continue
        (r0, r1), (c0, c1), (sr, sc) = p.row_span, p.col_span, off
        t0 = time.perf_counter()
        out[r0:r1, c0:c1] = geometry.orient_array(
            items[p.index][0], p.orientation)[sr:sr + r1 - r0,
                                              sc:sc + c1 - c0]
        blits.append(f"o{p.orientation}:{time.perf_counter() - t0:.4f}")
    say(f"phase15 banded job's host work by host clock: canvas fill "
        f"{fill_s:.4f} s, copy blits (orientation:s) {' '.join(blits)}")
    return worst, k_ms, p_ms


def _multipart(blobs):
    boundary = "chipsmokeboundary"
    parts = [(f"--{boundary}\r\nContent-Disposition: form-data; "
              f'name="f{i}"; filename="{i}"\r\n'
              "Content-Type: application/octet-stream\r\n\r\n").encode()
             + b + b"\r\n" for i, b in enumerate(blobs)]
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def phase11_http(dev, smi):
    """``StitchHTTPServer`` on localhost: 4 concurrent ``POST /stitch``
    (PNG parts of mixed sizes, one JPEG with EXIF orientation 6), each
    answer equal to ``imagestitching_tpu_torch.stitch`` on the same bytes;
    ``/healthz`` names the card and ``/stats`` counts the jobs."""
    import io
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor
    from urllib.parse import parse_qs

    import torch
    from PIL import Image

    import imagestitching_tpu_torch as itt
    from imagestitching_tpu.imgio import codec
    from imagestitching_tpu_torch import RuntimeConfig, StitchHTTPServer
    from imagestitching_tpu_torch.serve.http import _options_from

    rng = np.random.default_rng(11)

    def png(w, h):
        return codec.encode_bytes(rng.integers(0, 256, (h, w, 3), np.uint8),
                                  "png")

    buf = io.BytesIO()
    img = Image.fromarray(rng.integers(0, 256, (300, 400, 3), np.uint8))
    exif = img.getexif()
    exif[274] = 6                      # rotate 90: displayed 300 x 400
    img.save(buf, "JPEG", quality=95, exif=exif)
    rotated = buf.getvalue()
    check(codec.decode(rotated)[1] == 6, "EXIF orientation lost")
    requests = [
        ("direction=vertical&mode=min&gap=4",
         [png(640, 480), png(800, 600), png(500, 700)]),
        ("direction=vertical&mode=min&gap=4",
         [png(640, 480), png(800, 600), png(500, 700)]),
        ("direction=horizontal&mode=max&gap=2",
         [png(300, 200), rotated, png(256, 256)]),
        ("direction=horizontal&gap=0", [png(1024, 768), png(1280, 720)]),
    ]
    cfg = RuntimeConfig(device=str(dev))
    with StitchHTTPServer(port=0, max_wait_s=0.05, config=cfg) as srv:
        base = f"http://{srv.host}:{srv.port}"

        def post(req):
            body, ctype = _multipart(req[1])
            r = urllib.request.Request(f"{base}/stitch?{req[0]}", data=body,
                                       headers={"Content-Type": ctype})
            with urllib.request.urlopen(r, timeout=300) as resp:
                return resp.status, resp.read()

        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(requests)) as pool:
            answers = list(pool.map(post, requests))
        wall = time.perf_counter() - t0
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())["server"]
    shapes = []
    for (query, blobs), (status, data) in zip(requests, answers):
        check(status == 200, f"POST /stitch?{query}: {status}")
        got = codec.decode(data)[0]
        options, _ = _options_from(parse_qs(query))
        want = itt.stitch(blobs, options=options, config=cfg)
        check(np.array_equal(got, want),
              f"POST /stitch?{query} differs from stitch")
        shapes.append(f"{got.shape[1]}x{got.shape[0]}")
    name = torch.cuda.get_device_name(dev)
    check(name in health["backend"], f"/healthz says {health}")
    check(stats["jobs"] >= len(requests) and stats["failed"] == 0,
          f"/stats says {stats}")
    say(f"phase11 http: {len(requests)} concurrent POST /stitch answered "
        f"200 in {wall:.4f} s, each equal to imagestitching_tpu_torch.stitch "
        f"({' '.join(shapes)}; one JPEG with EXIF 6) | /healthz backend "
        f"{health['backend']!r} | /stats jobs {stats['jobs']} batches "
        f"{stats['batches']} failed {stats['failed']}")


def main() -> None:
    # ---- phase 1: environment
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    smi = nvidia_smi()
    say(f"phase1 env: python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}")

    sys.path.insert(0, ROOT)
    try:
        import imagestitching_tpu_torch as itt
        from imagestitching_tpu_torch.ops import _build, cuda_resize
    except ImportError as e:
        fail(f"run from the root of a checkout ({e!r})")
    from imagestitching_tpu.config import CanvasLimits
    from imagestitching_tpu.core import geometry, oracle
    from imagestitching_tpu.core.layout import ImageSpec, solve
    from imagestitching_tpu.imgio import codec
    from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
    from imagestitching_tpu_torch.config import budget_from_device
    check("jax" not in sys.modules, "the port imported jax")

    # ---- phase 2: build the kernel from the checkout's sources
    _build.load()
    info = _build.last_build()
    check(str(_build.CSRC).startswith(ROOT), "kernel sources outside the "
          "checkout")
    regs = " ".join(ln.split(": ", 1)[-1] for ln in info.log.splitlines()
                    if "registers" in ln or "spill" in ln)
    say(f"phase2 build: {' '.join(info.command)} | seconds "
        f"{info.seconds:.3f} cached {info.cached} | ptxas: {regs or 'n/a'} "
        f"| budget_from_device: {budget_from_device().hbm_bytes} bytes")

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    def kernel_vs_plain(plan, imgs):
        """Max |diff| and differing pixels of the kernel's store against
        the plain version, over every resampled placement of ``plan``."""
        worst, ndiff = 0, 0
        for p in resampled(plan):
            src = src_on(imgs[p.index], dev)
            taps = taps_on(p, plan.filter, dev)
            canvas = torch.zeros((plan.canvas_h, plan.canvas_w,
                                  src.shape[2]), dtype=torch.uint8,
                                 device=dev)
            r0, r1 = p.row_span
            c0, c1 = p.col_span
            cuda_resize.resize_place(src, p.orientation, *taps, canvas,
                                     r0, c0)
            ref = cuda_resize.resize_place_ref(src, p.orientation, *taps)
            d = (canvas[r0:r1, c0:c1].int() - ref.int()).abs()
            worst = max(worst, int(d.max()))
            ndiff += int((d > 0).any(dim=2).sum())
        return worst, ndiff

    # ---- phase 3: kernel against its plain version on the card
    def rand(w, h, c=3):
        shape = (h, w) if c == 1 else (h, w, c)
        return rng.integers(0, 256, shape, np.uint8)

    cases = []
    frac_limits = CanvasLimits(max_side=600, max_pixels=10 ** 9,
                               max_supersample=1.0)
    cases.append(("bilinear-down-frac", [(800, 720, 1), (640, 800, 3),
                                         (500, 300, 1)],
                  StitchOptions(direction="horizontal", gap=9), frac_limits,
                  3))
    cases.append(("bilinear-up-frac", [(160, 90, 1), (400, 300, 1),
                                       (97, 61, 6)],
                  StitchOptions(mode="max", gap=3.5), None, 3))
    # 2x downscale: every tap weighs 0.5, many sums land on .5 (half-up)
    cases.append(("bilinear-halves", [(400, 200, 1), (100, 100, 1)],
                  StitchOptions(direction="horizontal"), None, 3))
    for o in range(1, 9):
        cases.append((f"orient{o}", [(333, 217, o), (400, 260, 1)],
                      StitchOptions(mode="max", gap=2.5), None, 3))
    for kind in ("triangle", "box", "lanczos3"):
        cases.append((f"{kind}-down", [(900, 700, 6), (300, 200, 1),
                                       (640, 480, 3)],
                      StitchOptions(direction="horizontal", gap=4,
                                    filter=kind), None, 3))
    cases.append(("gray-c1", [(500, 400, 1), (300, 350, 8)],
                  StitchOptions(direction="horizontal", gap=1.5), None, 1))

    worst_all, notes = 0, []
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        imgs = [rand(w, h, c) for w, h, _ in shapes]
        check(len(resampled(plan)) > 0, f"{name}: no resampled placement")
        if name == "bilinear-down-frac":
            check(plan.scale_down < 1.0, f"{name}: limits did not scale down")
        worst, ndiff = kernel_vs_plain(plan, imgs)
        got = cuda_resize.stitch(plan, imgs, dev).cpu().numpy()
        want = oracle.stitch(plan, imgs)
        odiff = int(np.abs(got.astype(np.int16) - want.astype(np.int16))
                    .max())
        # The kernel keeps the plain version's summation order and is built
        # with -fmad=false: any differing pixel (a truncating or
        # half-to-even store, a stride bug) is a fault, not noise.
        check(worst == 0 and ndiff == 0, f"{name}: kernel vs plain max "
              f"|diff| {worst}, {ndiff} differing pixels (must be exact)")
        check(odiff <= 1, f"{name}: kernel job vs oracle {odiff} > 1")
        worst_all = max(worst_all, worst)
        notes.append(f"{name}:{worst}/{ndiff}/{odiff}")
    say(f"phase3 kernel vs plain (exact: max |diff| 0, 0 differing pixels), "
        f"oracle within 1: {len(cases)} cases max |diff| {worst_all} | "
        f"case:max_diff/differing_px/oracle_max " + " ".join(notes))

    # ---- phase 4: BASELINE config 3 through the public entry point
    rng = np.random.default_rng(0)
    items = [(rng.integers(0, 256, (h, w, 3), np.uint8), o)
             for w, h, o in CONFIG3]
    opts3 = StitchOptions(direction="horizontal", mode="min", gap=4,
                          max_images=None)
    cfg = RuntimeConfig(device="cuda")
    plan3 = solve([ImageSpec(w, h, o) for w, h, o in CONFIG3], opts3)
    copies = [p for p in plan3.placements
              if geometry.placement_copy_offsets(p, plan3.filter) is not None]
    per_job = len(resampled(plan3))
    check(len(copies) == 4 and per_job == 5,
          f"config 3 plan: {len(copies)} copies, {per_job} resampled")
    walls, deltas, phases, out = [], [], [], None
    cuda_resize.launches = cuda_resize.batch_launches = 0
    for _ in range(3):
        before = cuda_resize.launches
        t0 = time.perf_counter()
        out, m = itt.stitch(items, options=opts3, config=cfg,
                            return_metrics=True)
        walls.append(time.perf_counter() - t0)
        deltas.append(cuda_resize.launches - before)
        phases.append(f"{m.prepare_s:.4f}/{m.compute_s:.4f}/"
                      f"{m.readback_s:.4f}")
        check(m.strategy == "resident", f"strategy {m.strategy!r}")
    launches_main = cuda_resize.launches
    check(deltas == [per_job] * 3, f"kernel launches per job {deltas}, "
          f"expected {per_job}")
    check(cuda_resize.batch_launches == 0, "the single-job path launched "
          "the batched kernel")
    check(out.shape == (1080, 12962, 3), f"canvas {out.shape}")
    want = oracle.stitch(plan3, [a for a, _ in items])
    diff = np.abs(out.astype(np.int16) - want.astype(np.int16))
    copy_max = max(int(diff[p.row_span[0]:p.row_span[1],
                            p.col_span[0]:p.col_span[1]].max())
                   for p in copies)
    check(int(diff.max()) <= 1, f"config 3 vs oracle {int(diff.max())}")
    check(copy_max == 0, f"config 3 copy spans differ by {copy_max}")
    say(f"phase4 config3 via imagestitching_tpu_torch.stitch on cuda: canvas "
        f"{out.shape[1]}x{out.shape[0]}x{out.shape[2]} strategy resident "
        f"launches/job {deltas} | wall_s cold {walls[0]:.4f} warm "
        f"{walls[1]:.4f} {walls[2]:.4f} (prepare/compute/readback s "
        f"{' '.join(phases)}) | oracle max |diff| "
        f"{int(diff.max())} copy spans {copy_max} | {smi}")

    # ---- phase 5: export through the shared codec
    with tempfile.TemporaryDirectory() as td:
        path, m5 = itt.stitch_to_file(items, os.path.join(td, "out.png"),
                                      options=opts3, config=cfg,
                                      stream=False, return_metrics=True)
        back, _ = codec.decode(path)
        size = os.path.getsize(path)
    check(np.array_equal(back, out), "PNG round trip differs")
    say(f"phase5 export: stitch_to_file(stream=False) -> PNG {size} bytes, "
        f"decoded equal to phase 4 | encode_s {m5.encode_s:.4f}")

    # ---- phase 6: kernel and plain times at config 3's shapes
    imgs3 = [a for a, _ in items]
    canvas = torch.zeros((plan3.canvas_h, plan3.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    k_total = p_total = kd_total = pd_total = 0.0
    rows, worst6, ndiff6 = [], 0, 0
    for p in resampled(plan3):
        src = src_on(imgs3[p.index], dev)
        taps = taps_on(p, plan3.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span

        def kernel(src=src, taps=taps, p=p, r0=r0, c0=c0):
            cuda_resize.resize_place(src, p.orientation, *taps, canvas,
                                     r0, c0)

        def plain(src=src, taps=taps, p=p, r0=r0, r1=r1, c0=c0, c1=c1):
            canvas[r0:r1, c0:c1] = cuda_resize.resize_place_ref(
                src, p.orientation, *taps)

        plain_a = median_ms(plain)
        kern_a = median_ms(kernel)
        got = canvas[r0:r1, c0:c1].clone()
        plain()
        d = (got.int() - canvas[r0:r1, c0:c1].int()).abs()
        worst6 = max(worst6, int(d.max()))
        ndiff6 += int((d > 0).any(dim=2).sum())
        kern_b = median_ms(kernel)
        plain_b = median_ms(plain)
        k_ms = statistics.median([kern_a, kern_b])
        p_ms = statistics.median([plain_a, plain_b])
        k_dev, p_dev = device_ms(kernel)[0], device_ms(plain)[0]
        k_total += k_ms
        p_total += p_ms
        kd_total += k_dev
        pd_total += p_dev
        rows.append(f"#{p.index} o{p.orientation} {p.raw_w}x{p.raw_h}->"
                    f"{c1 - c0}x{r1 - r0} kernel {k_ms:.4f} ({k_dev:.4f}) "
                    f"plain {p_ms:.4f} ({p_dev:.4f})")
    check(worst6 == 0 and ndiff6 == 0, f"config 3 kernel vs plain max "
          f"|diff| {worst6}, {ndiff6} differing pixels (must be exact)")
    say(f"phase6 times (ms; CUDA events, median of 20x10 launches, order "
        f"plain kernel kernel plain; in brackets the profiler's device "
        f"busy time) on {smi}: " + " | ".join(rows)
        + f" | total kernel {k_total:.4f} ({kd_total:.4f}) plain "
        f"{p_total:.4f} ({pd_total:.4f}) | kernel vs plain max |diff| "
        f"{worst6}, differing px {ndiff6}")

    # ---- phase 7: where a warm config-3 job's time goes on the device
    def job():
        itt.stitch(items, options=opts3, config=cfg)

    busy, wall, by_name = device_ms(job, reps=5)
    groups = {"resize_place": 0.0, "Memcpy HtoD": 0.0, "Memcpy DtoH": 0.0}
    for name, ms in by_name.items():
        key = next((g for g in groups if g in name), "other")
        groups[key] = groups.get(key, 0.0) + ms
    say(f"phase7 warm config-3 job under torch.profiler (5 jobs) on {smi}: "
        f"host wall {wall:.4f} ms/job, device busy {busy:.4f} ms/job, idle "
        f"share {1 - busy / wall if wall else float('nan'):.4f} | device "
        "ms/job " + " ".join(f"{k}={v:.4f}" for k, v in groups.items()))

    # ---- phases 8-11: batched serving (kernel #2, StitchServer, HTTP)
    worst8 = phase8_batch_vs_plain(cases, dev)
    plan5, stacks5, launches5 = phase9_config5(dev, smi, budget_from_device())
    worst10, kb_total, pb_total = phase10_batch_times(dev, smi, plan5,
                                                      stacks5)
    del stacks5
    phase11_http(dev, smi)

    # ---- phases 12-15: streamed, banded (kernel #3) and the OOM ladder
    worst12 = phase12_window_vs_plain(cases, dev)
    plan4, opts4, _, items4, ref4, launches_w = phase13_config4(dev, smi)
    phase14_ladder(dev, smi, plan4, opts4, items4, ref4)
    del ref4
    worst15, kw_total, pw_total = phase15_window_times(dev, smi, plan4, opts4,
                                                       items4)

    record = {"kernels": [{
        "name": "resize_place", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches_main,
        "max_abs_err": max(worst_all, worst6),
        "ms": round(k_total, 6), "plain_ms": round(p_total, 6)}, {
        "name": "resize_place_batch", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES_BATCH,
        "launches": launches5, "max_abs_err": max(worst8, worst10),
        "ms": round(kb_total, 6), "plain_ms": round(pb_total, 6)}, {
        "name": "resize_place_window", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": REPLACES_WINDOW,
        "launches": launches_w, "max_abs_err": max(worst12, worst15),
        "ms": round(kw_total, 6), "plain_ms": round(pw_total, 6)}]}
    say(json.dumps(record))
    say(f"gpu: {smi}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
