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
7. where a warm config-3 job's time goes on the device (torch.profiler).

The last two lines are a JSON record of the kernels and the device line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
    from imagestitching_tpu_torch.ops import torch_compose
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

    def taps_on(p, kind):
        t = torch_compose.placement_taps(p, kind)
        return tuple(torch.from_numpy(a).to(dev) for a in
                     (t["rows"]["i0"], t["rows"]["w"],
                      t["cols"]["i0"], t["cols"]["w"]))

    def src_on(raw):
        a = raw if raw.ndim == 3 else raw[:, :, None]
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def resampled(plan):
        return [p for p in plan.placements
                if p.row_span[1] > p.row_span[0]
                and p.col_span[1] > p.col_span[0]
                and geometry.placement_copy_offsets(p, plan.filter) is None]

    def kernel_vs_plain(plan, imgs):
        """Max |diff| and differing pixels of the kernel's store against
        the plain version, over every resampled placement of ``plan``."""
        worst, ndiff = 0, 0
        for p in resampled(plan):
            src = src_on(imgs[p.index])
            taps = taps_on(p, plan.filter)
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
    cuda_resize.launches = 0
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
    def median_ms(fn, reps=20, inner=10):
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

    imgs3 = [a for a, _ in items]
    canvas = torch.zeros((plan3.canvas_h, plan3.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    k_total = p_total = kd_total = pd_total = 0.0
    rows, worst6, ndiff6 = [], 0, 0
    for p in resampled(plan3):
        src = src_on(imgs3[p.index])
        taps = taps_on(p, plan3.filter)
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

    record = {"kernels": [{
        "name": "resize_place", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches_main,
        "max_abs_err": max(worst_all, worst6),
        "ms": round(k_total, 6), "plain_ms": round(p_total, 6)}]}
    say(json.dumps(record))
    say(f"gpu: {smi}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
