#!/usr/bin/env python3
"""Drive the PyTorch port (imagestitching_tpu_torch) once on one CUDA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

``--parent-source PATH`` also builds a previous kernel source (for example
``git show HEAD~1:imagestitching_tpu_torch/csrc/resize_place.cu``) into a
temporary directory and times that body beside the current one;
``--parent-staged-source PATH`` does the same for a previous
``csrc/resize_place_staged.cu`` (kernel #4's first version) in phase 24.

Phases, one line each; any failure exits non-zero and prints no result:

1. environment: torch, CUDA, the card's name and power limit (nvidia-smi);
2. build: the kernels of ``imagestitching_tpu_torch/csrc`` with nvcc for
   sm_90a, one nvcc per source, started together, then one link;
3. the kernel against its plain PyTorch version on the card, bit for bit
   (bilinear up and down with fractional offsets, all 8 EXIF orientations,
   the triangle/box/lanczos3 filters, 1 and 3 channels; tiles cut by the
   region's edge at odd canvas columns, a 12x bilinear downscale of a
   transposed source, lanczos3 with K = 97, a 4x upscale), each job also
   against the float64 oracle within 1 step;
4. the slice at real size: BASELINE config 3 (9 photos of 1-3 MP with EXIF
   orientations, horizontal, mode "min", gap 4) through
   ``imagestitching_tpu_torch.stitch`` on ``cuda``, three times, counting
   kernel launches, checked against the oracle;
5. export: ``stitch_to_file(stream=False)`` to PNG, decoded back;
6. kernel times (CUDA events, and the profiler's device busy time) at
   config 3's shapes: the prepared launch (``cuda_resize.PlaceLaunch``, as
   the main path launches it) beside the plain version, the parent body
   (with ``--parent-source``), one ``F.interpolate`` call and the bound
   (tap footprint read once and regions written, at 3.35 TB/s), and the
   host microseconds a launch takes; the prepared store checked bit for bit
   against the plain version's (and the parent's);
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
10. the same yardsticks for the batched kernel at config 5's shapes
    (B = 64);
11. HTTP: ``StitchHTTPServer`` on localhost answers 4 concurrent
    ``POST /stitch`` with what ``imagestitching_tpu_torch.stitch`` gives;
12. the windowed kernel (#3) against its plain version on the card, bit for
    bit, over phase 3's cases in 16-row chunks, each chunk both from its
    rebased taps and from the placement's taps with its row offset, and
    each case's banded canvas against the resident one;
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
15. the same yardsticks for the windowed kernel over config 4's 45 chunks
    as the banded rung launches them (the prepared ``WindowLauncher``),
    and where a streamed and a banded job's time goes (torch.profiler),
    the banded one with no per-chunk tap upload;
16. the overlapped scheduler: config 4-EXIF written as nine JPEG files with
    their orientation tags, through ``imagestitching_tpu_torch.stitch(files)``
    at the default ``RuntimeConfig`` (9 images, so ``overlap="auto"`` takes
    it): strategy ``overlapped``, kernel #1 launched once per resampled
    placement, equal to ``overlap="never"`` bit for bit and to the oracle
    within 1; warm runs of both beside each other; a banded budget and real
    OOMs (at the canvas, at the first upload) giving
    ``overlapped/banded``, equal; one profiled warm job;
17. the streaming export: ``export._stream_device`` on the overlapped job's
    device canvas into memory (joined equal to ``canvas.cpu()``); with the
    native codec, ``stitch_to_file`` to PNG and JPEG with the default
    ``stream="auto"`` against ``stream=False`` (PNG pixels, JPEG bytes
    equal); BASELINE config 4 proper (9 x 4000x3000 PNG files) to a JPEG,
    as ``host-blit-stream`` (``host-blit`` without the native codec) with no
    device allocation and no launch, its bytes equal to the monolithic
    encoder's;
18. the CLI: ``python -m imagestitching_tpu_torch.cli`` in a subprocess on
    config 3 as JPEG files (``--json --metrics``), by default and with
    ``--engine torch``, its PNG equal to phase 4's path on the same pixels;
19. merge: five synthetic phone screenshots (1170 x 2532, consecutive ones
    sharing 400 rows) through ``stitch(..., merge_overlap=True)`` on
    ``cuda``: the float64 scores on the card within 1e-9 of
    ``_scores_numpy`` on every pair, trims ``[0, 400, 400, 400, 400]`` equal
    to the numpy scorer's, the merged canvas equal to the stitch of the
    pre-trimmed screenshots and to the capture; one job through
    ``StitchServer.submit``;
20. the grid collage: config 4-EXIF's nine sources through
    ``stitch_grid(cols=3, mode="min", gap=4)`` on ``cuda``, kernel #1's
    launches counted per column, within 1 of each column's oracle around
    every placement edge and exact on copy spans; ``valign="center"``
    equal column by column;
21. the preview: the config 4-EXIF canvas kept on the card,
    ``make_preview(box_w=750)``: one launch of #1, equal to its plain
    version bit for bit, within 1 of ``device=False``; CUDA-event and busy
    times beside the plain version, one ``F.interpolate`` call and the
    bound;
22. space-sharded: config 4-EXIF from arrays on a ``(1, 4)`` space mesh
    that names ``cuda:0`` four times (one card: bits, launches and memory,
    not multi-card speed), at the default budget: strategy
    ``space-sharded``, equal to phase 13's resident canvas bit for bit,
    oracle spots within 1 (band seams too), copy spans exact, kernel #3
    launched once per (band, resampled placement) pair counted from the
    plan; a ``(1, 2)`` mesh over the budget by ``tiler.sharded_peak_bytes``
    rejected to the ladder; a real OOM inside the sharded compose (phase
    14's memory cap) demoted, the same canvas; #3's times at one band
    window beside its plain version, ``F.interpolate`` and the bound; the
    per-device peak beside the estimate; the wall split into upload,
    compose and gather;
23. jobs mesh: config 5's 64 jobs on a ``(4, 1)`` jobs mesh of ``cuda:0``
    four times, 4 x 8 launches of #2, equal to the single-card batch; a
    batch of 62 refused as not divisible; ``StitchServer(use_mesh=True)``
    over every card serving config 3 jobs equal to the plain server's;
24. kernel #4, config 5's slot 0 from a ring of staged source bands
    (``ops/staged_resize.py``): against its plain version bit for bit with
    the bands as uint8 and as bf16, on slot 0 at the default grid (as many
    CTAs as the SMs hold), at one CTA an SM and at 72, 5 and 1 CTAs (the
    ring wraps), on phase 3's sources oriented on the card (one channel,
    odd widths whose pitch is padded), and against #1 on slot 0; the
    profiler (``imagestitching_tpu_torch.tools.profile_bf16_stage``) in
    this process and as ``python -m`` in a subprocess, which must exit 0;
    CUDA-event and busy times of both band dtypes' prepared calls on slot 0
    beside the bound, ``F.interpolate``, #1, the plain version, the
    previous body (``--parent-staged-source``) and the prepared call at one
    CTA an SM, and the host microseconds a launch takes (prepared,
    one-shot, previous);
25. #1-#3 at their main-path sites (config 3, config 5 at B = 64, config
    4-EXIF's 45 banded chunks), launched prepared, in a fresh process:
    ``python -m imagestitching_tpu_torch.tools.profile_resize``, which
    must exit 0 with every launch equal bit for bit to the plain version:
    CUDA events, busy time (every launch recorded, as late in this process
    it is not) and host microseconds a launch.

Phases 4-15 pass ``overlap="never"``: they read the non-overlapped path,
which 9-image jobs leave for the overlapped scheduler by default.  Each
kernel's launch count is read from its own path: phase 4 for the single-job
kernel, phase 9 for the batched one, phase 13's banded run for the windowed
one, phase 16 for #1 and #3 on the overlapped scheduler
(``launches_overlapped``), phases 19, 20 and 21 for #1 on the merged
stitch, the grid and the preview (``launches_merge``, ``launches_grid``,
``launches_preview``), phase 22 for #3 space-sharded
(``launches_space_sharded``), phase 23 for #2 on the jobs mesh
(``launches_jobs_mesh``) and phase 24's profiler run for #4, each with the
counts set to 0 just before.  The last two lines are a JSON
record of the kernels and the device line ``{"ok": true, "device":
{...}}``.  Imports nothing of the JAX package.
Before them the card's name and power limit, as ``nvidia-smi`` gives them.
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
STAGED_SOURCE = "imagestitching_tpu_torch/csrc/resize_place_staged.cu"
REPLACES_STAGED = "benchmarks/profile_bf16_stage.py:87"

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


HBM_BYTES_PER_S = 3.35e12      # H100 SXM, HBM3 peak


def counts_ms(fn, reps=3):
    """``device_ms`` plus the number of device activities of each name per
    call of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    counts = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
    return {k: v / reps for k, v in counts.items()}


def footprint_bytes(ri0, rw, m_h, ci0, cw, m_w, channels):
    """Bytes of source one resample must read: the rows and cols that its
    taps of non-zero weight touch (clamped as the kernel clamps them), each
    read once."""
    def touched(i0, w, m):
        idx = np.clip(i0[:, None].astype(np.int64)
                      + np.arange(w.shape[1])[None, :], 0, m - 1)
        return np.unique(idx[w != 0]).size

    return (touched(np.asarray(ri0), np.asarray(rw), m_h)
            * touched(np.asarray(ci0), np.asarray(cw), m_w) * channels)


def bound_ms(nbytes):
    """The least time the card could take to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def interp_call(src, orientation, n_rows, n_cols, kind):
    """One PyTorch call that computes the placement's resample for a whole
    placement, ``F.interpolate`` (bilinear, antialiased for triangle), on
    the oriented source as float32 NCHW made here, outside any timed
    window.  Returns the call."""
    import torch
    import torch.nn.functional as F
    from imagestitching_tpu_torch.ops import torch_compose

    x = torch_compose.orient(src if src.ndim == 4 else src[None],
                             orientation)
    x = x.permute(0, 3, 1, 2).float().contiguous()
    return lambda: F.interpolate(x, size=(n_rows, n_cols), mode="bilinear",
                                 align_corners=False,
                                 antialias=kind == "triangle")


def load_parent(source):
    """The parent commit's kernel library, built from ``source`` (its
    ``csrc/resize_place.cu``, which has the prepared entries and the
    ``PlaceArgs`` of this checkout) with the port's nvcc flags into a
    temporary directory, for timing beside the current body."""
    import ctypes
    from imagestitching_tpu_torch.ops import _build, cuda_resize

    out = os.path.join(tempfile.mkdtemp(prefix="parent_kernel_"),
                       "libparent.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"parent build: {proc.stderr[-2000:]}")
    lib = ctypes.CDLL(out)
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.resize_place_args_size.argtypes = []
    lib.resize_place_prepare.argtypes = [p]
    lib.resize_place_run.argtypes = [p, p, p, p]
    lib.resize_place_window_run.argtypes = [p, p, i32, i32, i32, p]
    for f in (lib.resize_place_args_size, lib.resize_place_prepare,
              lib.resize_place_run, lib.resize_place_window_run):
        f.restype = i32
    check(lib.resize_place_args_size() == ctypes.sizeof(
        cuda_resize.PlaceArgs), "the parent's PlaceArgs differs from this "
          "checkout's")
    return lib


def parent_call(lib, entry, src, orientation, taps, canvas, r0=0, c0=0):
    """One launch of the parent body (``entry``: one, batch or window)
    with the current stream, prepared once and called as the port's
    launchers prepare and call it (``window``: ``src`` is the crop,
    ``canvas`` the region, the taps the chunk's)."""
    import ctypes

    from imagestitching_tpu_torch.ops import cuda_resize

    if entry == "window":
        launch = cuda_resize.WindowLauncher(*taps, canvas, src.shape)
    else:
        launch = cuda_resize.PlaceLaunch(src, orientation, *taps, canvas, r0,
                                         c0)
    args = launch.args
    check(lib.resize_place_prepare(ctypes.byref(args)) == 0,
          f"parent {entry} prepare")
    # the reference holds ``args`` alive for as long as the call exists
    ref, index, stream = (ctypes.byref(args), src.get_device(),
                          cuda_resize._raw_stream())

    def call():
        if entry == "window":
            err = lib.resize_place_window_run(ref, src.data_ptr(), 0, 0,
                                              taps[0].shape[0], stream(index))
        else:
            err = lib.resize_place_run(ref, src.data_ptr(), canvas.data_ptr(),
                                       stream(index))
        check(err == 0, f"parent {entry} launch: error {err}")
    return call


def load_parent_staged(source):
    """A previous ``csrc/resize_place_staged.cu`` (the first version of
    kernel #4, whose one C entry takes every argument at each launch),
    built with the port's nvcc flags into a temporary directory, with its
    entry bound to that signature."""
    import ctypes
    from imagestitching_tpu_torch.ops import _build

    out = os.path.join(tempfile.mkdtemp(prefix="parent_staged_"),
                       "libparent_staged.so")
    cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, source]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"parent staged build: {proc.stderr[-2000:]}")
    lib = ctypes.CDLL(out)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.resize_place_staged_launch.argtypes = [
        p, i32, i64, i64, i64, i32, p, p, i32, i32, p, p, i32, i32, p, p,
        i32, i32, i32, i32, p, i64, i64, i64, i64, i32, p]
    lib.resize_place_staged_launch.restype = i32
    return lib


def parent_staged_call(lib, taps, m_h, m_w, canvas):
    """A call of the previous kernel #4 as its one-shot wrapper made it, on
    its own schedule (32x64 tiles, columns aligned to 16 pixels), with all
    of that wrapper's host work at every call: the checks, the schedule's
    shapes, the current device and stream, 27 arguments."""
    import ctypes

    import torch
    from imagestitching_tpu_torch.ops import staged_resize

    ri0, rw, ci0, cw = taps
    n_rows, n_cols = ri0.shape[0], ci0.shape[0]
    b = staged_resize.band_schedule(ri0.cpu().numpy(), ci0.cpu().numpy(), 2,
                                    2, m_h, m_w, 32, 64, 16)
    rs, cs = (torch.from_numpy(x).to(ri0.device)
              for x in (b.row_starts, b.col_starts))
    shapes = (m_h, m_w, n_rows, n_cols, 2, 2)
    ptr = ctypes.c_void_p

    def call(band):
        staged_resize._check(band, *taps, canvas, 0, 0)
        check((band.shape[0], band.shape[1], n_rows, n_cols, rw.shape[1],
               cw.shape[1]) == shapes and rs.device == band.device,
              "parent staged schedule")
        elt = 2 if band.dtype == torch.bfloat16 else 1
        check(torch.cuda.current_device() == band.device.index,
              "parent staged device")
        err = lib.resize_place_staged_launch(
            ptr(band.data_ptr()), elt, band.stride(0) * elt, m_h, m_w, 3,
            ptr(ri0.data_ptr()), ptr(rw.data_ptr()), n_rows, 2,
            ptr(ci0.data_ptr()), ptr(cw.data_ptr()), n_cols, 2,
            ptr(rs.data_ptr()), ptr(cs.data_ptr()), b.band_h, b.band_w, 32,
            64, ptr(canvas.data_ptr()), canvas.shape[0], canvas.shape[1], 0,
            0, 0, ptr(torch.cuda.current_stream().cuda_stream))
        check(err == 0, f"parent staged launch: error {err}")
    return call


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
    from imagestitching_tpu_torch.core import geometry

    return [p for p in plan.placements
            if p.row_span[1] > p.row_span[0]
            and p.col_span[1] > p.col_span[0]
            and geometry.placement_copy_offsets(p, plan.filter) is None]


def _yardsticks(parts):
    """Sum the per-launch yardsticks of ``parts`` (dicts of numbers, None
    where not measured)."""
    out = {}
    for part in parts:
        for k, v in part.items():
            out[k] = None if v is None or out.get(k, 0) is None \
                else out.get(k, 0) + v
    return out


def _fmt(v):
    return "not measured" if v is None else f"{v:.4f}"


def time_versions(kernel, plain, parent, library, bound, device_reps=20,
                  **kw):
    """Per call, by CUDA events (median of two rounds in the order plain,
    kernel, parent, library, library, parent, kernel, plain) and the
    profiler's device busy time (the profiler tool's ``busy_ms``: a trace
    that reads below ``bound``, the kernel's bound in ms, which each must
    also meet, missed part of the work and is taken again), of the kernel
    (its prepared launch), its plain version, the parent body and the
    library call (None: not measured)."""
    from imagestitching_tpu_torch.tools.profile_bf16_stage import busy_ms

    fns = {"kernel": kernel, "plain": plain, "parent": parent,
           "library": library}
    order = ["plain", "kernel", "parent", "library"]
    ev = {k: [] for k in order}
    for name in order + order[::-1]:
        if fns[name] is not None:
            ev[name].append(median_ms(fns[name], **kw))
    out = {}
    for name in order:
        f = fns[name]
        out[name + "_ms"] = statistics.median(ev[name]) if f else None
        out[name + "_busy"] = busy_ms(f, bound, device_reps) if f else None
    return out


def launch_host_us(prepared, launches, reps):
    """Host microseconds a prepared launch takes: ``reps`` calls of
    ``prepared`` (``launches`` launches a call) with no synchronise among
    them."""
    from imagestitching_tpu_torch.tools.profile_bf16_stage import host_us

    return host_us(prepared, reps) / launches


def phase6_times(dev, smi, plan, imgs, parent):
    """Kernel #1 at config 3's placements: CUDA events and busy time of the
    prepared launch (``cuda_resize.PlaceLaunch``, as ``stitch`` launches
    it) beside the parent body, ``F.interpolate`` (the library call) and
    the plain version, the bound, the host microseconds a launch takes, and
    the prepared store bit for bit against the plain version's (and the
    parent's)."""
    import torch
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.ops import cuda_resize

    canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    other = torch.zeros_like(canvas)
    parts, rows, kernels, worst, ndiff, nparent = [], [], [], 0, 0, 0
    for p in resampled(plan):
        src = src_on(imgs[p.index], dev)
        taps = taps_on(p, plan.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)

        def kernel(src=src, launch=launch):
            launch(src, canvas)

        def plain(src=src, taps=taps, p=p, r0=r0, r1=r1, c0=c0, c1=c1):
            canvas[r0:r1, c0:c1] = cuda_resize.resize_place_ref(
                src, p.orientation, *taps)

        old = None if parent is None else parent_call(
            parent, "one", src, p.orientation, taps, other, r0, c0)
        disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                               p.orientation)
        nbytes = footprint_bytes(*(x.cpu().numpy() for x in taps[:2]),
                                 disp_h, *(x.cpu().numpy() for x in taps[2:]),
                                 disp_w, 3) + (r1 - r0) * (c1 - c0) * 3
        t = time_versions(kernel, plain, old, interp_call(
            src, p.orientation, r1 - r0, c1 - c0, plan.filter),
            bound_ms(nbytes))
        kernel()
        got = canvas[r0:r1, c0:c1].clone()
        plain()
        d = (got.int() - canvas[r0:r1, c0:c1].int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).any(dim=2).sum())
        if old is not None:
            old()
            nparent += int((other[r0:r1, c0:c1] != got).any(dim=2).sum())
        t["bound_ms"] = bound_ms(nbytes)
        t["bytes"] = nbytes
        parts.append(t)
        kernels.append(kernel)
        rows.append(f"#{p.index} o{p.orientation} {p.raw_w}x{p.raw_h}->"
                    f"{c1 - c0}x{r1 - r0} prepared {t['kernel_ms']:.4f} "
                    f"({_fmt(t['kernel_busy'])}) "
                    f"parent {_fmt(t['parent_ms'])} "
                    f"({_fmt(t['parent_busy'])}) F.interpolate "
                    f"{t['library_ms']:.4f} ({_fmt(t['library_busy'])}) plain "
                    f"{t['plain_ms']:.4f} ({_fmt(t['plain_busy'])}) bound "
                    f"{t['bound_ms']:.4f} ({nbytes} bytes)")
    check(worst == 0 and ndiff == 0, f"config 3 kernel vs plain max "
          f"|diff| {worst}, {ndiff} differing pixels (must be exact)")
    check(nparent == 0, f"config 3: {nparent} pixels unlike the parent body")
    tot = _yardsticks(parts)
    tot["host_us"] = launch_host_us(lambda: [f() for f in kernels],
                                    len(kernels), 40)
    say(f"phase6 times (ms per launch; CUDA events, median of 20x10 "
        f"launches in two rounds plain prepared parent F.interpolate and "
        f"back; in brackets the profiler's device busy time; bound = tap "
        f"footprint read once + region written at 3.35 TB/s) on {smi}: "
        + " | ".join(rows) + f" | total prepared {tot['kernel_ms']:.4f} "
        f"({_fmt(tot['kernel_busy'])}) parent {_fmt(tot['parent_ms'])} "
        f"({_fmt(tot['parent_busy'])}) F.interpolate "
        f"{tot['library_ms']:.4f} ({_fmt(tot['library_busy'])}) plain "
        f"{tot['plain_ms']:.4f} ({_fmt(tot['plain_busy'])}) bound "
        f"{tot['bound_ms']:.4f} | host us a launch (40 jobs of "
        f"{len(kernels)} launches, no synchronise among them) prepared "
        f"{tot['host_us']:.2f} | prepared vs plain max |diff| {worst}, "
        f"differing px {ndiff}, unlike parent {nparent}")
    tot["worst"] = worst
    return tot


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
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
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
    from imagestitching_tpu_torch.core import geometry, oracle
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
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
        _zero_counts()
        t0 = time.perf_counter()
        outs = flush_round()
        wall = time.perf_counter() - t0
        single, launches_main, _ = _launch_counts()
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


def phase10_batch_times(dev, smi, plan, stacks, parent):
    """Kernel #2 at config 5's placements and batch size: CUDA events and
    busy time of the prepared launch (as ``stitch_batch`` launches it)
    beside the parent body, ``F.interpolate`` and the plain version, the
    bound, the host microseconds a launch takes, and the prepared store bit
    for bit against the plain version's (and the parent's).  Returns the
    summed yardsticks."""
    import torch
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.ops import cuda_resize

    batch = stacks[0].shape[0]
    canvas = torch.zeros((batch, plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    other = torch.zeros_like(canvas) if parent is not None else None
    parts, rows, kernels, worst, ndiff, nparent = [], [], [], 0, 0, 0
    for p in resampled(plan):
        src = torch.from_numpy(stacks[p.index]).to(dev)
        taps = taps_on(p, plan.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)

        def kernel(src=src, launch=launch):
            launch(src, canvas)

        def plain(src=src, taps=taps, p=p, r0=r0, r1=r1, c0=c0, c1=c1):
            canvas[:, r0:r1, c0:c1] = cuda_resize.resize_place_batch_ref(
                src, p.orientation, *taps)

        old = None if parent is None else parent_call(
            parent, "batch", src, p.orientation, taps, other, r0, c0)
        library = interp_call(src, p.orientation, r1 - r0, c1 - c0,
                              plan.filter)
        disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h,
                                               p.orientation)
        nbytes = batch * (footprint_bytes(
            *(x.cpu().numpy() for x in taps[:2]), disp_h,
            *(x.cpu().numpy() for x in taps[2:]), disp_w, 3)
            + (r1 - r0) * (c1 - c0) * 3)
        t = time_versions(kernel, plain, old, library, bound_ms(nbytes),
                          device_reps=3, reps=5, inner=2)
        del library
        kernel()
        got = canvas[:, r0:r1, c0:c1].clone()
        plain()
        d = (got.int() - canvas[:, r0:r1, c0:c1].int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).any(dim=3).sum())
        if old is not None:
            old()
            nparent += int((other[:, r0:r1, c0:c1] != got).any(dim=3).sum())
        del got, d
        t["bound_ms"] = bound_ms(nbytes)
        t["bytes"] = nbytes
        parts.append(t)
        kernels.append(kernel)
        rows.append(f"#{p.index} {p.raw_w}x{p.raw_h}->{c1 - c0}x{r1 - r0} "
                    f"prepared {t['kernel_ms']:.4f} "
                    f"({_fmt(t['kernel_busy'])}) "
                    f"parent {_fmt(t['parent_ms'])} "
                    f"({_fmt(t['parent_busy'])}) F.interpolate "
                    f"{t['library_ms']:.4f} ({_fmt(t['library_busy'])}) plain "
                    f"{t['plain_ms']:.4f} ({_fmt(t['plain_busy'])}) bound "
                    f"{t['bound_ms']:.4f}")
    check(worst == 0 and ndiff == 0, f"config 5 batched kernel vs plain max "
          f"|diff| {worst}, {ndiff} differing pixels (must be exact)")
    check(nparent == 0, f"config 5: {nparent} pixels unlike the parent body")
    tot = _yardsticks(parts)
    tot["host_us"] = launch_host_us(lambda: [f() for f in kernels],
                                    len(kernels), 10)
    say(f"phase10 batched times at B={batch} (ms per launch; CUDA events, "
        f"median of 5x2 in two rounds plain prepared parent F.interpolate "
        f"and back; in brackets the profiler's device busy time) on {smi}: "
        + " | ".join(rows) + f" | total prepared {tot['kernel_ms']:.4f} "
        f"({_fmt(tot['kernel_busy'])}) parent {_fmt(tot['parent_ms'])} "
        f"({_fmt(tot['parent_busy'])}) F.interpolate "
        f"{tot['library_ms']:.4f} ({_fmt(tot['library_busy'])}) plain "
        f"{tot['plain_ms']:.4f} ({_fmt(tot['plain_busy'])}) bound "
        f"{tot['bound_ms']:.4f} ({tot['bytes']} bytes) | host us a launch "
        f"(10 flushes of {len(kernels)} launches, no synchronise among them) "
        f"prepared {tot['host_us']:.2f} | prepared vs plain max |diff| "
        f"{worst}, differing px {ndiff}, unlike parent {nparent}")
    tot["worst"] = worst
    return tot


REPLACES_WINDOW = "imagestitching_tpu/ops/pallas_resize.py:721"
# BASELINE config 4 (BASELINE.md:36: 9 x 12 MP under a 2 GB budget), with
# the EXIF orientations of config 3 so that five placements resample
ORIENT4 = (1, 6, 3, 8, 1, 5, 2, 7, 4)
CONFIG4 = [(4000, 3000, o) for o in ORIENT4]
CONFIG4_24MP = [(6000, 4000, o) for o in ORIENT4]
# BASELINE config 4 proper: orientation 1, every placement a copy
CONFIG4_PLAIN = [(4000, 3000, 1)] * 9


def _noop(*_):
    pass


def phase12_window_vs_plain(cases, dev, chunk_rows=16) -> int:
    """Kernel #3 against its plain version, bit for bit, over the phase-3
    cases in ``chunk_rows`` chunks, and each case's banded canvas at that
    chunk height against ``cuda_resize.stitch``.  Returns the worst max
    |diff|."""
    import torch
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan
    from imagestitching_tpu_torch.runtime import pipeline

    rng = np.random.default_rng(12)
    worst_all, shifted_all, notes = 0, 0, []
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        imgs = [rng.integers(0, 256, (h, w, c), np.uint8)
                for w, h, _ in shapes]
        worst = ndiff = chunks = shifted = 0
        for p in resampled(plan):
            oriented = geometry.orient_array(imgs[p.index], p.orientation)
            wp = WindowPlan(p, plan.filter, chunk_rows)
            taps = [torch.from_numpy(a).to(dev)
                    for a in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
            ci0, cw = taps[2:]
            region = torch.zeros((wp.chunk, wp.n_cols, c), dtype=torch.uint8,
                                 device=dev)
            once = torch.zeros_like(region)
            launch = cuda_resize.WindowLauncher(
                *taps, once, (wp.crop_rows, wp.disp_w, c))
            for g in range(wp.n_chunks):
                a, valid, s_lo = wp.chunk_window(g)
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
                # the banded rung's form: the placement's taps, the chunk's
                # first row a and crop start s_lo
                launch(crop, a, s_lo, valid)
                d = (once[:valid].int() - ref.int()).abs()
                worst = max(worst, int(d.max()))
                ndiff += int((d > 0).any(dim=2).sum())
                shifted += s_lo > 0
                chunks += 1
        banded, _ = pipeline._run_banded(plan, imgs, c, chunk_rows, "auto",
                                         dev, _noop)
        resident = cuda_resize.stitch(plan, imgs, dev).cpu().numpy()
        check(worst == 0 and ndiff == 0, f"{name}: windowed kernel vs plain "
              f"max |diff| {worst}, {ndiff} differing pixels (must be exact)")
        check(np.array_equal(banded, resident), f"{name}: banded canvas "
              "differs from the resident one")
        shifted_all += shifted
        worst_all = max(worst_all, worst)
        notes.append(f"{name}:{worst}/{ndiff}/{chunks}/{shifted}")
    check(shifted_all > 0, "no chunk with a non-zero crop start")
    say(f"phase12 windowed kernel vs plain in {chunk_rows}-row chunks "
        f"(exact), each chunk from its rebased taps and from the placement's "
        f"taps with its row offset, banded canvas equal to resident: "
        f"{len(cases)} cases max |diff| {worst_all} | "
        f"case:max_diff/differing_px/chunks/chunks_with_offset "
        + " ".join(notes))
    return worst_all


def _config4_job(dev, shapes, seed):
    """(plan, options, raw images, (array, orientation) items) of a
    config-4 job, the pixels made on the card from a seed."""
    import torch
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
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
    from imagestitching_tpu_torch.core import geometry, oracle
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
    from imagestitching_tpu_torch.runtime import tiler
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
        _zero_counts()
        t0 = time.perf_counter()
        out, m = itt.stitch(items, options=opts, config=RuntimeConfig(
            device=str(dev), budget=budget, overlap="never"),
            return_metrics=True)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base
        launched = _launch_counts()
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
        device=str(dev), overlap="never"), return_metrics=True)
    wall24 = time.perf_counter() - t0
    check(m24.strategy == "streamed", f"24 MP job ran {m24.strategy}")
    want24, mr = itt.stitch(items24, options=opts24, config=RuntimeConfig(
        device=str(dev), budget=budget_from_device(str(dev)),
        overlap="never"), return_metrics=True)
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
    from imagestitching_tpu_torch.runtime.logger import StitchLogger, set_logger
    from imagestitching_tpu_torch import RuntimeConfig
    from imagestitching_tpu_torch.config import budget_from_device

    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    src_max = max(a.nbytes for a, _ in items)
    total = torch.cuda.get_device_properties(dev).total_memory
    cfg = RuntimeConfig(device=str(dev), budget=budget_from_device(str(dev)),
                        overlap="never")
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


def phase15_window_times(dev, smi, plan, opts, items, parent,
                         band_rows=256):
    """Kernel #3 over every chunk of config 4's banded job (crops and the
    placements' taps already on the card, launched as the banded rung
    launches it: one prepared ``WindowLauncher`` per placement, per chunk
    its first tap row and crop start): CUDA events and busy time beside the
    parent body (rebased taps per chunk), ``F.interpolate`` over the five
    whole placements and the plain version, the bound, the host time per
    launch, and the prepared chunks bit for bit against the plain
    version's (and the parent's); then a streamed and a banded job under
    torch.profiler.  Returns the summed yardsticks."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.runtime import tiler
    from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan

    chunks, regions, libs, nbytes = [], {}, [], 0
    for p in resampled(plan):
        oriented = geometry.orient_array(items[p.index][0], p.orientation)
        wp = WindowPlan(p, plan.filter, band_rows)
        taps = [torch.from_numpy(x).to(dev)
                for x in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
        region = torch.zeros((wp.chunk, wp.n_cols, 3), dtype=torch.uint8,
                             device=dev)
        regions[p.index] = region
        launch = cuda_resize.WindowLauncher(*taps, region,
                                            (wp.crop_rows, wp.disp_w, 3))
        libs.append(interp_call(torch.from_numpy(np.ascontiguousarray(
            oriented)).to(dev), 1, wp.n_rows, wp.n_cols, plan.filter))
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = torch.from_numpy(wp.stage_crop(oriented, g)).to(dev)
            i0, w = wp.chunk_taps(g)
            rebased = [torch.from_numpy(t).to(dev) for t in (i0, w)]
            nbytes += footprint_bytes(i0, w, wp.crop_rows, wp.ci0, wp.cw,
                                      wp.disp_w, 3) + valid * wp.n_cols * 3
            chunks.append((p.index, launch, crop, a, s_lo, valid, taps,
                           rebased))
    other = {i: torch.zeros_like(r) for i, r in regions.items()}

    def kernel():
        for _, launch, crop, a, s_lo, valid, _, _ in chunks:
            launch(crop, a, s_lo, valid)

    def plain():
        for idx, _, crop, a, s_lo, valid, taps, _ in chunks:
            regions[idx][:valid] = cuda_resize.resize_place_window_ref(
                crop, *taps, a, s_lo, valid)

    def library():
        for f in libs:
            f()

    old = None
    if parent is not None:
        calls = [parent_call(parent, "window", crop, 1,
                             (*rebased, *taps[2:]), other[idx])
                 for idx, _, crop, _, _, _, taps, rebased in chunks]

        def old():
            for f in calls:
                f()

    t = time_versions(kernel, plain, old, library, bound_ms(nbytes),
                      device_reps=3, reps=5, inner=1)
    # host time of a launch: 45 enqueues with the card ahead of the host
    t["host_us"] = launch_host_us(kernel, len(chunks), 5)
    worst = ndiff = nparent = 0
    for idx, launch, crop, a, s_lo, valid, taps, _ in chunks:
        launch(crop, a, s_lo, valid)
        want = cuda_resize.resize_place_window_ref(crop, *taps, a, s_lo,
                                                   valid)
        d = (regions[idx][:valid].int() - want.int()).abs()
        worst = max(worst, int(d.max()))
        ndiff += int((d > 0).any(dim=2).sum())
    if old is not None:
        for (idx, launch, crop, a, s_lo, valid, _, _), f in zip(chunks,
                                                                calls):
            launch(crop, a, s_lo, valid)
            f()
            nparent += int((other[idx][:valid] != regions[idx][:valid])
                           .any(dim=2).sum())
    check(worst == 0 and ndiff == 0, f"config 4 windowed kernel vs plain "
          f"max |diff| {worst}, {ndiff} differing pixels (must be exact)")
    check(nparent == 0, f"config 4: {nparent} pixels unlike the parent body")
    t["bound_ms"] = bound_ms(nbytes)
    t["bytes"] = nbytes
    t["worst"] = worst
    crop0 = chunks[0][2]
    say(f"phase15 windowed times over config 4's {len(chunks)} chunks of "
        f"{band_rows} rows (crop {tuple(crop0.shape)} -> region "
        f"{band_rows}x{regions[chunks[0][0]].shape[1]}x3; ms per job, CUDA "
        f"events median of 5 in two rounds plain prepared parent "
        f"F.interpolate and back; in brackets the profiler's device busy "
        f"time) on {smi}: prepared {t['kernel_ms']:.4f} "
        f"({_fmt(t['kernel_busy'])}) parent {_fmt(t['parent_ms'])} "
        f"({_fmt(t['parent_busy'])}) F.interpolate of the 5 whole "
        f"placements {t['library_ms']:.4f} ({_fmt(t['library_busy'])}) plain "
        f"{t['plain_ms']:.4f} ({_fmt(t['plain_busy'])}) bound "
        f"{t['bound_ms']:.4f} ({nbytes} bytes) | host us a launch (5 jobs "
        f"of {len(chunks)} launches, no synchronise among them) prepared "
        f"{t['host_us']:.2f} | prepared vs plain max |diff| {worst}, "
        f"differing px {ndiff}, unlike parent {nparent}")
    del chunks, regions, other, libs

    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    for strategy, budget in (
            ("streamed", MemoryBudget(
                hbm_bytes=tiler.resident_peak_bytes(plan) - 1)),
            ("banded", MemoryBudget(hbm_bytes=canvas_bytes // 2))):
        cfg = RuntimeConfig(device=str(dev), budget=budget, overlap="never")

        def job(cfg=cfg):
            itt.stitch(items, options=opts, config=cfg)

        busy, wall, by_name = device_ms(job, reps=1)
        groups = {"Memcpy HtoD": 0.0, "resize_place": 0.0,
                  "Memcpy DtoH": 0.0}
        for name, ms in by_name.items():
            key = next((k for k in groups if k in name), "other")
            groups[key] = groups.get(key, 0.0) + ms
        counts = counts_ms(job, reps=1)
        n = {k: sum(v for name, v in counts.items() if k in name)
             for k in ("Memcpy HtoD", "resize_place", "Memcpy DtoH")}
        say(f"phase15 warm {strategy} config-4 job under torch.profiler on "
            f"{smi}: host wall {wall:.4f} ms, device busy {busy:.4f} ms, "
            f"idle (host) share {1 - busy / wall if wall else float('nan'):.4f}"
            " | device ms " + " ".join(f"{k}={v:.4f}"
                                       for k, v in groups.items())
            + " | device activities per job " + " ".join(
                f"{k}={v:g}" for k, v in n.items()))
        if strategy == "banded":
            # one upload per chunk's crop, the taps once per placement (4
            # tensors): no per-chunk tap upload
            n_res = len(resampled(plan))
            n_chunks = int(n["resize_place"])
            check(n["Memcpy HtoD"] <= n_chunks + 4 * n_res,
                  f"banded job: {n['Memcpy HtoD']} uploads for {n_chunks} "
                  f"chunks of {n_res} placements")

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
    return t


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
    from imagestitching_tpu_torch.imgio import codec
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


def _pattern(dev, w, h, seed, noise_levels=64):
    """A photo-like uint8 HWC image made on ``dev`` from a seed: smooth
    gradients with ``noise_levels`` of noise, so its files have a camera's
    sizes rather than incompressible noise's."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    y = torch.arange(h, device=dev, dtype=torch.int32)[:, None, None]
    x = torch.arange(w, device=dev, dtype=torch.int32)[None, :, None]
    c = torch.tensor([3, 5, 7], device=dev, dtype=torch.int32)[None, None]
    noise = torch.randint(0, noise_levels, (h, w, 3), generator=g,
                          device=dev, dtype=torch.int32)
    img = ((x * c + y * (8 - c)) // 16 + seed * 37 + noise) % 256
    return img.to(torch.uint8).cpu().numpy()


def _write_files(td, shapes, dev, seed, ext):
    """One file per (raw width, raw height, EXIF orientation) of ``shapes``
    under ``td``: JPEG (quality 95) with the orientation tag, or PNG
    (orientation 1 only, 2 levels of noise: a screenshot's rather than a
    photo's, which keeps Pillow's encode of 12 MP short); written from 8
    threads.  Returns the paths."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def write(k):
        w, h, o = shapes[k]
        img = Image.fromarray(_pattern(dev, w, h, seed + k,
                                       64 if ext == "jpg" else 2))
        path = os.path.join(td, f"s{seed}-{k}.{ext}")
        if ext == "jpg":
            exif = img.getexif()
            exif[274] = o
            img.save(path, "JPEG", quality=95, exif=exif)
        else:
            check(o == 1, "PNG files carry no orientation here")
            img.save(path, "PNG", compress_level=1)
        return path

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(write, range(len(shapes))))


def _launch_counts():
    from imagestitching_tpu_torch.ops import cuda_resize

    return (cuda_resize.launches, cuda_resize.batch_launches,
            cuda_resize.window_launches)


def _zero_counts():
    from imagestitching_tpu_torch.ops import cuda_resize

    cuda_resize.launches = cuda_resize.batch_launches = 0
    cuda_resize.window_launches = 0


def _times(m):
    return (f"prepare {m.prepare_s:.4f} stage_wait {m.stage_wait_s:.4f} "
            f"(max {m.stage_wait_max_s:.4f}) compute {m.compute_s:.4f} "
            f"readback {m.readback_s:.4f} total {m.total_s:.4f} h2d "
            f"{m.h2d_bytes}")


def phase16_overlapped(dev, smi, td, shapes=CONFIG4):
    """BASELINE config 4 with EXIF orientations as JPEG files through
    ``imagestitching_tpu_torch.stitch(files)``: 9 images, so the default
    ``overlap="auto"`` takes the overlapped scheduler.  Launches counted,
    the canvas equal to ``overlap="never"`` bit for bit and to the oracle
    within 1; a banded budget, and real OOMs at the canvas and in the loop,
    demote to ``overlapped/banded``, equal.  Returns (plan, options, files,
    decoded sources, reference canvas, kernel #1 launches, kernel #3
    launches) of the overlapped path."""
    from concurrent.futures import ThreadPoolExecutor

    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import MemoryBudget, RuntimeConfig
    from imagestitching_tpu_torch import StitchOptions
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.imgio import codec
    from imagestitching_tpu_torch.ops.window import WindowPlan
    from imagestitching_tpu_torch.runtime import tiler
    from imagestitching_tpu_torch.runtime.logger import (StitchLogger,
                                                         set_logger)

    t0 = time.perf_counter()
    files = _write_files(td, shapes, dev, 16, "jpg")
    write_s = time.perf_counter() - t0
    mb = sum(os.path.getsize(f) for f in files) / 1e6
    with ThreadPoolExecutor(8) as pool:
        raws = [r for r, _ in pool.map(codec.decode, files)]
    opts = StitchOptions(direction="vertical", mode="min", gap=4,
                         max_images=None)
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts)
    res = resampled(plan)
    canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
    never = RuntimeConfig(device=str(dev), overlap="never")

    # the pinned staging ring's first allocation (cudaHostAlloc), which the
    # caching host allocator then keeps for every later job
    slot = max(a.nbytes for a in raws)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    ring = [torch.empty(slot, dtype=torch.uint8,
                        pin_memory=dev.type == "cuda") for _ in range(3)]
    pin_s = time.perf_counter() - t0
    del ring

    # the overlapped path, cold, counted from 0
    _zero_counts()
    t0 = time.perf_counter()
    out, m = itt.stitch(files, options=opts, return_metrics=True)
    cold = time.perf_counter() - t0
    launched = _launch_counts()
    check(m.strategy == "overlapped", f"9 JPEG files ran {m.strategy}")
    check(launched == (len(res), 0, 0), f"overlapped launches {launched}, "
          f"expected ({len(res)}, 0, 0)")
    launches_ov = launched[0]
    ref, mn = itt.stitch(files, options=opts, config=never,
                         return_metrics=True)
    check(mn.strategy == "resident", f"overlap=never ran {mn.strategy}")
    check(np.array_equal(out, ref), "overlapped canvas differs from "
          "overlap='never'")
    worst, copy_max = _oracle_spots(plan, raws, out, 256)
    check(worst <= 1 and copy_max == 0, f"overlapped vs oracle {worst}, "
          f"copy spans {copy_max}")
    warm = {"overlapped": [], "never": []}
    for _ in range(3):
        for name, cfg in (("overlapped", None), ("never", never)):
            t0 = time.perf_counter()
            o, mw = itt.stitch(files, options=opts, config=cfg,
                               return_metrics=True)
            warm[name].append((time.perf_counter() - t0, mw))
            check(np.array_equal(o, ref), f"warm {name} canvas differs")
    say(f"phase16 config4-EXIF JPEG files ({len(files)} x "
        f"{shapes[0][0]}x{shapes[0][1]}, {mb:.1f} MB written in "
        f"{write_s:.3f} s; canvas {plan.canvas_w}x{plan.canvas_h}x3 "
        f"{canvas_bytes / 1e6:.1f} MB) via imagestitching_tpu_torch.stitch"
        f"(files): strategy {m.strategy}, launches #1/#2/#3 {launched}, "
        f"equal to overlap='never', oracle spots max |diff| {worst} copy "
        f"spans {copy_max} | cold pinned ring 3 x {slot / 1e6:.1f} MB "
        f"{pin_s * 1e3:.3f} ms | cold job wall {cold:.4f} s ({_times(m)}) "
        f"| {smi}")
    for name, runs in warm.items():
        say(f"phase16 warm {name} (3 jobs) on {smi}: " + " | ".join(
            f"wall {w:.4f} s {_times(mw)} rtt {mw.transport_rtt_s:.6f}"
            for w, mw in runs))

    # a banded budget: the tiler plans banded, the body decodes and keeps
    budget = MemoryBudget(hbm_bytes=canvas_bytes // 2)
    ex = tiler.plan_execution(plan, budget)
    check(ex.strategy == "banded", f"budget {budget.hbm_bytes}: tiler picks "
          f"{ex.strategy}")
    chunks = sum(WindowPlan(p, plan.filter, ex.band_rows).n_chunks
                 for p in res)
    _zero_counts()
    t0 = time.perf_counter()
    outb, mb_ = itt.stitch(files, options=opts, config=RuntimeConfig(
        device=str(dev), budget=budget), return_metrics=True)
    wall_b = time.perf_counter() - t0
    launched_b = _launch_counts()
    check(mb_.strategy == "overlapped/banded", f"banded budget ran "
          f"{mb_.strategy}")
    check(launched_b == (0, 0, chunks), f"overlapped/banded launches "
          f"{launched_b}, expected (0, 0, {chunks})")
    launches_wov = launched_b[2]
    check(np.array_equal(outb, ref), "overlapped/banded canvas differs")
    say(f"phase16 banded budget {budget.hbm_bytes / 1e6:.1f} MB "
        f"({ex.band_rows}-row bands): strategy {mb_.strategy}, launches "
        f"#1/#2/#3 {launched_b}, equal | wall {wall_b:.4f} s "
        f"{_times(mb_)}")

    # real torch.cuda.OutOfMemoryError: a cap below the canvas fails the
    # canvas allocation; a cap just above it fails the first upload
    total = torch.cuda.get_device_properties(dev).total_memory
    log = StitchLogger()
    set_logger(log)
    rows = []
    try:
        for failed, headroom in (("overlapped-alloc", canvas_bytes // 2),
                                 ("overlapped", canvas_bytes + (8 << 20))):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            torch.cuda.set_per_process_memory_fraction(
                (reserved + headroom) / total, dev)
            log.clear()
            t0 = time.perf_counter()
            o, mo = itt.stitch(files, options=opts, return_metrics=True)
            wall = time.perf_counter() - t0
            retries = [e["failed"] for e in log.ring()
                       if e["tag"] == "pipeline.oom_retry"]
            redecoded = [e["n"] for e in log.ring()
                         if e["tag"] == "pipeline.oom_redecode"]
            check(mo.strategy == "overlapped/banded" and retries == [failed],
                  f"cap reserved+{headroom}: ran {mo.strategy} after "
                  f"{retries}, expected overlapped/banded after {failed}")
            check(np.array_equal(o, ref), f"OOM at {failed}: canvas differs")
            rows.append(f"cap reserved+{headroom / 1e6:.1f} MB: "
                        f"{mo.strategy} after oom_retry {retries}, "
                        f"re-decoded {redecoded or [0]}, wall {wall:.4f} s, "
                        "equal")
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, dev)
        set_logger(StitchLogger())
    say("phase16 OOM on real torch.cuda.OutOfMemoryError (default budget): "
        + " | ".join(rows))

    # one warm overlapped job under torch.profiler
    def job():
        itt.stitch(files, options=opts)

    busy, wall, by_name = device_ms(job, reps=1)
    groups = {"Memcpy HtoD": 0.0, "resize_place": 0.0, "Memcpy DtoH": 0.0}
    for name, ms in by_name.items():
        key = next((k for k in groups if k in name), "other")
        groups[key] = groups.get(key, 0.0) + ms
    say(f"phase16 warm overlapped job under torch.profiler on {smi}: host "
        f"wall {wall:.4f} ms, device busy {busy:.4f} ms, idle (host) share "
        f"{1 - busy / wall if wall else float('nan'):.4f} | device ms "
        + " ".join(f"{k}={v:.4f}" for k, v in groups.items()))
    return plan, opts, files, raws, ref, launches_ov, launches_wov


class _Collect:
    """An in-memory band writer: copies each band into one host array."""

    def __init__(self, h, w):
        self.out = np.empty((h, w, 3), np.uint8)
        self.rows = self.writes = 0
        self.closed = False

    def write(self, band):
        self.out[self.rows:self.rows + band.shape[0]] = band
        self.rows += band.shape[0]
        self.writes += 1

    def close(self):
        self.closed = True


def phase17_export(dev, smi, td, plan, opts, files, shapes=CONFIG4_PLAIN):
    """The streaming export: ``_stream_device`` on the overlapped job's
    device canvas into an in-memory writer (always); with the native codec,
    ``stitch_to_file`` PNG and JPEG with the default ``stream="auto"``
    against ``stream=False``; BASELINE config 4 proper as PNG files through
    the pure-copy export, with no device allocation and no launch."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
    from imagestitching_tpu_torch.imgio import codec, native
    from imagestitching_tpu_torch.runtime import export

    canvas, mk = itt.stitch(files, options=opts, keep_on_device=True,
                            return_metrics=True)
    check(isinstance(canvas, torch.Tensor) and canvas.device == dev
          and mk.strategy == "overlapped", f"keep_on_device gave "
          f"{type(canvas).__name__} via {mk.strategy}")
    h, w = plan.canvas_h, plan.canvas_w
    band = export.band_rows_for(w)
    check(h % band != 0, f"band {band} leaves no tail of {h} rows")
    writer = _Collect(h, w)
    phases = {"readback_s": 0.0, "encode_s": 0.0}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    export._stream_device(canvas, writer, h, w, 3, band, phases, _noop)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    whole = canvas.cpu().numpy()
    cpu_s = time.perf_counter() - t0
    check(writer.closed and writer.rows == h, "band writer incomplete")
    check(np.array_equal(writer.out, whole), "bands joined differ from "
          "canvas.cpu()")
    del canvas
    lib = native.get_lib()
    say(f"phase17 _stream_device of the overlapped canvas ({w}x{h}x3, "
        f"{band}-row bands, {writer.writes} bands, tail {h % band} rows) "
        f"into memory: joined equal to canvas.cpu() | readback_s "
        f"{phases['readback_s']:.4f} (CUDA events) copy-out "
        f"{phases['encode_s']:.4f} wall {wall:.4f} s; canvas.cpu() "
        f"{cpu_s:.4f} s | native codec: "
        f"{'loaded ' + os.path.relpath(lib._name, ROOT) if lib else 'not available'}"
        f" | {smi}")

    if lib is not None:
        rows = []
        for ext in ("png", "jpg"):
            s_path = os.path.join(td, f"stream.{ext}")
            m_path = os.path.join(td, f"mono.{ext}")
            ps, ms = itt.stitch_to_file(files, s_path, options=opts,
                                        return_metrics=True)
            pm, mm = itt.stitch_to_file(files, m_path, options=opts,
                                        stream=False, return_metrics=True)
            check(ms.strategy == "overlapped", f"{ext}: {ms.strategy}")
            if ext == "png":
                check(np.array_equal(codec.decode(ps)[0],
                                     codec.decode(pm)[0]),
                      "streamed PNG differs from the monolithic one")
            else:
                check(open(ps, "rb").read() == open(pm, "rb").read(),
                      "streamed JPEG bytes differ from the monolithic ones")
            rows.append(
                f"{ext} {os.path.getsize(ps)} bytes: streamed readback "
                f"{ms.readback_s:.4f} encode {ms.encode_s:.4f} export "
                f"{ms.export_s:.4f} total {ms.total_s:.4f} s | monolithic "
                f"readback {mm.readback_s:.4f} encode {mm.encode_s:.4f} "
                f"total {mm.total_s:.4f} s")
            os.unlink(pm)
            os.unlink(ps)
        # the phase dict of the device branch, on a fresh device canvas
        canvas = itt.stitch(files, options=opts, keep_on_device=True)
        ph = export.stream_to_jpeg(canvas, os.path.join(td, "direct.jpg"))
        check(ph["overlapped"], "device canvas not streamed as overlapped")
        del canvas
        say("phase17 stitch_to_file(stream='auto') of the config4-EXIF "
            "files: PNG decodes equal to stream=False, JPEG bytes equal | "
            + " | ".join(rows) + f" | direct stream_to_jpeg phases "
            f"readback {ph['readback_s']:.4f} encode {ph['encode_s']:.4f} "
            f"wall {ph['wall_s']:.4f} overlapped {ph['overlapped']}")

    # BASELINE config 4 proper: 9 x 12 MP PNG files, orientation 1, to a
    # JPEG (without the native codec the fallback is Pillow's single-thread
    # PNG encoder, whose pass over 324 MB would be most of the script's time)
    t0 = time.perf_counter()
    pngs = _write_files(td, shapes, dev, 40, "png")
    write_s = time.perf_counter() - t0
    opts4 = StitchOptions(direction="vertical", mode="min", gap=4,
                          max_images=None)
    out_path = os.path.join(td, "config4.jpg")
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    path, m = itt.stitch_to_file(pngs, out_path, options=opts4,
                                 return_metrics=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    launched = _launch_counts()
    want, mw = itt.stitch(pngs, options=opts4, config=RuntimeConfig(
        device=str(dev), overlap="never"), return_metrics=True)
    check(mw.strategy == "host-blit", f"config 4 reference {mw.strategy}")
    if lib is not None:
        check(m.strategy == "host-blit-stream", f"config 4 ran {m.strategy}")
        check(peak == 0 and launched == (0, 0, 0), f"config 4 blit stream: "
              f"peak device memory {peak}, launches {launched}")
    mono = codec.encode(os.path.join(td, "config4-mono.jpg"), want)
    check(open(path, "rb").read() == open(mono, "rb").read(), "config 4 "
          "file differs from the host blit's monolithic JPEG")
    say(f"phase17 BASELINE config 4 (9 x {shapes[0][0]}x{shapes[0][1]} "
        f"PNG files written in "
        f"{write_s:.3f} s, canvas {want.shape[1]}x{want.shape[0]}x3) via "
        f"stitch_to_file: strategy {m.strategy}, launches #1/#2/#3 "
        f"{launched}, peak device memory {peak} bytes, JPEG bytes equal to "
        f"the host blit's monolithic encode | wall {wall:.4f} s decode {m.prepare_s:.4f} encode "
        f"{m.encode_s:.4f} export {m.export_s:.4f} s, file "
        f"{os.path.getsize(path)} bytes | {smi}")


def phase18_cli(dev, smi, td, items, opts3):
    """``python -m imagestitching_tpu_torch.cli`` in a subprocess on config
    3 as JPEG files with their EXIF orientations (``--json --metrics``),
    the default engine and then ``--engine torch``: exit 0, the strategy
    named, the PNG decoded equal to phase 4's path (resident, overlap
    never) on the same decoded pixels."""
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig
    from imagestitching_tpu_torch.imgio import codec

    shapes = [(a.shape[1], a.shape[0], o) for a, o in items]
    files = _write_files(td, shapes, dev, 18, "jpg")
    decoded = [(codec.decode(f)[0], o) for f, (_, o) in zip(files, items)]
    want = itt.stitch(decoded, options=opts3, config=RuntimeConfig(
        device=str(dev), overlap="never"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    rows = []
    for flags in ([], ["--engine", "torch", "--device", "cuda"]):
        out = os.path.join(td, f"cli{len(flags)}.png")
        cmd = [sys.executable, "-m", "imagestitching_tpu_torch.cli", *files,
               "-o", out, "--direction", "horizontal", "--mode", "min",
               "--gap", "4", "--json", "--metrics", *flags]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=300)
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"cli {flags}: exit {proc.returncode} "
              f"{proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        m = res["metrics"]
        check(m["strategy"] == "overlapped", f"cli {flags}: strategy "
              f"{m['strategy']}")
        check(np.array_equal(codec.decode(out)[0], want), f"cli {flags}: "
              "output differs from phase 4's path")
        rows.append(f"{' '.join(flags) or 'default'}: exit 0, strategy "
                    f"{m['strategy']}, {res['width']}x{res['height']}, "
                    f"seconds {res['seconds']} (prepare {m['prepare_s']} "
                    f"compute {m['compute_s']} readback {m['readback_s']} "
                    f"encode {m['encode_s']}), process wall {wall:.3f} s")
    say("phase18 cli `python -m imagestitching_tpu_torch.cli` on config 3 "
        "as EXIF JPEG files, --json --metrics, output decoded equal to "
        "phase 4's path on the same pixels | " + " | ".join(rows)
        + f" | {smi}")


# Phone screenshots (phase 19): a 1170-wide capture cut into five
# 2532-row screenshots, consecutive ones sharing 400 rows
SCREENS = (1170, 2532, 5, 400)


def phase19_merge(dev, smi, screens=SCREENS):
    """``merge_overlap`` on the card: five synthetic phone screenshots,
    orientation 1, vertical.  Every pair's float64 scores on the card
    against ``_scores_numpy`` (1e-9), the trims against the numpy scorer's
    and the cut, the merged canvas of ``stitch(..., merge_overlap=True)``
    against the stitch of the pre-trimmed arrays and the capture (bit for
    bit), and one job through ``StitchServer.submit``.  Returns the kernel
    #1 launches of the merged stitch."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
    from imagestitching_tpu_torch.ops import overlap
    from imagestitching_tpu_torch.serve.server import StitchServer

    w, h, n, shared = screens
    base = _pattern(dev, w, h + (n - 1) * (h - shared), 19)
    shots = [base[k * (h - shared):k * (h - shared) + h] for k in range(n)]
    cfg = RuntimeConfig(device=str(dev))
    # the scores detect_pair hands the exact verify, pair by pair
    worst, t_card, t_numpy = 0.0, 0.0, 0.0
    for a, b in zip(shots, shots[1:]):
        o_max = min(int(0.5 * min(len(a), len(b))), len(b) - 1, len(a))
        region, template = a[len(a) - o_max:], b[:32]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = overlap._scores(region, template, dev)
        t_card += time.perf_counter() - t0
        t0 = time.perf_counter()
        want = overlap._scores_numpy(region, template)
        t_numpy += time.perf_counter() - t0
        worst = max(worst, float(np.abs(got - want).max()))
    check(worst <= 1e-9, f"card scores vs _scores_numpy max |diff| {worst}")
    t0 = time.perf_counter()
    trims = overlap.detect_trims(shots, "vertical", device=dev)
    detect_s = time.perf_counter() - t0
    want_trims = [0] + [shared] * (n - 1)
    check(trims == want_trims == overlap.detect_trims(shots, "vertical",
                                                      device=False),
          f"trims {trims}, expected {want_trims} and the numpy scorer's")

    opts = StitchOptions(direction="vertical", mode="min", gap=0,
                         merge_overlap=True)
    _zero_counts()
    t0 = time.perf_counter()
    out, m = itt.stitch(shots, options=opts, config=cfg, return_metrics=True)
    wall = time.perf_counter() - t0
    launched = _launch_counts()
    pre = [shots[0]] + [s[shared:] for s in shots[1:]]
    want = itt.stitch(pre, options=StitchOptions(direction="vertical",
                                                 mode="min", gap=0),
                      config=cfg)
    check(np.array_equal(out, want), "merged canvas differs from the stitch "
          "of the pre-trimmed screenshots")
    check(np.array_equal(out, base), "merged canvas differs from the capture")
    with StitchServer(config=cfg, max_wait_s=0.001) as srv:
        t0 = time.perf_counter()
        served = srv.submit(shots, opts).result(timeout=120)
        served_s = time.perf_counter() - t0
    check(np.array_equal(served, out), "served merge differs")
    say(f"phase19 merge_overlap: {n} screenshots {w}x{h} sharing {shared} "
        f"rows (capture {w}x{base.shape[0]}), vertical | card float64 scores "
        f"vs _scores_numpy max |diff| {worst:.3e} over {n - 1} pairs (card "
        f"{t_card:.4f} s, numpy {t_numpy:.4f} s) | trims {trims} equal to "
        f"the numpy scorer's, detect_trims on the card {detect_s:.4f} s | "
        f"stitch(merge_overlap=True) on cuda: strategy {m.strategy}, "
        f"launches #1/#2/#3 {launched}, canvas equal to the pre-trimmed "
        f"stitch and the capture, wall {wall:.4f} s | StitchServer.submit "
        f"equal, {served_s:.4f} s | {smi}")
    return launched[0]


def phase20_grid(dev, smi, shapes=CONFIG4):
    """The grid collage on the card: config 4-EXIF's nine sources through
    ``stitch_grid(cols=3, mode="min", gap=4)`` on ``cuda``, launches of #1
    counted per column (one per resampled placement), the canvas within 1
    of the oracle of each column's plan around every placement edge and
    exact on copy spans; then ``valign="center"``, equal column by column.
    Returns (items, kernel #1 launches of the top-aligned grid)."""
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.core.grid import plan_grid
    from imagestitching_tpu_torch.core.layout import ImageSpec
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.runtime import pipeline

    _, _, imgs, items = _config4_job(dev, shapes, 20)
    opts = StitchOptions(direction="vertical", mode="min", gap=4,
                         max_images=None)
    disp = [geometry.orient_array(a, o) for a, o in items]
    gplan = plan_grid([ImageSpec(a.shape[1], a.shape[0]) for a in disp], 3,
                      opts)
    cfg = RuntimeConfig(device=str(dev))
    real_run, per_col = pipeline.run, []

    def counted(*a, **k):
        before = cuda_resize.launches
        out = real_run(*a, **k)
        per_col.append(cuda_resize.launches - before)
        return out

    pipeline.run = counted
    try:
        rows, canvases, launches_grid = [], {}, None
        for valign in ("top", "center"):
            per_col.clear()
            _zero_counts()
            t0 = time.perf_counter()
            out, m = itt.stitch_grid(items, cols=3, options=opts, config=cfg,
                                     valign=valign, return_metrics=True)
            wall = time.perf_counter() - t0
            launched = _launch_counts()
            expect = [len(resampled(p)) for p in gplan.col_plans]
            check(per_col == expect and launched == (sum(expect), 0, 0),
                  f"grid {valign}: launches per column {per_col} "
                  f"({launched}), expected {expect}")
            check(out.shape == (gplan.canvas_h, gplan.canvas_w, 3),
                  f"grid canvas {out.shape}")
            canvases[valign] = out
            rows.append(f"valign {valign}: strategy {m.strategy}, launches "
                        f"#1 per column {per_col} (#1/#2/#3 {launched}), "
                        f"wall {wall:.4f} s (prepare {m.prepare_s:.4f} "
                        f"compute {m.compute_s:.4f} readback "
                        f"{m.readback_s:.4f}, h2d {m.h2d_bytes})")
            if launches_grid is None:
                launches_grid = launched[0]
    finally:
        pipeline.run = real_run
    gap_px = int(np.floor(gplan.gap + 0.5))
    worst = copy_max = 0
    x = 0
    for idx, plan in zip(gplan.columns, gplan.col_plans):
        col = canvases["top"][:plan.canvas_h, x:x + plan.canvas_w]
        w_, c_ = _oracle_spots(plan, [disp[i] for i in idx], col, 256)
        worst, copy_max = max(worst, w_), max(copy_max, c_)
        y = (gplan.canvas_h - plan.canvas_h) // 2
        check(np.array_equal(
            canvases["center"][y:y + plan.canvas_h, x:x + plan.canvas_w],
            col), "valign center: a column differs from the top-aligned one")
        x += gplan.col_width + gap_px
    check(worst <= 1 and copy_max == 0, f"grid vs oracle {worst}, copy "
          f"spans {copy_max}")
    say(f"phase20 stitch_grid on cuda: config4-EXIF sources (9 x "
        f"{shapes[0][0]}x{shapes[0][1]}), cols 3, mode min, gap 4, canvas "
        f"{gplan.canvas_w}x{gplan.canvas_h}x3, columns {list(gplan.columns)} "
        f"| " + " | ".join(rows) + f" | oracle spots per column max |diff| "
        f"{worst} copy spans {copy_max} | {smi}")
    return items, launches_grid


def phase21_preview(dev, smi, items, box_w=750):
    """The preview on the card: the config 4-EXIF canvas kept on the card
    (``keep_on_device=True``), ``make_preview(box_w=750)``: exactly one
    launch of #1, equal bit for bit to the plain version on the card,
    within 1 of ``make_preview(device=False)``; CUDA-event and busy times
    beside the plain version, one ``F.interpolate`` call and the bound.
    Returns (launches, the yardsticks)."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig, StitchOptions
    from imagestitching_tpu_torch.core import geometry
    from imagestitching_tpu_torch.ops import cuda_resize

    opts = StitchOptions(direction="vertical", mode="min", gap=4,
                         max_images=None)
    canvas, mk = itt.stitch(items, options=opts, config=RuntimeConfig(
        device=str(dev), overlap="never"), keep_on_device=True,
        return_metrics=True)
    check(isinstance(canvas, torch.Tensor) and canvas.device == dev,
          f"keep_on_device gave {type(canvas).__name__} via {mk.strategy}")
    h, w, c = canvas.shape
    pw, ph = itt.preview_size(w, h, box_w)
    torch.cuda.synchronize(dev)
    _zero_counts()
    t0 = time.perf_counter()
    prev = itt.make_preview(canvas, box_w)
    wall = time.perf_counter() - t0
    launched = _launch_counts()
    check(launched == (1, 0, 0), f"preview launches {launched}, expected "
          "(1, 0, 0)")
    check(prev.shape == (ph, pw, c), f"preview {prev.shape}")

    ri0, rw = geometry.filter_taps(0, ph, 0.0, float(ph), h, "bilinear")
    ci0, cw = geometry.filter_taps(0, pw, 0.0, float(pw), w, "bilinear")
    taps = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (ri0, rw.astype(np.float32), ci0, cw.astype(np.float32))]
    plain_out = cuda_resize.resize_place_ref(canvas, 1, *taps).cpu().numpy()
    d = int(np.abs(plain_out.astype(np.int16) - prev).max())
    check(d == 0, f"preview kernel vs plain max |diff| {d} (must be exact)")
    t0 = time.perf_counter()
    host = itt.make_preview(canvas, box_w, device=False)
    host_s = time.perf_counter() - t0
    dh = int(np.abs(host.astype(np.int16) - prev).max())
    check(dh <= 1, f"preview vs make_preview(device=False) {dh}")

    out = torch.empty((ph, pw, c), dtype=torch.uint8, device=dev)

    def kernel():
        cuda_resize.resize_place(canvas, 1, *taps, out, 0, 0)

    def plain():
        out[:] = cuda_resize.resize_place_ref(canvas, 1, *taps)

    nbytes = footprint_bytes(ri0, rw, h, ci0, cw, w, c) + ph * pw * c
    t = time_versions(kernel, plain, None, interp_call(canvas, 1, ph, pw,
                                                       "bilinear"),
                      bound_ms(nbytes), reps=10, inner=5, device_reps=10)
    t["bound_ms"] = bound_ms(nbytes)
    t["worst"] = d
    say(f"phase21 make_preview(box_w={box_w}) of the config4-EXIF canvas on "
        f"the card ({w}x{h}x{c}, {canvas.numel() / 1e6:.1f} MB, "
        f"keep_on_device via {mk.strategy}) -> {pw}x{ph}: launches #1/#2/#3 "
        f"{launched}, kernel vs plain max |diff| {d}, vs device=False "
        f"{dh} ({host_s:.4f} s on the host), wall {wall * 1e3:.4f} ms | ms "
        f"per launch (CUDA events, median of 10x5 in two rounds; profiler "
        f"busy in brackets): kernel {t['kernel_ms']:.4f} "
        f"({_fmt(t['kernel_busy'])}) F.interpolate {t['library_ms']:.4f} "
        f"({_fmt(t['library_busy'])}) plain {t['plain_ms']:.4f} "
        f"({_fmt(t['plain_busy'])}) bound {t['bound_ms']:.4f} ({nbytes} bytes "
        f"at 3.35 TB/s) | {smi}")
    return launched[0], t


def _band_pairs(plan, n):
    """The (band, resampled placement) pairs of an n-way space mesh that
    meet: kernel #3's launches in one space-sharded job, from the plan."""
    band = -(-plan.canvas_h // n)
    return [(k, p) for p in resampled(plan) for k in range(n)
            if max(p.row_span[0], k * band) < min(p.row_span[1],
                                                   (k + 1) * band)]


def phase22_space_sharded(dev, smi, plan, opts, imgs, items, ref):
    """Config 4-EXIF from arrays on a (1, 4) space mesh of ``cuda:0`` four
    times, through ``imagestitching_tpu_torch.stitch`` at the default
    budget: ``space-sharded``, equal to phase 13's resident canvas bit for
    bit, oracle spots within 1 (band seams, chunk boundaries, edges), copy
    spans exact, kernel #3 launched once per (band, resampled placement)
    pair; a (1, 2) mesh rejected by the budget gate; a real OOM inside the
    sharded compose demoted to the single-card ladder.  Then #3's times at
    one band window, the per-device peak beside the estimate and the wall
    split into upload, compose and gather.  Returns (launches of #3, the
    yardsticks)."""
    import torch
    import imagestitching_tpu_torch as itt
    from imagestitching_tpu_torch import RuntimeConfig
    from imagestitching_tpu_torch.config import budget_from_device
    from imagestitching_tpu_torch.core import geometry, oracle
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.ops.window import WindowPlan
    from imagestitching_tpu_torch.parallel.mesh import make_mesh
    from imagestitching_tpu_torch.parallel.sharding import ShardedStitch
    from imagestitching_tpu_torch.runtime import tiler
    from imagestitching_tpu_torch.runtime.logger import (StitchLogger,
                                                         set_logger)

    n = 4
    mesh4 = make_mesh((1, n), devices=[str(dev)] * n)
    mesh2 = make_mesh((1, 2), devices=[str(dev)] * 2)
    est4 = tiler.sharded_peak_bytes(plan, n, 3)
    est2 = tiler.sharded_peak_bytes(plan, 2, 3)
    cfg = RuntimeConfig(device=str(dev), overlap="never", mesh=mesh4)
    check(est4 <= cfg.budget.hbm_bytes < est2, f"estimates (1, 4) {est4}, "
          f"(1, 2) {est2} bytes against the budget {cfg.budget.hbm_bytes}")
    pairs = _band_pairs(plan, n)
    log = StitchLogger()
    set_logger(log)
    try:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        t0 = time.perf_counter()
        out, m = itt.stitch(items, options=opts, config=cfg,
                            return_metrics=True)
        wall = time.perf_counter() - t0
        launched = _launch_counts()
        peak = torch.cuda.max_memory_allocated(dev) - base
        check(m.strategy == "space-sharded", f"(1, 4) mesh ran {m.strategy}")
        check(launched == (0, 0, len(pairs)), f"space-sharded launches "
              f"{launched}, expected (0, 0, {len(pairs)})")
        check(np.array_equal(out, ref), "space-sharded canvas differs from "
              "the resident one")
        band = -(-plan.canvas_h // n)
        worst = 0
        for lo in [k * band for k in range(1, n)] + [
                e for p in resampled(plan) for e in p.row_span]:
            want = oracle.stitch_rows(plan, imgs, max(0, lo - 2), lo + 2)
            lo = max(0, lo - 2)
            worst = max(worst, int(np.abs(
                out[lo:lo + want.shape[0]].astype(np.int16)
                - want.astype(np.int16)).max()))
        worst_c, copy_max = _oracle_spots(plan, imgs, out, 256)
        worst = max(worst, worst_c)
        check(worst <= 1 and copy_max == 0, f"space-sharded vs oracle "
              f"{worst}, copy spans {copy_max}")

        # the gate: (1, 2) estimates over the budget -> the ladder
        log.clear()
        out2, m2 = itt.stitch(items, options=opts, config=RuntimeConfig(
            device=str(dev), overlap="never", mesh=mesh2),
            return_metrics=True)
        rejects = [e for e in log.ring()
                   if e["tag"] == "pipeline.sharded_budget_reject"]
        check(len(rejects) == 1 and m2.strategy == "resident",
              f"(1, 2) mesh: {m2.strategy}, rejects {rejects}")
        check(np.array_equal(out2, ref), "(1, 2) mesh canvas differs")
        del out2

        # a real OOM inside the sharded compose: a cap the estimate does
        # not see (it fits the budget) under the sources plus the bands
        canvas_bytes = 3 * plan.canvas_w * plan.canvas_h
        src_max = max(a.nbytes for a in imgs)
        total = torch.cuda.get_device_properties(dev).total_memory
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        headroom = canvas_bytes + 3 * src_max
        torch.cuda.set_per_process_memory_fraction(
            (reserved + headroom) / total, dev)
        log.clear()
        try:
            t0 = time.perf_counter()
            out3, m3 = itt.stitch(items, options=opts, config=RuntimeConfig(
                device=str(dev), overlap="never", mesh=mesh4,
                budget=budget_from_device(str(dev))), return_metrics=True)
            wall3 = time.perf_counter() - t0
        finally:
            torch.cuda.set_per_process_memory_fraction(1.0, dev)
        retries = [e["failed"] for e in log.ring()
                   if e["tag"] == "pipeline.oom_retry"]
        check(retries[:1] == ["space-sharded"] and m3.strategy != "space-"
              "sharded", f"capped: {m3.strategy} after {retries}")
        check(np.array_equal(out3, ref), f"{m3.strategy} after the sharded "
              "OOM differs from the resident canvas")
        del out3
    finally:
        set_logger(StitchLogger())

    # the wall split of a warm sharded job, and #3 at one band window
    ss = ShardedStitch(plan, mesh4)
    check(np.array_equal(ss([a for a, _ in items]), ref), "ShardedStitch "
          "differs from the resident canvas")
    split = ss.split
    k, p = pairs[0]
    r0, r1 = p.row_span
    wp = WindowPlan(p, plan.filter, windows=[
        (max(r0, lo) - r0, min(r1, lo + band) - r0)
        if max(r0, lo) < min(r1, lo + band) else (0, 0)
        for lo in range(0, n * band, band)])
    a, valid, s_lo = wp.chunk_window(k)
    oriented = torch.from_numpy(np.ascontiguousarray(geometry.orient_array(
        imgs[p.index], p.orientation))).to(dev)
    crop = oriented[s_lo:s_lo + wp.crop_rows]
    taps = taps_on(p, plan.filter, dev)
    region = torch.empty((valid, wp.n_cols, 3), dtype=torch.uint8,
                         device=dev)
    launch = cuda_resize.WindowLauncher(*taps, region,
                                        (wp.crop_rows, wp.disp_w, 3))

    def kernel():
        launch(crop, a, s_lo, valid)

    def plain():
        region[:] = cuda_resize.resize_place_window_ref(crop, *taps, a, s_lo,
                                                        valid)

    kernel()
    d = int((region.int() - cuda_resize.resize_place_window_ref(
        crop, *taps, a, s_lo, valid).int()).abs().max())
    check(d == 0, f"#3 at the band window vs plain max |diff| {d}")
    i0, w = wp.ri0[a:a + valid] - s_lo, wp.rw[a:a + valid]
    nbytes = (footprint_bytes(i0, w, wp.crop_rows, wp.ci0, wp.cw, wp.disp_w,
                              3) + valid * wp.n_cols * 3)
    t = time_versions(kernel, plain, None,
                      interp_call(crop, 1, valid, wp.n_cols, plan.filter),
                      bound_ms(nbytes), reps=10, inner=5, device_reps=10)
    t["bound_ms"] = bound_ms(nbytes)
    t["worst"] = d
    say(f"phase22 config4-EXIF space-sharded on a (1, {n}) mesh of {dev} x "
        f"{n} (one card: the shards share it; bits, launches and memory, not "
        f"multi-card speed), default budget: strategy {m.strategy}, "
        f"launches #1/#2/#3 {launched} ({len(pairs)} (band, resampled "
        f"placement) pairs, band {band} rows), equal to phase 13's resident "
        f"canvas, oracle spots max |diff| {worst} copy spans {copy_max} | "
        f"wall {wall:.4f} s compute {m.compute_s:.4f} s h2d {m.h2d_bytes} | "
        f"per-device peak {peak / 1e6:.1f} MB, estimate (1, 4) "
        f"{est4 / 1e6:.1f} MB, (1, 2) {est2 / 1e6:.1f} MB, budget "
        f"{cfg.budget.hbm_bytes / 1e6:.1f} MB | (1, 2): "
        f"pipeline.sharded_budget_reject -> {m2.strategy}, equal | cap "
        f"reserved+{headroom / 1e6:.1f} MB: oom_retry {retries} -> "
        f"{m3.strategy} in {wall3:.4f} s, equal | ShardedStitch warm split "
        f"upload {split['upload_s']:.4f} s compose {split['compose_s']:.4f} "
        f"s gather {split['gather_s']:.4f} s | {smi}")
    say(f"phase22 #3 at band {k}'s window of placement {p.index} (crop "
        f"{tuple(crop.shape)} -> region {valid}x{wp.n_cols}x3; ms per launch, "
        f"CUDA events median of 10x5 in two rounds; profiler busy in "
        f"brackets): kernel {t['kernel_ms']:.4f} ({_fmt(t['kernel_busy'])}) "
        f"F.interpolate {t['library_ms']:.4f} ({_fmt(t['library_busy'])}) "
        f"plain {t['plain_ms']:.4f} ({_fmt(t['plain_busy'])}) bound "
        f"{t['bound_ms']:.4f} ({nbytes} bytes at 3.35 TB/s) | max |diff| {d} "
        f"| {smi}")
    return launched[2], t


def phase23_jobs_mesh(dev, smi, plan, stacks, items3, opts3):
    """Config 5's 64 jobs on a (4, 1) jobs mesh of ``cuda:0`` four times:
    4 x 16 jobs, one launch of #2 per resampled placement per shard, equal
    bit for bit to the single-card batch; a batch of 62 refused as not
    divisible; ``StitchServer(use_mesh=True)`` on a mesh of every card
    serving config 3 jobs equal to the plain server's.  Returns the
    launches of #2 on the mesh."""
    import torch
    from imagestitching_tpu_torch import RuntimeConfig, StitchServer
    from imagestitching_tpu_torch.ops import cuda_resize
    from imagestitching_tpu_torch.parallel.batch import BatchedStitch
    from imagestitching_tpu_torch.parallel.mesh import make_mesh

    batch = stacks[0].shape[0]
    n_res = len(resampled(plan))
    mesh = make_mesh((4, 1), devices=[str(dev)] * 4)
    t0 = time.perf_counter()
    single = BatchedStitch(plan, batch, device=dev)(stacks)
    wall1 = time.perf_counter() - t0
    bs = BatchedStitch(plan, batch, mesh=mesh)
    torch.cuda.synchronize(dev)
    _zero_counts()
    t0 = time.perf_counter()
    got = bs(stacks)
    wall4 = time.perf_counter() - t0
    launched = _launch_counts()
    check(launched == (0, 4 * n_res, 0), f"jobs mesh launches {launched}, "
          f"expected (0, {4 * n_res}, 0)")
    check(np.array_equal(got, single), "jobs mesh batch differs from the "
          "single-card batch")
    del got, single
    try:
        BatchedStitch(plan, batch - 2, mesh=mesh)
        fail(f"a batch of {batch - 2} over 4 jobs rows was accepted")
    except ValueError as e:
        check("divisible" in str(e), f"batch of {batch - 2}: {e}")

    rng = np.random.default_rng(23)
    jobs = [[(rng.integers(0, 256, a.shape, np.uint8), o) for a, o in items3]
            for _ in range(4)]
    outs = {}
    for use_mesh in (True, False):
        with StitchServer(max_batch=4, max_wait_s=1.0, use_mesh=use_mesh,
                          config=RuntimeConfig(device=str(dev))) as server:
            if use_mesh:
                unit = server.mesh.shape["jobs"]
                check(unit == torch.cuda.device_count(), f"use_mesh: jobs "
                      f"{unit}, cards {torch.cuda.device_count()}")
            futs = [server.submit([a for a, _ in job], opts3,
                                  orientations=[o for _, o in job])
                    for job in jobs]
            outs[use_mesh] = [f.result(timeout=300) for f in futs]
    check(all(np.array_equal(x, y) for x, y in zip(outs[True], outs[False])),
          "use_mesh server differs from the plain server")

    say(f"phase23 config5 jobs mesh ({batch} jobs on a (4, 1) mesh of {dev} "
        f"x 4; one card: bits and launches, not multi-card speed): launches "
        f"#1/#2/#3 {launched} ({n_res} resampled placements x 4 shards of "
        f"{batch // 4}), equal to the single-card batch | wall mesh "
        f"{wall4:.4f} s, single card {wall1:.4f} s | batch of {batch - 2}: "
        f"ValueError (divisible) | StitchServer(use_mesh=True): jobs axis "
        f"{unit} (every card), {len(jobs)} config 3 jobs equal to the plain "
        f"server's | {smi}")
    return launched[1]


def phase24_staged(dev, smi, cases, parent=None):
    """Kernel #4, config 5's slot 0 from a ring of staged source bands,
    against its plain version bit for bit with the bands as uint8 and as
    bf16: on slot 0 at the default grid, at one CTA an SM and at 72, 5 and
    1 CTAs (each walks 4 or 5, 8, about 115 or all of the 576 tiles, so the
    ring wraps), on
    phase 3's sources oriented on the card at 5 CTAs (one channel; odd
    widths, whose pitch is padded; a placement no tile fits is refused by
    the schedule), and against #1 on slot 0.  Then the main path: the
    profiler's ``run`` in this process with the counts set to 0 (#4's
    launches), and ``python -m imagestitching_tpu_torch.tools.
    profile_bf16_stage`` in a subprocess, which must exit 0.  Last, CUDA-
    event and busy times on slot 0 of both band dtypes' prepared calls,
    each launch reading the next of enough source copies to exceed the L2
    cache, beside the bound, one ``F.interpolate`` call, #1, the plain
    version and (``parent``, the library of a previous
    ``resize_place_staged.cu``) the previous body, checked equal, and of the
    prepared call at one CTA an SM; and the
    host microseconds a launch takes: the prepared call, the one-shot
    wrapper and the previous body's one-shot call.  Returns the record's
    numbers."""
    import itertools

    import torch
    import torch.nn.functional as F
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.ops import (cuda_resize, staged_resize,
                                              torch_compose)
    from imagestitching_tpu_torch.tools import profile_bf16_stage

    dtypes = {"uint8": torch.uint8, "bf16": torch.bfloat16}
    plan5, p = profile_bf16_stage.slot0()
    rng = np.random.default_rng(24)
    src = src_on(rng.integers(0, 256, (p.raw_h, p.raw_w, 3), np.uint8), dev)
    taps = taps_on(p, plan5.filter, dev)
    n_rows, n_cols = taps[0].shape[0], taps[2].shape[0]
    sched = staged_resize.staged_schedule(taps[0], taps[2], 2, 2, p.raw_h,
                                          p.raw_w, 3)
    tiles = sched.grid[0] * sched.grid[1]

    def versus(s, t, dt, ctas):
        """#4 into a random canvas at (2, 1) against the plain version: max
        |diff| and differing pixels, in the region and outside it."""
        band = staged_resize.stage_source(s, dt)
        nr, nc = t[0].shape[0], t[2].shape[0]
        canvas = torch.randint(0, 256, (nr + 4, nc + 3, s.shape[2]),
                               dtype=torch.uint8, device=dev)
        before = canvas.clone()
        staged_resize.resize_place_staged(band, *t, canvas, 2, 1, ctas=ctas)
        want = staged_resize.resize_place_staged_ref(band, *t)
        d = (canvas[2:2 + nr, 1:1 + nc].int() - want.int()).abs()
        canvas[2:2 + nr, 1:1 + nc] = before[2:2 + nr, 1:1 + nc]
        return (int(d.max()), int((d > 0).any(dim=2).sum())
                + int((canvas != before).any(dim=2).sum()))

    worst, ndiff, checked, refused, odd = 0, 0, 0, [], 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    runs = [(src, taps, ctas) for ctas in (0, sms, 72, 5, 1)]
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        for q in resampled(plan):
            raw = rng.integers(0, 256, (q.raw_h, q.raw_w, c), np.uint8)
            s_ = torch_compose.orient(src_on(raw, dev),
                                      q.orientation).contiguous()
            t_ = taps_on(q, plan.filter, dev)
            try:
                staged_resize.staged_schedule(t_[0], t_[2], t_[1].shape[1],
                                              t_[3].shape[1], *s_.shape)
            except ValueError:
                refused.append(f"{name}#{q.index}")
                continue
            odd += s_.shape[1] % 16 != 0
            runs.append((s_, t_, 5))
    for s_, t_, ctas in runs:
        for dt in dtypes.values():
            w_, n_ = versus(s_, t_, dt, ctas)
            worst, ndiff, checked = max(worst, w_), ndiff + n_, checked + 1
    del runs
    check(worst == 0 and ndiff == 0, f"#4 vs plain max |diff| {worst}, "
          f"{ndiff} differing pixels (must be exact)")
    check(refused == ["lanczos3-k97#0"], f"#4 refused {refused}")
    check(odd > 0, "no oriented source with an odd width")
    one = torch.zeros((n_rows, n_cols, 3), dtype=torch.uint8, device=dev)
    cuda_resize.resize_place(src, 1, *taps, one, 0, 0)
    for dt in dtypes.values():
        got = torch.zeros_like(one)
        staged_resize.resize_place_staged(staged_resize.stage_source(src, dt),
                                          *taps, got, 0, 0)
        check(torch.equal(got, one), f"#4 ({dt}) differs from #1 on slot 0")

    # the main path: the profiler, in this process, then as python -m
    _zero_counts()
    staged_resize.staged_launches = 0
    lines = []
    rec = profile_bf16_stage.run(reps=50, rounds=3, out=lines.append)
    launched = (*_launch_counts(), staged_resize.staged_launches)
    check(rec["ok"], f"profiler parity {rec['parity']}")
    check(launched == (1, 0, 0, rec["launches"]) and launched[3] > 0,
          f"profiler launches #1/#2/#3/#4 {launched}, its record "
          f"{rec.get('launches')}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.tools."
         "profile_bf16_stage", "--reps", "10", "--rounds", "2"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"profile_bf16_stage exited "
          f"{proc.returncode}: {proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    check(sub["ok"] and sub["launches"] > 0, f"profiler subprocess {sub}")

    # times on slot 0: kernel #4's prepared call per band dtype beside the
    # plain version, F.interpolate, #1, the previous body and the bound
    l2 = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size",
                 50 * 2 ** 20)
    slot = torch.empty((n_rows, n_cols, 3), dtype=torch.uint8, device=dev)
    other = torch.empty_like(slot)

    def rotate(fn, items):
        it = itertools.cycle(items)
        return lambda: fn(next(it))

    old = None if parent is None else parent_staged_call(
        parent, taps, p.raw_h, p.raw_w, other)
    t, nparent = {}, 0
    for key, dt in dtypes.items():
        n = l2 // (src.numel() * (2 if key == "bf16" else 1)) + 1
        bands = [staged_resize.stage_source(src, dt) for _ in range(n)]
        nbytes = staged_resize.moved_bytes(src.shape, n_rows, n_cols, dt)
        launch = staged_resize.StagedLaunch(bands[0], *taps, slot, 0, 0,
                                            schedule=sched)
        if old is not None:
            launch(bands[0])
            old(bands[0])
            nparent += int((slot != other).any(dim=2).sum())
        library = None
        if key == "uint8":
            xs = [src.permute(2, 0, 1)[None].float().contiguous()
                  for _ in range(3)]
            library = rotate(lambda x: F.interpolate(
                x, size=(n_rows, n_cols), mode="bilinear",
                align_corners=False), xs)
        t[key] = time_versions(
            rotate(launch, bands),
            lambda b=bands[0]: slot.copy_(
                staged_resize.resize_place_staged_ref(b, *taps)),
            None if old is None else rotate(old, bands), library,
            bound_ms(nbytes), reps=10, inner=5, device_reps=10)
        hosts = {"host_us": rotate(launch, bands),
                 "oneshot_host_us": rotate(
                     lambda b: staged_resize.resize_place_staged(
                         b, *taps, slot, 0, 0, schedule=sched), bands),
                 "parent_host_us": None if old is None else rotate(old,
                                                                   bands)}
        t[key].update({k: None if f is None else
                       profile_bf16_stage.host_us(f, 200)
                       for k, f in hosts.items()})
        # the grid the tile picker does not plan for: one CTA an SM, each
        # walking 4 or 5 tiles, so that the ring overlaps
        walk = staged_resize.StagedLaunch(bands[0], *taps, slot, 0, 0,
                                          schedule=sched, ctas=sms)
        one_an_sm = time_versions(rotate(walk, bands), None, None, None,
                                  bound_ms(nbytes), reps=10, inner=5,
                                  device_reps=10)
        t[key].update(one_an_sm_ms=one_an_sm["kernel_ms"],
                      one_an_sm_busy=one_an_sm["kernel_busy"])
        t[key].update(bound_ms=bound_ms(nbytes), bytes=nbytes, copies=n,
                      ctas=launch.args.grid,
                      smem_bytes=launch.args.smem_bytes)
        del bands, library, launch, walk
    check(nparent == 0, f"#4: {nparent} pixels unlike the previous body")
    raws = [src.clone() for _ in range(t["uint8"]["copies"])]
    t1 = time_versions(rotate(lambda s_: cuda_resize.resize_place(
        s_, 1, *taps, slot, 0, 0), raws), None, None, None,
        t["uint8"]["bound_ms"], reps=10, inner=5, device_reps=10)
    del raws
    u8, bf = t["uint8"], t["bf16"]
    t["uint8"]["worst"] = worst
    say(f"phase24 #4 vs plain (exact), uint8 and bf16 bands: {checked} "
        f"launches (slot 0 at {sched.grid} = {tiles} tiles of "
        f"{sched.tile_r}x{sched.tile_c} from {sched.band_h}x{sched.band_w} "
        f"bands on the default grid ({u8['ctas']} CTAs uint8, {bf['ctas']} "
        f"bf16; shared memory {u8['smem_bytes']} / {bf['smem_bytes']} "
        f"bytes), {sms}, 72, 5 and 1 CTAs; phase 3's sources oriented on "
        f"the card "
        f"at 5 CTAs, {odd} of odd width) max |diff| {worst}, differing px "
        f"{ndiff}; refused by the schedule: {', '.join(refused)} | slot 0 "
        f"equal to #1 in both dtypes"
        + ("" if old is None else " and to the previous body (0 px)"))
    say(f"phase24 main path: profile_bf16_stage.run in this process, "
        f"launches #1/#2/#3/#4 {launched} | " + " | ".join(lines))
    say(f"phase24 python -m imagestitching_tpu_torch.tools.profile_bf16_stage"
        f" --reps 10 --rounds 2: exit 0 in {sub_s:.1f} s (a fresh process: "
        f"torch's import and the card's context included), parity "
        f"{sub['parity']}, launches {sub['launches']}, ms/slot (busy in "
        f"brackets) uint8 {sub['times']['uint8 bands']['ms']:.4f} "
        f"({_fmt(sub['times']['uint8 bands']['busy_ms'])}) bf16 "
        f"{sub['times']['bf16 bands']['ms']:.4f} "
        f"({_fmt(sub['times']['bf16 bands']['busy_ms'])}), host us a launch "
        f"uint8 {sub['times']['uint8 bands']['host_us']:.2f} bf16 "
        f"{sub['times']['bf16 bands']['host_us']:.2f}, speedup "
        f"{sub['speedup']:.2f}x")
    say(f"phase24 slot 0 ({p.raw_w}x{p.raw_h} -> {n_cols}x{n_rows}; ms per "
        f"call, CUDA events median of 10x5 in two rounds, profiler busy in "
        f"brackets; each launch on the next of {u8['copies']} uint8 / "
        f"{bf['copies']} bf16 source copies, beyond the {l2} bytes of L2): "
        f"#4 uint8 {u8['kernel_ms']:.4f} ({_fmt(u8['kernel_busy'])}) bf16 "
        f"{bf['kernel_ms']:.4f} ({_fmt(bf['kernel_busy'])}) | #4 at one CTA "
        f"an SM ({sms} CTAs) uint8 {u8['one_an_sm_ms']:.4f} "
        f"({_fmt(u8['one_an_sm_busy'])}) bf16 {bf['one_an_sm_ms']:.4f} "
        f"({_fmt(bf['one_an_sm_busy'])}) | previous body "
        f"uint8 {_fmt(u8['parent_ms'])} ({_fmt(u8['parent_busy'])}) bf16 "
        f"{_fmt(bf['parent_ms'])} ({_fmt(bf['parent_busy'])}) | #1 "
        f"{t1['kernel_ms']:.4f} ({_fmt(t1['kernel_busy'])}) | F.interpolate "
        f"{u8['library_ms']:.4f} ({_fmt(u8['library_busy'])}) | plain uint8 "
        f"{u8['plain_ms']:.4f} bf16 {bf['plain_ms']:.4f} | bound uint8 "
        f"{u8['bound_ms']:.6f} ({u8['bytes']} bytes) bf16 "
        f"{bf['bound_ms']:.6f} ({bf['bytes']} bytes) at 3.35 TB/s | {smi}")
    say(f"phase24 host us per launch (200 launches, no synchronise among "
        f"them): prepared call uint8 {u8['host_us']:.2f} bf16 "
        f"{bf['host_us']:.2f} | one-shot resize_place_staged uint8 "
        f"{u8['oneshot_host_us']:.2f} bf16 {bf['oneshot_host_us']:.2f} | "
        f"previous body's one-shot call uint8 "
        + ("not measured" if old is None else
           f"{u8['parent_host_us']:.2f} bf16 {bf['parent_host_us']:.2f}"))
    return {"launches": launched[3], "t": t, "kernel1": t1,
            "profiler": rec}


def phase25_fresh(smi):
    """Kernels #1-#3 at their main-path sites (config 3, config 5 at B =
    64, config 4-EXIF's 45 banded chunks), launched prepared, in a fresh
    process: ``python -m imagestitching_tpu_torch.tools.
    profile_resize``, which must exit 0 with parity.  Late in this long
    process the profiler drops GPU records (#2's busy time read "not
    measured" there); a fresh process records every launch.  Returns the
    tool's record."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "imagestitching_tpu_torch.tools."
         "profile_resize", "--reps", "10", "--rounds", "3"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"profile_resize exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    check(rec["ok"], f"profile_resize parity {rec['parity']}")
    rows = []
    for key, t in rec["sites"].items():
        pr = t["prepared"]
        rows.append(f"{key} ({t['launches']} launches): prepared "
                    f"{pr['ms']:.4f} ({_fmt(pr['busy_ms'])}, "
                    f"{pr['host_us']:.2f} us a launch) bound "
                    f"{t['bound_ms']:.4f}")
    say(f"phase25 python -m imagestitching_tpu_torch.tools.profile_resize "
        f"--reps 10 --rounds 3: exit 0 in {sub_s:.1f} s (a fresh process), "
        f"parity {rec['parity']} | ms a job by CUDA events (busy; host) "
        f"on {smi}: " + " | ".join(rows))
    return rec


def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-source", help="a previous csrc/resize_place.cu "
                    "(for example `git show HEAD~1:imagestitching_tpu_torch/"
                    "csrc/resize_place.cu`) to build and time beside the "
                    "current body in phases 6, 10 and 15")
    ap.add_argument("--parent-staged-source", help="a previous csrc/"
                    "resize_place_staged.cu (for example `git show HEAD~1:"
                    "imagestitching_tpu_torch/csrc/resize_place_staged.cu`) "
                    "to build and time beside the current kernel #4 in "
                    "phase 24")
    args = ap.parse_args()

    # ---- phase 1: environment
    import torch

    marks = [("start", time.perf_counter())]

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
    from imagestitching_tpu_torch.config import CanvasLimits
    from imagestitching_tpu_torch.core import geometry, oracle
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve
    from imagestitching_tpu_torch.imgio import codec
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
    say(f"phase2 build: {' && '.join(' '.join(c) for c in info.compiles)} "
        f"(together), then {' '.join(info.command)} | seconds "
        f"{info.seconds:.3f} cached {info.cached} | ptxas: {regs or 'n/a'} "
        f"| budget_from_device: {budget_from_device().hbm_bytes} bytes")
    parent = None
    if args.parent_source:
        t0 = time.perf_counter()
        parent = load_parent(args.parent_source)
        say(f"phase2 parent body: built {args.parent_source} in "
            f"{time.perf_counter() - t0:.3f} s, timed beside the current "
            "body in phases 6, 10 and 15")
    parent_staged = None
    if args.parent_staged_source:
        t0 = time.perf_counter()
        parent_staged = load_parent_staged(args.parent_staged_source)
        say(f"phase2 previous kernel #4: built {args.parent_staged_source} "
            f"in {time.perf_counter() - t0:.3f} s, timed beside the current "
            "body in phase 24")

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
    # what the tiled body does differently: regions of 240, 100 and 258 cols
    # by 151 rows at canvas cols 0, 241 and 343 (tiles cut by the region's
    # edge, odd c0); a 12x bilinear downscale of a transposed source (a list
    # of touched lines); lanczos3 at a 16x downscale (K = 97 > 64); a 4x
    # upscale; one channel, transposed, at 12x
    cases.append(("edge-odd-c0", [(97, 61, 1), (151, 100, 6), (77, 45, 3)],
                  StitchOptions(direction="horizontal", mode="max", gap=1.5),
                  None, 3))
    cases.append(("bilinear-12x-transposed", [(2400, 1800, 6),
                                              (150, 200, 1)],
                  StitchOptions(mode="min"), None, 3))
    cases.append(("lanczos3-k97", [(2400, 1800, 1), (150, 100, 1)],
                  StitchOptions(mode="min", filter="lanczos3"), None, 3))
    cases.append(("upscale-4x", [(40, 50, 8), (200, 160, 1)],
                  StitchOptions(mode="max", gap=2), None, 3))
    cases.append(("gray-c1-12x-o5", [(1200, 1800, 5), (100, 80, 1)],
                  StitchOptions(mode="min"), None, 1))

    worst_all, notes = 0, []
    for name, shapes, opts, limits, c in cases:
        plan = solve([ImageSpec(w, h, o) for w, h, o in shapes], opts,
                     limits)
        imgs = [rand(w, h, c) for w, h, _ in shapes]
        check(len(resampled(plan)) > 0, f"{name}: no resampled placement")
        if name == "bilinear-down-frac":
            check(plan.scale_down < 1.0, f"{name}: limits did not scale down")
        if name == "edge-odd-c0":
            check(any(p.col_span[0] % 2 for p in resampled(plan)),
                  f"{name}: no resampled placement at an odd column")
        if name == "lanczos3-k97":
            k = max(taps_on(p, plan.filter, "cpu")[1].shape[1]
                    for p in resampled(plan))
            check(k > 64, f"{name}: K = {k}")
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
    # overlap="never": phases 4-7 read the non-overlapped path; the
    # overlapped scheduler that 9-image jobs take by default is phase 16's
    cfg = RuntimeConfig(device="cuda", overlap="never")
    plan3 = solve([ImageSpec(w, h, o) for w, h, o in CONFIG3], opts3)
    copies = [p for p in plan3.placements
              if geometry.placement_copy_offsets(p, plan3.filter) is not None]
    per_job = len(resampled(plan3))
    check(len(copies) == 4 and per_job == 5,
          f"config 3 plan: {len(copies)} copies, {per_job} resampled")
    walls, deltas, phases, out = [], [], [], None
    _zero_counts()
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
    launches_main = _launch_counts()[0]
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

    # ---- phase 5: export through the port's codec
    with tempfile.TemporaryDirectory() as td:
        path, m5 = itt.stitch_to_file(items, os.path.join(td, "out.png"),
                                      options=opts3, config=cfg,
                                      stream=False, return_metrics=True)
        back, _ = codec.decode(path)
        size = os.path.getsize(path)
    check(np.array_equal(back, out), "PNG round trip differs")
    say(f"phase5 export: stitch_to_file(stream=False) -> PNG {size} bytes, "
        f"decoded equal to phase 4 | encode_s {m5.encode_s:.4f}")

    # ---- phase 6: kernel, parent-body, library and plain times at
    # config 3's shapes
    t6 = phase6_times(dev, smi, plan3, [a for a, _ in items], parent)

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

    marks.append(("1-7", time.perf_counter()))

    # ---- phases 8-11: batched serving (kernel #2, StitchServer, HTTP)
    worst8 = phase8_batch_vs_plain(cases, dev)
    plan5, stacks5, launches5 = phase9_config5(dev, smi, budget_from_device())
    t10 = phase10_batch_times(dev, smi, plan5, stacks5, parent)
    phase11_http(dev, smi)
    marks.append(("8-11", time.perf_counter()))

    # ---- phases 12-15: streamed, banded (kernel #3) and the OOM ladder
    worst12 = phase12_window_vs_plain(cases, dev)
    plan4, opts4, imgs4, items4, ref4, launches_w = phase13_config4(dev,
                                                                    smi)
    phase14_ladder(dev, smi, plan4, opts4, items4, ref4)
    t15 = phase15_window_times(dev, smi, plan4, opts4, items4, parent)
    marks.append(("12-15", time.perf_counter()))

    # ---- phases 16-18: the file entry point -- the overlapped scheduler,
    # the streaming export and the CLI
    with tempfile.TemporaryDirectory() as td:
        plan16, opts16, files16, _, _, launches_ov, launches_wov = \
            phase16_overlapped(dev, smi, td)
        marks.append(("16", time.perf_counter()))
        phase17_export(dev, smi, td, plan16, opts16, files16)
        marks.append(("17", time.perf_counter()))
        phase18_cli(dev, smi, td, items, opts3)
        marks.append(("18", time.perf_counter()))

    # ---- phases 19-21: the extensions -- merge, grid collage, preview
    launches_merge = phase19_merge(dev, smi)
    marks.append(("19", time.perf_counter()))
    items20, launches_grid = phase20_grid(dev, smi)
    marks.append(("20", time.perf_counter()))
    launches_preview, t21 = phase21_preview(dev, smi, items20)
    del items20
    marks.append(("21", time.perf_counter()))

    # ---- phases 22-23: the mesh paths on a mesh that repeats cuda:0 --
    # kernel #3 space-sharded, kernel #2 over a jobs mesh
    launches_sharded, t22 = phase22_space_sharded(dev, smi, plan4, opts4,
                                                  imgs4, items4, ref4)
    del imgs4, items4, ref4
    marks.append(("22", time.perf_counter()))
    launches_jobs_mesh = phase23_jobs_mesh(dev, smi, plan5, stacks5, items,
                                           opts3)
    del stacks5
    marks.append(("23", time.perf_counter()))

    # ---- phase 24: kernel #4 and its profiler
    r24 = phase24_staged(dev, smi, cases, parent_staged)
    marks.append(("24", time.perf_counter()))

    # ---- phase 25: #1-#3 prepared in a fresh process
    r25 = phase25_fresh(smi)["sites"]
    marks.append(("25", time.perf_counter()))
    say("seconds by phase (host clock): " + " ".join(
        f"{name} {t - marks[i][1]:.1f}" for i, (name, t) in
        enumerate(marks[1:])) + f" | total {marks[-1][1] - marks[0][1]:.1f}")

    def r(v):
        return None if v is None else round(v, 6)

    def entry(name, replaces, launches, worst, t, source=KERNEL_SOURCE,
              **by_path):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": worst, "ms": r(t["kernel_ms"]),
                "plain_ms": r(t["plain_ms"]), "bound_ms": r(t["bound_ms"]),
                "bound_by": "bytes", "library_ms": r(t["library_ms"]),
                "lib_ms": r(t["library_ms"]), "busy_ms": r(t["kernel_busy"]),
                "parent_ms": r(t["parent_ms"]),
                "parent_busy_ms": r(t["parent_busy"]), **by_path}

    def prepared(t, site):
        """#1-#3's host us a launch in the phase, and the fresh process's
        numbers at the site (phase 25)."""
        return {"host_us": r(t["host_us"]),
                "fresh": {"prepared": {k: r(v) for k, v in
                                       r25[site]["prepared"].items()}}}

    # "launches": the count on the kernel's first path (phase 4, 9 or 13's
    # banded run); "launches_overlapped": on the overlapped scheduler's run
    # of phase 16 (its resident plan for #1, its banded budget for #3);
    # "launches_merge", "launches_grid" and "launches_preview": #1 on the
    # merged stitch of phase 19, the top-aligned grid of phase 20 and the
    # preview of phase 21; "preview": #1's yardsticks at phase 21's launch;
    # "launches_jobs_mesh": #2 on phase 23's jobs mesh;
    # "launches_space_sharded": #3 on phase 22's space-sharded job, and
    # "space_sharded" its yardsticks at one band window; #4: "launches" on
    # phase 24's profiler run, its yardsticks with uint8 bands, "bf16"
    # with bf16 bands, "kernel1" #1 on the same slot; #1-#3: "ms" and
    # "busy_ms" are the prepared launch's, "host_us" host us a launch,
    # "fresh" phase 25's numbers
    record = {"kernels": [
        entry("resize_place", REPLACES, launches_main,
              max(worst_all, t6["worst"], t21["worst"]), t6,
              **prepared(t6, "config3"),
              launches_overlapped=launches_ov, launches_merge=launches_merge,
              launches_grid=launches_grid, launches_preview=launches_preview,
              preview={"ms": r(t21["kernel_ms"]),
                       "busy_ms": r(t21["kernel_busy"]),
                       "plain_ms": r(t21["plain_ms"]),
                       "library_ms": r(t21["library_ms"]),
                       "bound_ms": r(t21["bound_ms"])}),
        entry("resize_place_batch", REPLACES_BATCH, launches5,
              max(worst8, t10["worst"]), t10, **prepared(t10, "config5"),
              launches_jobs_mesh=launches_jobs_mesh),
        entry("resize_place_window", REPLACES_WINDOW, launches_w,
              max(worst12, t15["worst"], t22["worst"]), t15,
              **prepared(t15, "config4_banded"),
              launches_overlapped=launches_wov,
              launches_space_sharded=launches_sharded,
              space_sharded={"ms": r(t22["kernel_ms"]),
                             "busy_ms": r(t22["kernel_busy"]),
                             "plain_ms": r(t22["plain_ms"]),
                             "library_ms": r(t22["library_ms"]),
                             "bound_ms": r(t22["bound_ms"])}),
        entry("resize_place_staged", REPLACES_STAGED, r24["launches"],
              r24["t"]["uint8"]["worst"], r24["t"]["uint8"],
              source=STAGED_SOURCE,
              bf16={"ms": r(r24["t"]["bf16"]["kernel_ms"]),
                    "busy_ms": r(r24["t"]["bf16"]["kernel_busy"]),
                    "plain_ms": r(r24["t"]["bf16"]["plain_ms"]),
                    "bound_ms": r(r24["t"]["bf16"]["bound_ms"]),
                    "parent_ms": r(r24["t"]["bf16"]["parent_ms"]),
                    "parent_busy_ms": r(r24["t"]["bf16"]["parent_busy"])},
              kernel1={"ms": r(r24["kernel1"]["kernel_ms"]),
                       "busy_ms": r(r24["kernel1"]["kernel_busy"])},
              host_us={k: {h: r(r24["t"][k][h]) for h in (
                  "host_us", "oneshot_host_us", "parent_host_us")}
                  for k in ("uint8", "bf16")},
              profiler_speedup=r(r24["profiler"]["speedup"]))]}
    say(json.dumps(record))
    say(f"gpu: {smi}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
