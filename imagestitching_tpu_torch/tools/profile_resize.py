"""Kernels #1-#3 launched prepared at their main-path sites, timed in a
fresh process.

Run on a CUDA host, from the root of a checkout:

    python -m imagestitching_tpu_torch.tools.profile_resize

It builds three sites of the main path at their real sizes, each from a
seeded source made on the card: #1 at BASELINE config 3 (five resampled
placements a job, as ``cuda_resize.stitch`` launches them), #2 at config 5
(64 jobs, eight resampled placements a flush, as ``stitch_batch`` launches
them) and #3 at config 4 with EXIF orientations on the banded rung (five
placements in 256-row chunks, as ``WindowLauncher`` launches them).
Parity comes first: per site, the prepared launches and the plain version
must agree bit for bit, or it exits 1.  Then per site it prints the
CUDA-event time of all the site's launches (the median of ``--rounds``
rounds of ``--reps``), the profiler's device busy time and the host
microseconds a launch takes, beside the bound (the taps' footprint read
once and the regions written, at 3.35 TB/s).  A fresh
process, because late in a long one the profiler drops GPU records.  The
last line is a JSON record of the run.  Without CUDA it raises: there is no
CPU mode.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import StitchOptions
from ..core import geometry
from ..core.layout import ImageSpec, solve
from ..ops import cuda_resize, torch_compose
from ..ops.window import WindowPlan
from ..runtime.pipeline import resolve_device
from .profile_bf16_stage import (CONFIG5, HBM_BYTES_PER_S, busy_ms,
                                 events_ms, host_us)

#: BASELINE config 3 (raw width, raw height, EXIF orientation), horizontal,
#: mode "min", gap 4.
CONFIG3 = [(1920, 1080, 1), (1080, 1920, 6), (1440, 1080, 3),
           (1280, 960, 8), (2000, 1500, 1), (1080, 1080, 5),
           (1600, 1200, 2), (1200, 1600, 7), (1920, 1440, 4)]
#: BASELINE config 4 (9 x 12 MP, vertical, mode "min", gap 4) with config
#: 3's orientations, so that five placements resample.
CONFIG4 = [(4000, 3000, o) for o in (1, 6, 3, 8, 1, 5, 2, 7, 4)]
#: Config 5's jobs in a flush, and the banded rung's chunk rows.
BATCH5 = 64
BAND_ROWS = 256


class Site(NamedTuple):
    """One site: its prepared launches, and how to check them."""

    name: str
    prepared: List[Callable[[], None]]
    parity: Callable[[], tuple]      # (max |diff|, differing pixels)
    nbytes: int


def footprint_bytes(ri0, rw, m_h, ci0, cw, m_w, channels) -> int:
    """Bytes of source one resample must read: the rows and cols that its
    taps of non-zero weight touch (clamped as the kernel clamps them),
    each read once."""
    def touched(i0, w, m):
        idx = np.clip(np.asarray(i0)[:, None].astype(np.int64)
                      + np.arange(w.shape[1])[None, :], 0, m - 1)
        return np.unique(idx[np.asarray(w) != 0]).size

    return (touched(ri0, rw, m_h) * touched(ci0, cw, m_w) * channels)


def _resampled(plan):
    return [p for p in plan.placements
            if p.row_span[1] > p.row_span[0]
            and p.col_span[1] > p.col_span[0]
            and geometry.placement_copy_offsets(p, plan.filter) is None]


def _taps(p, kind, dev):
    t = torch_compose.placement_taps(p, kind)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        t["rows"]["i0"], t["rows"]["w"], t["cols"]["i0"], t["cols"]["w"]))


def _diff(a: torch.Tensor, b: torch.Tensor) -> tuple:
    d = (a.int() - b.int()).abs()
    return int(d.max()), int((d > 0).any(dim=-1).sum())


def _worst(diffs) -> tuple:
    return max(d[0] for d in diffs), sum(d[1] for d in diffs)


def _bytes(p, kind, taps, batch=1) -> int:
    disp_w, disp_h = geometry.display_size(p.raw_w, p.raw_h, p.orientation)
    ri0, rw, ci0, cw = (x.cpu().numpy() for x in taps)
    return batch * (footprint_bytes(ri0, rw, disp_h, ci0, cw, disp_w, 3)
                    + len(ri0) * len(ci0) * 3)


def site_config3(dev, gen) -> Site:
    """#1 at config 3: one prepared launch per resampled placement."""
    plan = solve([ImageSpec(w, h, o) for w, h, o in CONFIG3],
                 StitchOptions(direction="horizontal", mode="min", gap=4,
                               max_images=None))
    canvas = torch.zeros((plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    prepared, checks, nbytes = [], [], 0
    for p in _resampled(plan):
        src = torch.randint(0, 256, (p.raw_h, p.raw_w, 3), generator=gen,
                            dtype=torch.uint8, device=dev)
        taps = _taps(p, plan.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)
        prepared.append(lambda f=launch, s=src: f(s, canvas))
        checks.append((src, p.orientation, taps, (r0, r1, c0, c1)))
        nbytes += _bytes(p, plan.filter, taps)

    def parity():
        return _worst([_diff(canvas[r0:r1, c0:c1],
                             cuda_resize.resize_place_ref(src, o, *taps))
                       for src, o, taps, (r0, r1, c0, c1) in checks])
    return Site("#1 config 3", prepared, parity, nbytes)


def site_config5(dev, gen, batch=BATCH5) -> Site:
    """#2 at config 5: one prepared launch per resampled placement over
    ``batch`` jobs."""
    plan = solve([ImageSpec(w, h) for w, h in CONFIG5],
                 StitchOptions(mode="min", gap=4, max_images=None))
    canvas = torch.zeros((batch, plan.canvas_h, plan.canvas_w, 3),
                         dtype=torch.uint8, device=dev)
    prepared, checks, nbytes = [], [], 0
    for p in _resampled(plan):
        src = torch.randint(0, 256, (batch, p.raw_h, p.raw_w, 3),
                            generator=gen, dtype=torch.uint8, device=dev)
        taps = _taps(p, plan.filter, dev)
        r0, r1 = p.row_span
        c0, c1 = p.col_span
        launch = cuda_resize.PlaceLaunch(src, p.orientation, *taps, canvas,
                                         r0, c0)
        prepared.append(lambda f=launch, s=src: f(s, canvas))
        checks.append((src, p.orientation, taps, (r0, r1, c0, c1)))
        nbytes += _bytes(p, plan.filter, taps, batch)

    def parity():
        out = []
        for src, o, taps, (r0, r1, c0, c1) in checks:
            # a few jobs at a time: the float32 plain version of 64 jobs
            # takes gigabytes
            for b in range(0, batch, 8):
                out.append(_diff(canvas[b:b + 8, r0:r1, c0:c1],
                                 cuda_resize.resize_place_batch_ref(
                                     src[b:b + 8], o, *taps)))
        return _worst(out)
    return Site(f"#2 config 5 (B={batch})", prepared, parity, nbytes)


def site_config4_banded(dev, gen, band_rows=BAND_ROWS) -> Site:
    """#3 at config 4-EXIF on the banded rung: one prepared launcher per
    resampled placement, one launch per chunk (the crops are row windows
    of the source oriented on the card)."""
    plan = solve([ImageSpec(w, h, o) for w, h, o in CONFIG4],
                 StitchOptions(mode="min", gap=4, max_images=None))
    prepared, chunks, nbytes = [], [], 0
    for p in _resampled(plan):
        raw = torch.randint(0, 256, (p.raw_h, p.raw_w, 3), generator=gen,
                            dtype=torch.uint8, device=dev)
        oriented = torch_compose.orient(raw, p.orientation).contiguous()
        del raw
        wp = WindowPlan(p, plan.filter, band_rows)
        taps = [torch.from_numpy(x).to(dev)
                for x in (wp.ri0, wp.rw, wp.ci0, wp.cw)]
        region = torch.zeros((wp.chunk, wp.n_cols, 3), dtype=torch.uint8,
                             device=dev)
        launch = cuda_resize.WindowLauncher(*taps, region,
                                            (wp.crop_rows, wp.disp_w, 3))
        for g in range(wp.n_chunks):
            a, valid, s_lo = wp.chunk_window(g)
            crop = oriented[s_lo:s_lo + wp.crop_rows]
            prepared.append(lambda f=launch, c=crop, a=a, s=s_lo, v=valid:
                            f(c, a, s, v))
            chunks.append((prepared[-1], crop, taps, region,
                           (a, s_lo, valid)))
            i0, w = wp.chunk_taps(g)
            nbytes += footprint_bytes(i0, w, wp.crop_rows, wp.ci0, wp.cw,
                                      wp.disp_w, 3) + valid * wp.n_cols * 3

    def parity():
        out = []
        for run, crop, taps, region, (a, s_lo, n) in chunks:
            run()
            out.append(_diff(region[:n], cuda_resize.resize_place_window_ref(
                crop, *taps, a, s_lo, n)))
        return _worst(out)
    return Site(f"#3 config 4-EXIF banded ({band_rows}-row chunks)",
                prepared, parity, nbytes)


def _all(fns: Sequence[Callable[[], None]]) -> Callable[[], None]:
    def run():
        for f in fns:
            f()
    return run


def run(reps: int = 20, rounds: int = 5, seed: int = 0, out=print,
        sites: Optional[Sequence[str]] = None) -> dict:
    """Parity, then the times of each site's prepared launches on the
    current card;
    the record (``ok`` false when parity failed, and then no times)."""
    dev = resolve_device("cuda")     # no card: raises, never the CPU
    gen = torch.Generator(device=dev).manual_seed(seed)
    makers = {"config3": site_config3, "config5": site_config5,
              "config4_banded": site_config4_banded}
    record = {"device": torch.cuda.get_device_name(dev), "parity": {},
              "sites": {}}
    built = {}
    for key in sites or makers:
        site = built[key] = makers[key](dev, gen)
        for f in site.prepared:
            f()
        torch.cuda.synchronize()
        record["parity"][key] = site.parity()
        out(f"{site.name}: {len(site.prepared)} launches a job, prepared "
            f"vs plain max |diff| {record['parity'][key][0]} "
            f"({record['parity'][key][1]} px)")
    record["ok"] = all(v == (0, 0) for v in record["parity"].values())
    if not record["ok"]:
        return record
    for key, site in built.items():
        bound = site.nbytes / HBM_BYTES_PER_S * 1e3
        n = len(site.prepared)
        times = {"launches": n, "bytes": site.nbytes, "bound_ms": bound}
        job = _all(site.prepared)
        # about 200 launches in flight at most, well inside the queue
        times["prepared"] = pr = {
            "ms": events_ms(job, reps, rounds),
            "busy_ms": busy_ms(job, bound, reps),
            "host_us": host_us(job, max(2, 200 // n)) / n}
        record["sites"][key] = times
        out(f"{site.name}: ms a job by CUDA events prepared {pr['ms']:.4f}; "
            f"busy {_fmt(pr['busy_ms'])}; host us a launch "
            f"{pr['host_us']:.2f}; bound {bound:.4f} ({site.nbytes} bytes "
            f"at 3.35 TB/s)")
    return record


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Kernels #1-#3 at their main-path sites, launched "
                    "prepared (parity, then times)")
    ap.add_argument("--reps", type=int, default=20,
                    help="jobs per timed round (default 20)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed rounds, of which the median (default 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="of the random sources (default 0)")
    args = ap.parse_args(argv)
    record = run(args.reps, args.rounds, args.seed)
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
