#!/usr/bin/env python3
"""Time kernels #1 and #3 as two checkouts' main paths launch them.

    python3 chip_ab.py A_ROOT [B_ROOT]

A_ROOT and B_ROOT (default: this checkout) are roots of two checkouts of
the repo, for example an earlier commit unpacked with ``git archive`` into
a git-ignored directory.  Runs are fresh processes, in the order A, B, B, A
on the same card.  Each imports its checkout's ``chip_smoke`` and package
and calls that checkout's phase 6 (kernel #1 at BASELINE config 3's five
resampled placements) and phase 15 (kernel #3 over config 4-EXIF's 45
banded chunks): CUDA events and busy time as that checkout's main path
launches the kernel, ``F.interpolate`` beside it, and the host
microseconds a launch where the checkout measures them.  Prints each
run's phase lines and one JSON line per run, then a JSON summary (per
checkout, the two runs' numbers) as the last line.  Needs a CUDA card;
exits non-zero without one or when a run fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

KEYS = ("kernel_ms", "kernel_busy", "library_ms", "host_us")


def one(root: str) -> None:
    """The measurements of checkout ``root``, in this process."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from imagestitching_tpu_torch import StitchOptions
    from imagestitching_tpu_torch.core.layout import ImageSpec, solve

    if not os.path.abspath(cs.__file__).startswith(os.path.abspath(root)):
        sys.exit(f"imported {cs.__file__}, not {root}'s chip_smoke")
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a "
                 "card")
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (h, w, 3), np.uint8)
            for w, h, _ in cs.CONFIG3]
    plan3 = solve([ImageSpec(w, h, o) for w, h, o in cs.CONFIG3],
                  StitchOptions(direction="horizontal", mode="min", gap=4,
                                max_images=None))
    t6 = cs.phase6_times(dev, smi, plan3, imgs, None)
    plan4, opts4, _, items4 = cs._config4_job(dev, cs.CONFIG4, 4)
    t15 = cs.phase15_window_times(dev, smi, plan4, opts4, items4, None)
    print("AB " + json.dumps({
        "root": root, "smi": smi,
        "config3": {k: t6.get(k) for k in KEYS},
        "config4_banded": {k: t15.get(k) for k in KEYS},
        "seconds": time.perf_counter() - t0}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(os.path.abspath(sys.argv[2]))
        return 0
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__.split("\n\n")[1])
    a = os.path.abspath(sys.argv[1])
    b = os.path.abspath(sys.argv[2] if len(sys.argv) == 3
                        else os.path.dirname(os.path.abspath(__file__)))
    runs = {a: [], b: []}
    for root in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.splitlines()
        for ln in lines:
            if ln.startswith(("phase6 ", "phase15 ")):
                print(ln, flush=True)
        rec = [json.loads(ln[3:]) for ln in lines if ln.startswith("AB ")]
        if proc.returncode != 0 or not rec:
            print(proc.stderr[-3000:], file=sys.stderr)
            sys.exit(f"run of {root} exited {proc.returncode}")
        print("AB " + json.dumps(rec[0]), flush=True)
        runs[root].append(rec[0])
    print(json.dumps({"A": {"root": a, "runs": runs[a]},
                      "B": {"root": b, "runs": runs[b]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
