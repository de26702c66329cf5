"""Command-line interface of the port: ``python -m imagestitching_tpu_torch.cli``.

Twin of ``imagestitching_tpu/cli.py``: the same flags, the same output
(``--json``, ``--metrics``) and the same exit codes (2 for a usage error,
1 for a failed job).  What differs:

* ``--engine`` takes the port's engines, ``auto|cuda|torch|oracle``;
* ``--device`` (default ``cuda``) names the torch device, where the JAX CLI
  took JAX's platform; ``--device cpu`` runs the kernels' plain version;
* ``--hbm-budget auto`` is :func:`..config.budget_from_device` of that
  device;
* ``--grid-cols`` runs ``api.stitch_grid`` (each column on the device) and
  encodes with ``imgio.codec.encode``; ``--merge-overlap`` scores the
  overlaps on the device.
"""

from __future__ import annotations

import argparse
import dataclasses as _dc
import json
import sys
import time
from typing import List, Optional

from . import api
from .config import (CanvasLimits, ENGINES, MemoryBudget, RuntimeConfig,
                     StitchOptions, budget_from_device)


def _gb_or_auto(v: str):
    if v == "auto":
        return v
    try:
        return float(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected GiB number or 'auto', got {v!r}") from None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="imagestitching-tpu-torch",
        description="Stitch images into one vertical/horizontal strip "
                    "(PyTorch on a CUDA card; resize to a common edge + "
                    "concat).")
    p.add_argument("images", nargs="+",
                   help="input image files, in strip order (reorder = ordering "
                        "here; the app's drag-to-reorder analog)")
    p.add_argument("-o", "--output", required=True, help="output image path")
    p.add_argument("--direction", choices=("vertical", "horizontal"),
                   default="vertical")
    p.add_argument("--mode", choices=("min", "max", "original"), default="min",
                   help="common-edge sizing: min/max scale to the "
                        "smallest/largest edge; original keeps sizes, centered")
    p.add_argument("--gap", type=float, default=0.0,
                   help="inter-image gap in output pixels (reference UI "
                        "clamps to 0-20; unbounded here)")
    p.add_argument("--filter",
                   choices=("bilinear", "triangle", "box", "lanczos3"),
                   default="bilinear",
                   help="resampling filter (bilinear = Canvas-2D parity; "
                        "triangle = antialiased downscale)")
    p.add_argument("--background", default="255,255,255",
                   help="background/gap color R,G,B (default white)")
    p.add_argument("--supersample", action="store_true", default=False,
                   help="render above target resolution when under the pixel "
                        "cap (reference does this by default on phones)")
    p.add_argument("--grid-cols", type=int, default=None, metavar="N",
                   help="masonry grid collage with N columns instead of a "
                        "1-D strip (images resized once to the common "
                        "column width)")
    p.add_argument("--grid-order", choices=("balance", "preserve"),
                   default="balance",
                   help="grid assignment: balance = shortest-column "
                        "masonry, preserve = row-major input order")
    p.add_argument("--valign", choices=("top", "center"), default="top",
                   help="grid: align shorter columns to the top or center")
    p.add_argument("--merge-overlap", action="store_true", default=False,
                   help="auto-detect the duplicated strip between "
                        "consecutive screenshots along the stitch axis and "
                        "trim it before stitching")
    p.add_argument("--merge-threshold", type=float, default=2.0,
                   metavar="LEVELS",
                   help="max mean-abs-diff (uint8 levels) for an overlap to "
                        "count as a duplicate (default 2.0 tolerates JPEG "
                        "recompression; 0 = exact match only)")
    p.add_argument("--max-side", type=int, default=None,
                   help="max output side (reference device cap analog)")
    p.add_argument("--max-pixels", type=int, default=None,
                   help="max output pixels; larger outputs are scaled down")
    p.add_argument("--max-images", type=int, default=None,
                   help="cap on input count (reference MAX_IMAGES=9; "
                        "default here: unlimited)")
    p.add_argument("--engine", choices=ENGINES, default="auto",
                   help="auto: the CUDA kernels on a CUDA device, their "
                        "plain version on the CPU; cuda: the kernels only; "
                        "torch: the plain whole-job engine; oracle: the "
                        "float64 NumPy oracle")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda, cuda:N, or cpu (the kernels' "
                        "plain PyTorch version)")
    p.add_argument("--hbm-budget", type=_gb_or_auto, default=None,
                   metavar="GB|auto",
                   help="device memory budget in GiB for one job (governor "
                        "picks resident/streamed/banded to fit; default 2; "
                        "'auto' takes 0.6 of the card's memory)")
    p.add_argument("--decode-threads", type=int, default=None,
                   help="host decode pool size (default 8)")
    p.add_argument("--decode-timeout", type=float, default=None, metavar="S",
                   help="per-image decode watchdog seconds (default 30; "
                        "0 disables)")
    p.add_argument("--decode-window", type=int, default=None, metavar="N",
                   help="max decoded sources resident at once on the "
                        "host-blit paths (ack-window backpressure; "
                        "default: 2x decode threads)")
    p.add_argument("--overlap", choices=("auto", "always", "never"),
                   default="auto",
                   help="overlap decode and upload with device compositing "
                        "(auto: big jobs only)")
    p.add_argument("--artifact-cache", default=None, metavar="DIR",
                   help="persist decode results to DIR (quota-governed disk "
                        "cache; survives restarts)")
    p.add_argument("--metrics", action="store_true",
                   help="print per-phase StitchMetrics JSON to stderr "
                        "(or merged into --json output)")
    p.add_argument("--parity-profile", choices=("ios", "android"),
                   default=None,
                   help="apply the reference app's device limits "
                        "(canvas caps + supersample ceiling) for that "
                        "platform — reproduces the phone output exactly")
    p.add_argument("--on-error", choices=("raise", "skip"), default="raise",
                   help="per-image failure policy during prepare")
    p.add_argument("--quality", type=int, default=95, help="JPEG quality")
    p.add_argument("--png-level", type=int, default=6, choices=range(0, 10),
                   metavar="0-9",
                   help="PNG zlib level (lossless; lower = faster encode, "
                        "slightly larger file)")
    p.add_argument("--no-stream", action="store_true",
                   help="disable the streaming export (band readback "
                        "overlapped with incremental encode); forces the "
                        "monolithic readback-then-encode path")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print a single JSON result line")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.decode_window is not None and args.decode_window < 1:
        # a clean usage error instead of RuntimeConfig's ValueError
        parser.error(f"--decode-window must be >= 1, got {args.decode_window}")
    try:
        bg = tuple(int(x) for x in args.background.split(","))
        if len(bg) != 3 or not all(0 <= v <= 255 for v in bg):
            raise ValueError
    except ValueError:
        print(f"error: --background must be R,G,B in 0-255, "
              f"got {args.background!r}", file=sys.stderr)
        return 2

    if args.merge_threshold < 0:
        parser.error(f"--merge-threshold must be >= 0, "
                     f"got {args.merge_threshold}")
    options = StitchOptions(direction=args.direction, mode=args.mode,
                            gap=args.gap, supersample=args.supersample,
                            background=bg, filter=args.filter,
                            max_images=args.max_images,
                            merge_overlap=args.merge_overlap,
                            merge_threshold=args.merge_threshold)
    if args.parity_profile == "ios":
        limits = CanvasLimits.reference_ios()
    elif args.parity_profile == "android":
        limits = CanvasLimits.reference_android()
    else:
        limits = None
    limits_kw = {}
    if args.max_side is not None:
        limits_kw["max_side"] = args.max_side
    if args.max_pixels is not None:
        limits_kw["max_pixels"] = args.max_pixels
    if limits_kw:
        limits = _dc.replace(limits or CanvasLimits(), **limits_kw)
    if args.grid_cols is not None and args.grid_cols < 1:
        parser.error(f"--grid-cols must be >= 1, got {args.grid_cols}")

    last = {"phase": None}

    def progress(phase: str, frac: float) -> None:
        if args.quiet or args.as_json:
            return
        if phase != last["phase"]:
            print(f"[{phase}]", end="", file=sys.stderr)
            last["phase"] = phase
        print(f" {frac * 100:.0f}%", end="\r" if frac < 1 else "\n",
              file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    try:
        cfg_kw = {"engine": args.engine, "device": args.device,
                  "overlap": args.overlap}
        budget_kw = {}
        if args.hbm_budget == "auto":
            budget_kw["hbm_bytes"] = budget_from_device(args.device).hbm_bytes
        elif args.hbm_budget is not None:
            budget_kw["hbm_bytes"] = int(args.hbm_budget * (1 << 30))
        if args.artifact_cache is not None:
            budget_kw["artifact_dir"] = args.artifact_cache
        if budget_kw:
            cfg_kw["budget"] = MemoryBudget(**budget_kw)
        if args.decode_threads is not None:
            cfg_kw["decode_threads"] = args.decode_threads
        if args.decode_timeout is not None:
            cfg_kw["decode_timeout_s"] = (args.decode_timeout
                                          if args.decode_timeout > 0 else None)
        if args.decode_window is not None:
            cfg_kw["decode_window"] = args.decode_window
        config = RuntimeConfig(**cfg_kw).validate()
        if args.grid_cols is not None:
            from .imgio import codec
            canvas, metrics = api.stitch_grid(
                args.images, cols=args.grid_cols, options=options,
                config=config, limits=limits, on_error=args.on_error,
                progress=progress, order=args.grid_order,
                valign=args.valign, return_metrics=True)
            te = time.perf_counter()
            codec.encode(args.output, canvas, quality=args.quality,
                         png_compression=args.png_level)
            enc_s = time.perf_counter() - te
            metrics.encode_s += enc_s
            metrics.total_s += enc_s
        else:
            _, metrics = api.stitch_to_file(
                args.images, args.output, quality=args.quality,
                png_compression=args.png_level,
                stream=False if args.no_stream else "auto",
                return_metrics=True, options=options, config=config,
                limits=limits, on_error=args.on_error, progress=progress)
    except (ValueError, RuntimeError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    dt = time.perf_counter() - t0
    h, w = metrics.canvas_h, metrics.canvas_w
    mdict = {k: (round(v, 5) if isinstance(v, float) else v)
             for k, v in _dc.asdict(metrics).items()}
    mdict["mp_per_sec"] = round(metrics.mp_per_sec, 1)
    if args.as_json:
        res = {"output": args.output, "width": w, "height": h,
               "seconds": round(dt, 4)}
        if args.metrics:
            res["metrics"] = mdict
        print(json.dumps(res))
    else:
        if args.metrics:
            print(json.dumps(mdict), file=sys.stderr)
        if not args.quiet:
            print(f"{args.output}: {w}x{h} in {dt:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
