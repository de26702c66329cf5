#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 stitchbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Loads the cell (``BENCHMARK.json`` and the
files its name leads to), makes its inputs from the seed, warms up, then
drives the port (``imagestitching_tpu_torch``) for ``--seconds``.  With
``--trace 0`` it reports the cell's end-to-end metrics, with ``--trace 1``
its per-layer ones, read under ``torch.profiler``.  After the window the
sampled outputs are held to the plain reference.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each compared number beside its limit); the checks are also
the last lines of standard error.

Exits non-zero, printing no result, where there is no CUDA card or fewer
than the cell asks for, where the port cannot be imported, or where
``jax``, ``jaxlib``, ``flax`` or ``imagestitching_tpu`` was loaded.

``--rehearse`` runs the cell on the CPU at the workload's rehearsal size
with the port's plain engine: a check of the harness's control flow, whose
line says ``"platform": "cpu"`` and carries no device metric.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at the workload's rehearsal size")
    return ap.parse_args(argv)


def power_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None) -> int:
    args = parse(argv)
    from stitchbench import deploy, harness, roofline

    cell = harness.Cell(args.workload, ROOT)
    import torch

    if args.rehearse:
        device = torch.device("cpu")
    elif (not torch.cuda.is_available()
          or torch.cuda.device_count() < cell.chips):
        print(f"stitchbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda:0")
    cuda = device.type == "cuda"
    spans = harness.Spans()
    traffic = cell.traffic().Traffic(cell, args.seed, device, args.rehearse,
                                     spans)
    try:
        traffic.make_inputs()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        traffic.warm()
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - T_START
        if args.trace:
            with harness.Trace() as trace:
                rec = traffic.window(args.seconds)
        else:
            rec = traffic.window(args.seconds)
        device_info = harness.device_block(device, cell.chips)
        if args.trace:
            rec["trace"] = trace.reduce(spans, rec["t0"], rec["t_end"])
            del trace
        traffic.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = harness.check(traffic)
        print(f"stitchbench: reference check of {len(traffic.sample.items)}"
              f" jobs took {time.perf_counter() - t_check:.3f} s",
              file=sys.stderr)
    finally:
        traffic.close()
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"stitchbench: forbidden modules loaded: {forbidden}",
              file=sys.stderr)
        return 3

    rec.update(setup_s=setup_s, device_kind=device_info["kind"],
               job_bytes=roofline.job_bytes(
                   deploy.layout(cell.config, traffic.shapes)))
    # every metric of the cell that this run can read goes to standard
    # error; the result carries only its own group's
    readings = {}
    for m in cell.metrics(False) + cell.metrics(True):
        if (args.rehearse or not args.trace) and m["source"] == "device_trace":
            continue
        readings[m["name"]] = cell.reader(m["name"]).read(rec)
    print(f"stitchbench: readings {json.dumps(readings)}", file=sys.stderr)
    metrics = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
               for m in cell.metrics(bool(args.trace))
               if readings.get(m["name"]) is not None}
    attempted = len(rec["jobs"])
    failed = sum(not j["ok"] for j in rec["jobs"])
    checks = harness.judge({**numbers, "failed_jobs": failed},
                           {**cell.config["correct"], "failed_jobs": 0})
    result = {
        "correct": attempted > 0 and all(c["value"] <= c["limit"]
                                         for c in checks.values()),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": device_info,
    }
    if args.trace and not args.rehearse:
        t = rec["trace"]
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = {"device_ops": t["device_ops"],
                               "idle_gaps": t["idle_gaps"]}
    if cuda:
        print(f"stitchbench: {power_line()}", file=sys.stderr)
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT        # the checkout's root, not stitchbench/
    sys.exit(main())
