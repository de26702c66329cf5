#!/usr/bin/env python3
"""The control of a cell's comparison: the reference computed in bfloat16,
put in the program's place, at the cell's own size.

    python3 stitchbench/control.py --workload <cell> --seeds 11,12,13

makes each seed's inputs as a run of the cell would, draws the jobs a run
would check, renders each with the reference in bfloat16 and holds it to
the float64 reference by the cell's comparison.  Prints one JSON line per
seed (the compared numbers, and whether the cell's limits reject them) and
exits 0; a control that passes the limits is the finding, not an error.
The benchmark's runs never run this.  ``--rehearse`` runs it on the CPU at
the workload's rehearsal size.
"""

import argparse
import json
import os
import random
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(traffic, seed: int, dtype) -> dict:
    """Worst compared numbers over ``check_jobs`` pool jobs drawn from
    ``seed``, the reference in ``dtype`` standing in for the program."""
    from stitchbench import deploy
    from stitchbench.reference import stitch as ref

    k = int(traffic.p["check_jobs"])
    pool = int(traffic.p["pool_jobs"])
    worst = {}
    for idx in random.Random(seed).sample(range(pool), min(k, pool)):
        raws, shapes = traffic.sources(idx)
        lay = deploy.layout(traffic.cell.config, shapes)
        out = ref.render(lay, raws, traffic.device, dtype)
        got = ref.compare(lay, raws, out, traffic.device)
        worst = {n: max(v, worst.get(n, v)) for n, v in got.items()}
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from stitchbench import harness

    cell = harness.Cell(args.workload, ROOT)
    if args.rehearse:
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("stitchbench control: no CUDA card", file=sys.stderr)
        return 2
    else:
        device = torch.device("cuda:0")
    limits = cell.config["correct"]
    for seed in (int(s) for s in args.seeds.split(",")):
        traffic = cell.traffic().Traffic(cell, seed, device, args.rehearse,
                                         harness.Spans())
        try:
            traffic.make_inputs()
            got = control_numbers(traffic, seed, torch.bfloat16)
        finally:
            traffic.close()
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": "bfloat16", "numbers": got,
                          "rejected": any(got[k] > limits[k]
                                          for k in got)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT        # the checkout's root, not stitchbench/
    sys.exit(main())
