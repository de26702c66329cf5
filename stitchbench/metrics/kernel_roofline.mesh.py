"""Share (%) of the device work's bound in its device time, over every
card: ``kernel_roofline.serve``'s reader, whose denominator, the device
time of every operation in the trace but host transfers, sums the work of
all the cards; the bound is the window's jobs' least bytes at one card's
HBM peak."""

import os

from stitchbench.harness import HERE, load_module

read = load_module(os.path.join(HERE, "metrics", "kernel_roofline.serve.py"),
                   "stitchbench_metric_kernel_roofline_serve").read
