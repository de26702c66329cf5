"""Mean milliseconds of a job's canvas readback into host memory (the
port's ``StitchMetrics.readback_s``), over every job of the window."""

from stitchbench.harness import mean_ms


def read(rec):
    return mean_ms(rec, "readback_s")
