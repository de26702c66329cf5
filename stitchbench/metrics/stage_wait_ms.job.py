"""Mean milliseconds a job's host was blocked staging sources into the
pinned slots (the port's ``StitchMetrics.stage_wait_s``), over every job
of the window."""

from stitchbench.harness import mean_ms


def read(rec):
    return mean_ms(rec, "stage_wait_s")
