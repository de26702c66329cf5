"""Mean milliseconds a job spent in decode and prepare (the port's
``StitchMetrics.prepare_s``: on the overlapped path, the wall until the
last decode landed), over every job of the window."""

from stitchbench.harness import mean_ms


def read(rec):
    return mean_ms(rec, "prepare_s")
