"""Jobs completed per second: every job started in the window, over the
time from the window's start to the last result of the jobs in flight at
its end."""

from stitchbench.harness import rate


def read(rec):
    return rate(rec)
