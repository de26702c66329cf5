"""Median milliseconds of every job completed in the window, from the
call into ``stitch`` to its return of the host canvas."""

from stitchbench.harness import job_ms, percentile


def read(rec):
    ms = job_ms(rec)
    return percentile(ms, 50) if ms else None
