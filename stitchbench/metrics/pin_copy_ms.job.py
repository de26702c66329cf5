"""Mean milliseconds a job spent copying its sources into the pinned
slots: the port's ``stage.pin_copy`` spans of each ``stitch`` root, summed,
over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "stage.pin_copy")
