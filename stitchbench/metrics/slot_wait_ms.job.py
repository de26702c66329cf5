"""Mean milliseconds a job waited for a free pinned slot (the slot's last
upload landing): the port's ``stage.slot_wait`` spans of each ``stitch``
root, summed, over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "stage.slot_wait")
