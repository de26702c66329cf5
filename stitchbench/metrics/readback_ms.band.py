"""Mean milliseconds a banded job spent reading its chunks' regions back
(the wait for the kernel, the pageable copy) and copying them into the
host canvas: the port's ``band.readback`` spans of each ``stitch`` root,
summed, over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "band.readback")
