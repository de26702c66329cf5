"""Mean milliseconds a banded job spent copying its chunks' source windows
into contiguous host arrays (a strided gather for a rotated source): the
port's ``band.crop`` spans of each ``stitch`` root, summed, over the
window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "band.crop")
