"""Mean milliseconds a banded job spent uploading its chunks' source windows
from pageable host memory: the port's ``band.h2d`` spans of each
``stitch`` root, summed, over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "band.h2d")
