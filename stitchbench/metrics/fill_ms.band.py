"""Mean milliseconds a banded job spent allocating its host canvas and
filling it with the background: the port's ``band.fill`` spans of each
``stitch`` root, summed, over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "band.fill")
