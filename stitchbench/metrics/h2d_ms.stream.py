"""Mean milliseconds a streamed job spent uploading its sources from
pageable host memory (on the card each copy first waits for the draws
queued before it): the port's ``stream.h2d`` spans of each ``stitch``
root, summed, over the window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "stream.h2d")
