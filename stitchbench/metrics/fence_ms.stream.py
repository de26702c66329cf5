"""Mean milliseconds a streamed job waited at its fences (the wait for the
device once the uploaded bytes pass the budget's headroom): the port's
``stream.fence`` spans of each ``stitch`` root, summed, over the window's
roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "stream.fence")
