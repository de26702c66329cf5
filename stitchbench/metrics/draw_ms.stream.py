"""Mean milliseconds a streamed job's host spent enqueuing its draws (#1's
prepared launch, or the oriented copy of an identity placement): the
port's ``stream.draw`` spans of each ``stitch`` root, summed, over the
window's roots."""

from stitchbench.port_spans import per_job_ms


def read(rec):
    return per_job_ms(rec, "stitch", "stream.draw")
