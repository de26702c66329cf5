"""Mean milliseconds a flush spent copying its canvases into one host
array: the port's ``batch.readback`` spans of each ``serve.flush``,
summed, over the window's flushes."""

from stitchbench.port_spans import per_parent_ms


def read(rec):
    return per_parent_ms(rec, "serve.flush", "batch.readback")
