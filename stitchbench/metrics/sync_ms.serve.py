"""Mean milliseconds a flush waited for the card after enqueueing its
work (kernel #2, the copy and fill kernels): the port's ``batch.sync``
spans of each ``serve.flush``, summed, over the window's flushes."""

from stitchbench.port_spans import per_parent_ms


def read(rec):
    return per_parent_ms(rec, "serve.flush", "batch.sync")
