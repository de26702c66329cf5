"""Mean milliseconds a flush spent uploading its stacks to the card: the
port's ``batch.h2d`` spans of each ``serve.flush``, summed, over the
window's flushes."""

from stitchbench.port_spans import per_parent_ms


def read(rec):
    return per_parent_ms(rec, "serve.flush", "batch.h2d")
