"""Mean milliseconds a flush spent stacking its jobs' arrays on the host,
padding included: the port's ``serve.stack`` span of each ``serve.flush``
of the window."""

from stitchbench.mesh_spans import per_flush, stack_ms


def read(rec):
    return per_flush(rec, stack_ms)
