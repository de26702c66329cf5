"""Mean milliseconds of a ``stitch`` call that no span of the port names:
each root's duration less the union of its children's intervals (on any
thread), over the window's roots."""

from stitchbench.port_spans import self_ms


def read(rec):
    return self_ms(rec, "stitch")
