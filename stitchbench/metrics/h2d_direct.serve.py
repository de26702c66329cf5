"""Share of a flush's uploads whose rows were copied straight from the
jobs' own arrays (1) rather than from a stack built on the host (0): the
mean ``direct`` count of the port's ``batch.h2d`` spans in the window.
None for a port whose uploads carry no such count."""

from stitchbench.port_spans import mean_count


def read(rec):
    return mean_count(rec, "batch.h2d", "direct")
