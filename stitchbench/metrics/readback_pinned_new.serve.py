"""Pinned-host blocks by which a flush's host array grew the port's pool
(0 where the flush reused a cached block): the mean ``pinned_new`` count
of the port's ``batch.host`` spans in the window.  None for a port whose
flush takes no such span."""

from stitchbench.port_spans import mean_count


def read(rec):
    return mean_count(rec, "batch.host", "pinned_new")
