"""Share of a job's canvas readbacks that grew the port's pinned-host pool
(a fresh pinned block allocated inside the readback, 1 a miss, 0 a reuse):
the mean ``pinned_new`` count of the port's ``readback`` spans in the
window.  None for a port whose readback carries no such count."""

from stitchbench.port_spans import mean_count


def read(rec):
    return mean_count(rec, "readback", "pinned_new")
