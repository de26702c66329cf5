"""Mean host pages a job's canvas readback made resident (first-touch
faults into fresh memory, one a 4 KiB page): the ``new_pages`` count of the
port's ``readback`` spans in the window."""

from stitchbench.port_spans import mean_count


def read(rec):
    return mean_count(rec, "readback", "new_pages")
