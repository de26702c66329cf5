"""Mean launches of kernel #3 a banded job made: the ``chunks`` count of
the port's ``banded`` spans in the window (each resampled placement's dest
rows in chunks of ``band_rows``).  None for a port whose ``banded`` span
carries no such count."""

from stitchbench.port_spans import mean_count


def read(rec):
    return mean_count(rec, "banded", "chunks")
