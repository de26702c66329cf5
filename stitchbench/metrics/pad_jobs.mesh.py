"""Mean zero jobs a flush added to reach a multiple of the jobs axis: the
``pad_jobs`` count of each ``serve.flush`` of the window.  None where any
flush ran on another number of distinct cards (its ``cards`` count) than
the cell asks for, so a reading shows that every flush used every card,
or where a flush's ``jobs`` and ``pad_jobs`` do not fill its cards
evenly."""

from stitchbench.mesh_spans import cell_chips, per_flush


def _pad_jobs(chips):
    def read_flush(flush, kids):
        c = flush.counts or {}
        if (c.get("cards") != chips or "pad_jobs" not in c
                or (c["jobs"] + c["pad_jobs"]) % chips):
            return None
        return c["pad_jobs"]
    return read_flush


def read(rec):
    chips = cell_chips("pad_jobs.mesh")
    return None if chips is None else per_flush(rec, _pad_jobs(chips))
