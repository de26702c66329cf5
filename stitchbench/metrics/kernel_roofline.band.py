"""Share (%) of the device work's bound in its device time, for a banded
job: the least bytes of the window's jobs (``stitchbench.roofline.
job_bytes``) at the card's HBM peak, over the summed device time of every
operation in the trace but host transfers.  On the banded rung the device
does the resampling rects alone (kernel #3: tap footprint read once, rect
written once); the host fills the background and the gap rows, so their
bytes, which ``job_bytes`` counts as written once, are counted against the
kernels too (36 rows of 7211, 0.03% of the job's bytes)."""

from stitchbench.roofline import bound_s


def read(rec):
    trace = rec.get("trace")
    n = sum(j["ok"] for j in rec["jobs"])
    if not trace or not trace["work_s"] or not n:
        return None
    bound = bound_s(n * rec["job_bytes"], rec["device_kind"])
    return None if bound is None else bound / trace["work_s"] * 100.0
