"""Share (%) of the device work's bound in its device time: the least
bytes of the window's jobs (``stitchbench.roofline.job_bytes``: the
resampling rects' tap footprint read once and rects written once, the
copying rects read and written once, the background written once) at the
card's HBM peak, over the summed device time of every operation in the
trace but host transfers (kernels, sets, device-to-device copies): the
same work, whichever kernels do it."""

from stitchbench.roofline import bound_s


def read(rec):
    trace = rec.get("trace")
    n = sum(j["ok"] for j in rec["jobs"])
    if not trace or not trace["work_s"] or not n:
        return None
    bound = bound_s(n * rec["job_bytes"], rec["device_kind"])
    return None if bound is None else bound / trace["work_s"] * 100.0
