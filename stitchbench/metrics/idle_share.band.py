"""Share (%) of the measured window in which nothing ran on the device:
1 - the union of kernels, copies and sets over the window's length."""


def read(rec):
    trace = rec.get("trace")
    if not trace or not trace["busy_s"]:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0
