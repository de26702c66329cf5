"""Mean milliseconds a job waited from ``submit`` to the start of its
flush (``StitchServer.stats()``: change of ``queue_wait_s`` over change of
``jobs`` across the window)."""


def read(rec):
    d = rec.get("server")
    return d["queue_wait_s"] / d["jobs"] * 1e3 if d and d["jobs"] else None
