"""Milliseconds a flush spent stacking its jobs' arrays on the host
(``StitchServer.stats()``: change of ``stack_s`` over change of
``batches`` across the window)."""


def read(rec):
    d = rec.get("server")
    return d["stack_s"] / d["batches"] * 1e3 if d and d["batches"] else None
