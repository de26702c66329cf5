"""Jobs in a flush: change of ``jobs`` over change of ``batches`` across
the window."""


def read(rec):
    d = rec.get("server")
    return d["jobs"] / d["batches"] if d and d["batches"] else None
