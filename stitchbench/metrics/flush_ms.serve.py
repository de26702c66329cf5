"""Milliseconds of a flush after stacking: upload, kernel #2 and the
readback into one host array (change of ``flush_s`` less change of
``stack_s``, over change of ``batches`` across the window)."""


def read(rec):
    d = rec.get("server")
    if not d or not d["batches"]:
        return None
    return (d["flush_s"] - d["stack_s"]) / d["batches"] * 1e3
