"""Mean milliseconds of a flush after stacking: every card's upload,
kernel #2 and readback into one host array (the port's ``serve.flush``
span less its ``serve.stack``, per flush of the window)."""

from stitchbench.mesh_spans import per_flush, stack_ms


def _after_stack(flush, kids):
    stack = stack_ms(flush, kids)
    if stack is None:
        return None
    return (flush.end_ns - flush.start_ns) / 1e6 - stack


def read(rec):
    return per_flush(rec, _after_stack)
