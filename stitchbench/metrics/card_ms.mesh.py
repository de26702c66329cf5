"""Mean milliseconds a card's share of a flush took: per flush, the mean
over its cards of that card's ``batch.h2d``, ``batch.draw``,
``batch.sync`` and ``batch.readback`` spans, summed."""

from stitchbench.mesh_spans import card_ms, per_flush


def read(rec):
    return per_flush(rec, card_ms)
