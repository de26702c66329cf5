"""How many cards a flush served at once: per flush, the summed time of
its cards' ``batch.*`` spans over the union of their intervals (1.0 when
the cards are served one after another, 4.0 when four are served all at
once), averaged over the window's flushes."""

from stitchbench.mesh_spans import card_overlap, per_flush


def read(rec):
    return per_flush(rec, card_overlap)
