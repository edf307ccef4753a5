"""row_fill.sft: Non-padding share of the packed rows the window's steps
trained on (PackingCollator)."""

from port_bench import readers


def read(rec):
    return readers.row_fill(rec)
