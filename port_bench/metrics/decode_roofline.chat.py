"""decode_roofline.chat: Share of the least time (W4 weight and scale bytes,
live cache rows) that the traced decode steps' K6 and K1 kernels reach."""

from port_bench import readers


def read(rec):
    return readers.decode_roofline(rec)
