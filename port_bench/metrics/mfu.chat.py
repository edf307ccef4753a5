"""mfu.chat: Model FLOPs of the window's decode steps over the sum of their
walls at the bf16 peak."""

from port_bench import readers


def read(rec):
    return readers.decode_mfu(rec)
