"""idle_share.chat: Share of the profiled window in which no kernel, copy or
memset ran on the card."""

from port_bench import readers


def read(rec):
    return readers.idle_share(rec)
