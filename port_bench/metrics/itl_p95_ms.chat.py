"""itl_p95_ms.chat: 95th percentile of the gaps between consecutive tokens
the clients received in the window."""

from port_bench import readers


def read(rec):
    return readers.window_stat(rec, "itl_p95_ms")
