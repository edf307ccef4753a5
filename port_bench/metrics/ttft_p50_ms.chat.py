"""ttft_p50_ms.chat: Median, over the requests due in the window, of first
token in the client's hand minus the due time."""

from port_bench import readers


def read(rec):
    return readers.window_stat(rec, "ttft_p50_ms")
