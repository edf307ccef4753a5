"""prefill_roofline.chat: Share of the least time at each prefill's real
prompt rows that K2 reaches, over the prefills of the profiled seconds."""

from port_bench import readers


def read(rec):
    return readers.prefill_roofline(rec)
