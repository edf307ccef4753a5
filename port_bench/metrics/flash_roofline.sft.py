"""flash_roofline.sft: Share of the least time of the masked attention pairs
that K7, K8 and K9 reach in the traced steps."""

from port_bench import readers


def read(rec):
    return readers.flash_roofline(rec)
