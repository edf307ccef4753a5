"""flash_roofline.sp4: share of the least time of rank 0's masked
attention pairs that K7, K8 and K9 reach in the traced steps."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.flash_roofline(rec)
