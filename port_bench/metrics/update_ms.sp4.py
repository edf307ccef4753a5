"""update_ms.sp4: device ms a step of the operations launched inside rank 0's
`train.update` spans."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.span_ms(rec, "train.update")
