"""data_ms.sp4: host ms a step inside rank 0's `data.collate` and
`train.to_device` spans."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.data_ms(rec)
