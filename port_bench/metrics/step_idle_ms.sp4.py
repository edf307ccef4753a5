"""step_idle_ms.sp4: device-idle ms inside each of rank 0's `train.step`
spans."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.step_idle_ms(rec)
