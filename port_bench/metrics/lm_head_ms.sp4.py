"""lm_head_ms.sp4: device ms a step of the operations launched inside rank
0's `train.lm_head` spans (the LM head and its cross entropy over the
rank's 32768 rows, forward and backward)."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.span_ms(rec, "train.lm_head")
