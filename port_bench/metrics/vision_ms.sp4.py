"""vision_ms.sp4: device ms a step of the operations launched inside rank
0's `model.vision` spans (the tower and projector over its share of the
row's frames, forward)."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.span_ms(rec, "model.vision")
