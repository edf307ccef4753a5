"""optimizer_ms.sft: Device ms per step of the kernels launched inside the
optimizer's update (clipping and AdamW)."""

from port_bench import readers


def read(rec):
    return readers.optimizer_ms(rec)
