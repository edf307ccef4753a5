"""update_ms.sft: device ms a step of the kernels, copies and memsets
launched inside the program's `train.update` spans."""

from port_bench import program_spans


def read(rec):
    return program_spans.phase_ms(rec, "train.update")
