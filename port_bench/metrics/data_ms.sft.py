"""data_ms.sft: host ms a step inside the program's `data.collate` and
`train.to_device` spans."""

from port_bench import program_spans


def read(rec):
    return program_spans.data_ms(rec)
