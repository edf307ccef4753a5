"""step_idle_ms.sft: device-idle ms inside each of the program's
`train.step` spans."""

from port_bench import program_spans


def read(rec):
    return program_spans.step_idle_ms(rec)
