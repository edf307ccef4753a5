"""decode_step_ms.chat: Mean host wall of the batcher's decode steps in the
window (ContinuousBatcher.step_seconds)."""

from port_bench import readers


def read(rec):
    return readers.decode_step_ms(rec)
