"""mfu.sft: Model FLOPs of the window's steps (LLM, tower and projector,
forward and backward) over their walls at the bf16 peak."""

from port_bench import readers


def read(rec):
    return readers.train_mfu(rec)
