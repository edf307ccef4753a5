"""mfu.sp4: model FLOPs of the window's untraced steps (LLM, attention
pairs, tower and projector, forward and backward, recomputation not
counted) over their walls at 4 x the bf16 peak."""

from port_bench import sp_readers


def read(rec):
    return sp_readers.train_mfu(rec, rec["config"]["deployment"]["chips"])
