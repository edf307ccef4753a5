"""lm_head_ms.sft: device ms a step of the kernels, copies and memsets
launched inside the program's `train.lm_head` spans (the LM head and its
cross entropy, forward and, on the fused route, backward); None where the
window holds no such span (a program without it)."""

from port_bench import program_spans


def read(rec):
    spans = program_spans.window_spans(rec)
    if not spans or not any(s.name == "train.lm_head" for s in spans):
        return None
    return program_spans.phase_ms(rec, "train.lm_head")
