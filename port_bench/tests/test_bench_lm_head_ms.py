"""`metrics/lm_head_ms.sft.py` on a hand-built trace: two whole steps,
each with a `train.lm_head` span inside its forward and one inside its
backward (the fused route), a kernel launched outside them in each phase;
and the same trace with no `train.lm_head` span, as a program without the
span gives it (None, not 0)."""

import pytest

from port_bench import harness
from port_bench.trace import WINDOW_SPAN, Trace
from vila_tpu_torch.utils import profiling

MS = 1e-3
STEPS = [  # (name, start ms, end ms)
    ("train.step", 1.0, 5.0), ("train.forward", 1.1, 2.5), ("train.lm_head", 2.0, 2.4),
    ("train.backward", 2.6, 4.0), ("train.lm_head", 2.7, 2.9), ("train.update", 4.1, 4.8),
    ("train.step", 6.0, 10.0), ("train.forward", 6.1, 7.5), ("train.lm_head", 7.0, 7.4),
    ("train.backward", 7.6, 9.0), ("train.lm_head", 7.7, 7.9), ("train.update", 9.1, 9.8),
]
# (launch ms, launching thread, device start ms, end ms)
OPS = [
    (1.5, 1, 1.6, 2.0),  # forward, before the head
    (2.1, 1, 2.1, 2.6),  # the head's forward
    (2.8, 2, 2.9, 3.0),  # the head's backward, autograd's thread
    (3.0, 2, 3.1, 3.9),  # the rest of the backward
    (6.5, 1, 6.6, 7.0),
    (7.1, 1, 7.1, 7.8),  # runs on past its span's end: counted whole
    (7.8, 2, 7.9, 8.1),
    (8.0, 2, 8.1, 8.9),
]


def trace():
    events = [{"cat": "user_annotation", "name": WINDOW_SPAN, "ts": 0.0, "dur": 12000.0}]
    for i, (launch, tid, s, e) in enumerate(OPS):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                       "ts": launch * 1e3, "dur": 5.0, "args": {"correlation": i}})
        events.append({"cat": "kernel", "name": f"op{i}", "ts": s * 1e3, "dur": (e - s) * 1e3,
                       "args": {"correlation": i}})
    return Trace(events)


def spans(keep_head=True):
    return [profiling.Span(name, i + 1, None, None, 1, s * MS, e * MS, {})
            for i, (name, s, e) in enumerate(STEPS) if keep_head or name != "train.lm_head"]


@pytest.mark.parametrize("head", [True, False])
def test_lm_head_ms_reads_the_heads_spans(monkeypatch, head):
    monkeypatch.setattr(profiling, "recorded", lambda: spans(head))
    got = harness.metric_reader("lm_head_ms.sft")({"trace": trace()})
    if head:
        assert got == pytest.approx(((0.5 + 0.1) + (0.7 + 0.2)) / 2, abs=1e-9)
    else:
        assert got is None
