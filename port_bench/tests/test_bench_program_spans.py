"""The readers of the program's spans (`program_spans.py`, `metrics/*.sft.py`
that read it) on a hand-built trace and span list: two whole steps in the
window and one cut by its end, launches from two threads, a kernel that
runs past its step's end."""

import pytest

from port_bench import harness, program_spans
from port_bench.trace import WINDOW_SPAN, Trace
from vila_tpu_torch.utils import profiling

READERS = ("data_ms.sft", "forward_ms.sft", "backward_ms.sft", "update_ms.sft",
           "step_idle_ms.sft")

MS = 1e-3
SPANS = [  # (name, start ms, end ms)
    ("data.collate", 0.5, 1.0), ("train.to_device", 1.0, 1.2),
    ("train.step", 1.5, 4.5), ("train.forward", 1.6, 2.5), ("train.backward", 2.6, 3.5),
    ("train.update", 3.6, 4.4),
    ("data.collate", 5.0, 5.8), ("train.to_device", 5.8, 6.1),
    ("train.step", 6.2, 9.2), ("train.forward", 6.3, 7.0), ("train.backward", 7.1, 8.0),
    ("train.update", 8.1, 9.0),
    ("train.step", 9.5, 12.0), ("train.forward", 9.6, 10.0),  # cut by the window's end
]
# (launch ms, launching thread, device start ms, end ms, category)
OPS = [
    (1.2, 1, 1.3, 1.4, "gpu_memcpy"),  # the copy to the card: no phase
    (1.7, 1, 2.0, 2.5, "kernel"),  # forward 1
    (2.7, 2, 2.8, 3.6, "kernel"),  # backward 1, autograd's thread
    (3.8, 1, 4.0, 4.3, "gpu_memcpy"),  # update 1
    (6.5, 1, 6.6, 7.1, "kernel"),  # forward 2
    (7.5, 2, 7.6, 8.4, "kernel"),  # backward 2
    (8.5, 1, 8.6, 8.8, "gpu_memset"),  # update 2
    (8.7, 1, 9.3, 9.5, "kernel"),  # update 2, starting after the step's span ends
    (9.7, 1, 9.8, 9.9, "kernel"),  # the cut step's forward
]


def trace():
    events = [{"cat": "user_annotation", "name": WINDOW_SPAN, "ts": 0.0, "dur": 10000.0}]
    for i, (launch, tid, s, e, cat) in enumerate(OPS):
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid,
                       "ts": launch * 1e3, "dur": 5.0, "args": {"correlation": i}})
        events.append({"cat": cat, "name": f"op{i}", "ts": s * 1e3, "dur": (e - s) * 1e3,
                       "args": {"correlation": i}})
    return Trace(events)


def spans():
    return [profiling.Span(name, i + 1, None, None, 1, s * MS, e * MS, {})
            for i, (name, s, e) in enumerate(SPANS)]


def read_all(rec):
    return {name: harness.metric_reader(name)(rec) for name in READERS}


def test_readers_on_a_hand_built_trace(monkeypatch):
    monkeypatch.setattr(profiling, "recorded", spans)
    got = read_all({"trace": trace()})
    want = {
        "data_ms.sft": (0.5 + 0.8) / 2 + (0.2 + 0.3) / 2,
        "forward_ms.sft": (0.5 + 0.5) / 2,
        "backward_ms.sft": (0.8 + 0.8) / 2,
        "update_ms.sft": (0.3 + 0.2 + 0.2) / 2,
        # step 1: 3.0 ms less 0.5 + 0.8 + 0.3 busy; step 2 runs on to its
        # last kernel's end, 3.3 ms less 0.5 + 0.8 + 0.2 + 0.2
        "step_idle_ms.sft": ((3.0 - 1.6) + (3.3 - 1.7)) / 2,
    }
    assert got == pytest.approx(want, abs=1e-9)
    # nothing else runs inside the steps: their phases and idle fill them
    window = program_spans.steps({"trace": trace()})
    assert [t / MS for iv in window for t in iv] == pytest.approx([1.5, 4.5, 6.2, 9.5])
    length = sum(b - a for a, b in window) / len(window) / MS
    phases = sum(got[f"{p}_ms.sft"] for p in ("forward", "backward", "update"))
    assert phases + got["step_idle_ms.sft"] == pytest.approx(length)


@pytest.mark.parametrize("case", ["no spans", "no trace", "no recorded()"])
def test_readers_read_nothing_without_spans(monkeypatch, case):
    rec = {"trace": trace()}
    if case == "no spans":
        monkeypatch.setattr(profiling, "recorded", lambda: [])
    elif case == "no trace":
        monkeypatch.setattr(profiling, "recorded", spans)
        rec = {}
    else:  # a program that keeps no spans, as before `recorded()`
        monkeypatch.delattr(profiling, "recorded")
    assert read_all(rec) == dict.fromkeys(READERS)
