"""Per-layer readings from the program's own spans, laid over the traced
run's device trace. The program keeps its spans while a profiler runs
(`vila_tpu_torch.utils.profiling.recorded()`) on the exported Chrome
trace's clock, which `trace.Trace`'s times are on too, so no shift is
applied. A reading counts the spans that opened and closed inside the
profiled window, and is None where there are none: a program without
`recorded()`, or a window that held no such span.

A device operation belongs to a span when its launch, on any thread,
falls inside it: autograd launches the backward from a thread of its own.
A step is one whole `train.step` span, with its phases (`train.forward`,
`train.backward`, `train.update`) one after another on the host; it runs
from its span's start until the card ends the last operation launched
inside it, since the span closes while the update's last kernels are still
queued. So a step's busy time holds all of its phases' operations, and
its idle time is the card waiting on the host's launches (in a traced
run, the profiler's own cost a launch included).
"""

from __future__ import annotations

import bisect
import statistics
from typing import Any, Dict, List, Optional, Tuple


def window_spans(rec: Dict[str, Any]) -> Optional[list]:
    """The program's spans inside the traced window, or None without a
    trace or without the program's span record."""
    tr = rec.get("trace")
    if tr is None:
        return None
    try:
        from vila_tpu_torch.utils import profiling
    except ImportError:
        return None
    recorded = getattr(profiling, "recorded", None)
    if recorded is None:
        return None
    return [s for s in recorded() if tr.t0 <= s.start and s.end <= tr.t1]


def _named(spans, name: str) -> List[Tuple[float, float]]:
    return sorted((s.start, s.end) for s in spans if s.name == name)


def data_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Host ms of one `data.collate` plus one `train.to_device`, each the
    mean of its spans (a step of the sft cell takes one of each)."""
    spans = window_spans(rec)
    if not spans:
        return None
    parts = [_named(spans, "data.collate"), _named(spans, "train.to_device")]
    if not all(parts):
        return None
    return 1e3 * sum(statistics.fmean(e - s for s, e in p) for p in parts)


def _launched(tr, spans: List[Tuple[float, float]]):
    """(i, start, end) of each device operation launched inside `spans[i]`,
    for sorted spans that do not overlap."""
    starts = [s for s, _ in spans]
    for s, e, _, corr in tr.device:
        where = tr.launch.get(corr)
        if where is None:
            continue
        i = bisect.bisect_right(starts, where[1]) - 1
        if i >= 0 and where[1] <= spans[i][1]:
            yield i, s, e


def phase_ms(rec: Dict[str, Any], phase: str) -> Optional[float]:
    """Device ms a step of the kernels, copies and memsets launched inside
    the steps' `phase` spans."""
    spans = window_spans(rec)
    steps = _named(spans, "train.step") if spans else []
    if not steps:
        return None
    inside = [(s, e) for s, e in _named(spans, phase)
              if any(a <= s and e <= b for a, b in steps)]
    spent = sum(e - s for _, s, e in _launched(rec["trace"], inside))
    return 1e3 * spent / len(steps)


def steps(rec: Dict[str, Any]) -> Optional[List[Tuple[float, float]]]:
    """The window's steps: each whole `train.step` span's start, and the
    later of its end and the end of the last device operation launched
    inside it (within the window)."""
    spans = window_spans(rec)
    named = _named(spans, "train.step") if spans else []
    if not named:
        return None
    tr = rec["trace"]
    ends = [e for _, e in named]
    for i, _, e in _launched(tr, named):
        ends[i] = max(ends[i], e)
    return [(s, min(e, tr.t1)) for (s, _), e in zip(named, ends)]


def step_idle_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Device-idle ms inside a step (`steps`): its length less the
    device's busy intervals within it, the mean over the steps."""
    window = steps(rec)
    if not window:
        return None
    busy = rec["trace"].busy_intervals()
    idle = 0.0
    for a, b in window:
        idle += (b - a) - sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
    return 1e3 * idle / len(window)
