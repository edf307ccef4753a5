"""The traced run's instruments: spans that the benchmark puts around its
calls into the program's layers, a torch.profiler session over a steady
sub-window, and the reduction of its trace to what the per-layer readers
take (busy and idle time, device time of the kernels launched inside a
span, the top device operations and the longest idle gaps).

A span is a host-clock interval that a wrapper on an object's method (or
the driver around its own call) records with its thread's native id: the
program is not edited, and with tracing off no wrapper is installed. The
profiler does not record ranges opened on threads other than the one that
started it (the batcher's loop and admission threads, autograd's), so the
spans are kept by the benchmark and placed on the trace's clock by the
window's own range. A kernel belongs to a span when its launch (the CUDA
runtime or driver call with the same correlation id) falls inside the span
on the same host thread.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

# the port's kernel symbols and the names the repository gives them
KERNEL_LABELS = (
    ("w4_stream_kernel", "K1"), ("w4_wgmma_kernel", "K1"), ("w4_gemm_sm90_kernel", "K2"),
    ("decode_layer_kernel", "K3"), ("w4_pair_kernel", "K4/K5"),
    ("decode_attn_b_kernel", "K6"), ("w4_digits_kernel", "K6"), ("w4_gemv_rows_kernel", "K6"),
    ("flash_fwd_sm90_kernel", "K7"), ("flash_bwd_dq_sm90_kernel", "K8"),
    ("flash_bwd_dkv_sm90_kernel", "K9"), ("flash_dkv_group_sum_kernel", "K9"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_SPAN = "trace_window"


def kernel_label(name: str) -> Optional[str]:
    for sym, label in KERNEL_LABELS:
        if sym in name:
            return label
    return None


def op_name(name: str) -> str:
    """A device operation's name for the breakdown: the port's kernels as
    K1-K9 with their symbol, others cut to 80 characters."""
    for sym, label in KERNEL_LABELS:
        if sym in name:
            return f"{label} {sym}"
    return name[:80]


class Spans:
    """Host intervals (thread native id, start, end, name) on the
    perf_counter clock."""

    def __init__(self):
        self.items: List[Tuple[int, float, float, str]] = []

    def open(self, name: str) -> "_Open":
        return _Open(self, name)

    def wrap(self, obj: Any, attr: str, name: Callable[..., str],
             record: Optional[Callable[..., None]] = None) -> None:
        """Record each call of `obj.attr` as a span named `name(*args,
        **kw)`; `record(*args, **kw)` is called first (to note sizes the
        readers need)."""
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def wrapped(*args, **kw):
            if record is not None:
                record(*args, **kw)
            with self.open(name(*args, **kw)):
                return inner(*args, **kw)

        setattr(obj, attr, wrapped)


class _Open:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.items.append(((threading.get_native_id(), threading.get_ident()), self.t0,
                                 time.perf_counter(), self.name))
        return False


class Session:
    """A profiler over [start(), stop()); `summary()` reduces its trace."""

    def __init__(self, path: str):
        self.path = path
        self.prof = None
        self.window = None
        self.spans = Spans()
        self.began = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop a profiler once in set-up: the first start
        initialises the device tracer, which takes seconds."""
        import torch

        with self._profile():
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)

    def start(self) -> float:
        """Start tracing; returns the host time tracing began."""
        import time

        from torch.profiler import record_function

        self.prof = self._profile()
        self.prof.start()
        self.window = record_function(WINDOW_SPAN)
        self.window.__enter__()
        self.began = time.perf_counter()
        return self.began

    def stop(self) -> None:
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> "Trace":
        """The trace, written out and read back once the window is over."""
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        return Trace(events, self.spans.items, self.began)


def summarise(session: Optional[Session]) -> Optional["Trace"]:
    """The session's trace (None without one), its attribution logged."""
    if session is None:
        return None
    tr = session.summary()
    print(f"[trace] {tr.describe()}", file=sys.stderr, flush=True)
    return tr


class Trace:
    """A chrome trace's device intervals, launches and spans (times in
    seconds), restricted to the traced window."""

    def __init__(self, events: List[Dict[str, Any]], spans=(), began: float = 0.0):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW_SPAN]
        if not win:
            raise RuntimeError("the trace holds no window span")
        self.t0 = win[0]["ts"] * 1e-6
        self.t1 = self.t0 + win[0]["dur"] * 1e-6
        shift = self.t0 - began  # host clock -> trace clock
        self.device = []  # (start, end, name, correlation)
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                s = e["ts"] * 1e-6
                self.device.append((s, s + e["dur"] * 1e-6, e.get("name", ""),
                                    e.get("args", {}).get("correlation")))
        self.device.sort()
        self.launch = {}  # correlation -> (thread, time)
        for e in events:
            if e.get("cat") in LAUNCH_CATS and "args" in e:
                c = e["args"].get("correlation")
                if c is not None:
                    self.launch[c] = (e.get("tid"), e["ts"] * 1e-6)
        self.spans: Dict[Any, List[Tuple[float, float, str]]] = {}
        alias = {}  # the ids a launch event may name a thread by
        for (native, ident), a, b, name in spans:
            self.spans.setdefault(native, []).append((a + shift, b + shift, name))
            for key in (native, ident, ident & 0xFFFFFFFF, ident - (1 << 64) if ident >> 63 else ident):
                alias[key] = native
        for v in self.spans.values():
            v.sort()
        self._starts = {k: [s for s, _, _ in v] for k, v in self.spans.items()}
        self.launch = {c: (alias.get(tid, tid), t) for c, (tid, t) in self.launch.items()}
        self.by_thread = sum(1 for tid, _ in self.launch.values() if tid in self.spans)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window."""
        out: List[List[float]] = []
        for s, e, _, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def span_at(self, thread, t: float) -> Optional[str]:
        """The innermost span open on `thread` at time `t`."""
        spans = self.spans.get(thread)
        if not spans:
            return None
        i = bisect.bisect_right(self._starts[thread], t) - 1
        best = None
        for s, e, name in reversed(spans[max(0, i - 64):i + 1]):
            if s <= t <= e and (best is None or s >= best[0]):
                best = (s, e, name)
        return best[2] if best else None

    def span_of_launch(self, where) -> Optional[str]:
        """The span a launch (thread, time) ran in: on its own thread; where
        the trace names the thread by an id the spans do not carry, the
        shortest span of any thread open at that time."""
        if where is None:
            return None
        tid, t = where
        if tid in self.spans:
            return self.span_at(tid, t)
        best = None
        for th, spans in self.spans.items():
            i = bisect.bisect_right(self._starts[th], t)
            for s, e, name in spans[max(0, i - 64):i]:
                if e >= t and (best is None or e - s < best[1] - best[0]):
                    best = (s, e, name)
        return best[2] if best else None

    def describe(self) -> str:
        """How the launches met the spans' threads (a check of the
        attribution, printed by traced runs)."""
        tids = {tid for tid, _ in self.launch.values()}
        return (f"{len(self.launch)} launches on {len(tids)} threads, {self.by_thread} on a "
                f"thread with spans ({len(self.spans)} span threads); window "
                f"{self.window_s:.3f} s, busy {self.busy_s:.3f} s")

    def kernels_by_span(self) -> List[Tuple[str, str, float]]:
        """(span name or None, device op name, seconds) of each device
        operation inside the window, by the span its launch ran in."""
        out = []
        for s, e, name, corr in self.device:
            if e <= self.t0 or s >= self.t1:
                continue
            out.append((self.span_of_launch(self.launch.get(corr)), name, e - s))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List[List[Any]]]:
        ops: Dict[str, float] = {}
        for s, e, name, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e > s:
                ops[op_name(name)] = ops.get(op_name(name), 0.0) + (e - s)
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = []
        for a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            host = sorted({n.split("#")[0] for th in self.spans
                           for n in [self.span_at(th, mid)] if n})
            idle.append(["+".join(host) or "no span", b - a])
        return {"device_ops": [[k, v] for k, v in
                               sorted(ops.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": idle}
