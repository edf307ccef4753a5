"""Profiling and metrics, as `vila_tpu/utils/profiling.py`:

  * `annotate(name, **attrs)` — a span: a named host interval with its id,
    its parent (the innermost span open on the same thread, or `parent=`),
    the request it serves (`request=`), the thread's native id and attrs;
    over a `with` block, or from now until its `.end()`, which any thread
    may call (a request's life, its waits in queues). Spans are kept only
    while recording is on: while a torch profiler runs in the process,
    whoever started it (a `with` span then also shows in its trace as a
    `record_function` region), or inside `recording()`. Off, `annotate`
    returns one shared no-op and enters no `record_function`;
  * `recorded()` — the kept spans on the clock of the exported Chrome
    trace, ready to lay over its device events;
  * `trace(logdir)` — a `torch.profiler` trace of every thread (CPU and,
    on the card, CUDA activity) of the enclosed block, written to `logdir`
    as a Chrome trace plus a table of the ops by device time;
  * `MetricsLogger` — a `metrics.jsonl` stream, mirrored to wandb when it
    imports and starts (a failing `wandb.init` leaves the stream alone).

Spans are stamped in Unix ns (`time.time_ns`), the clock the profiler
converts its own stamps to, and read back in seconds since the exported
trace's `baseTimeNanoseconds`.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

SPAN_CAPACITY = 1 << 17  # spans kept; the oldest go first

_kept: Deque[tuple] = collections.deque(maxlen=SPAN_CAPACITY)
_ids = itertools.count(1)
_open = threading.local()
_recording = 0  # open `recording()` blocks
_recording_lock = threading.Lock()
_base_ns: Optional[int] = None


class Span(NamedTuple):
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    thread: int  # native id, as the Chrome trace's `tid`
    start: float  # seconds since the trace's baseTimeNanoseconds
    end: float
    attrs: Dict[str, Any]


class _Off(tuple):
    """The span handed out while recording is off: it records nothing. It
    is falsy as an empty tuple is, and its `__enter__` / `__exit__` (set
    below) are C callables, so a `with` over it runs no Python code."""

    __slots__ = ()
    id = None

    def set(self, **attrs):
        pass

    def end(self, **attrs):
        pass


OFF = _Off()
# `with` looks both up on the type and calls them as they are: the first
# returns OFF, the second "" (falsy, so an exception in the block goes on)
_Off.__enter__ = itertools.repeat(OFF).__next__
_Off.__exit__ = "".format


class _Span:
    __slots__ = ("name", "id", "parent", "request", "attrs", "thread", "t0", "_region")

    def __init__(self, name, parent, request, attrs):
        self.name, self.request, self.attrs = name, request, attrs
        self.id = next(_ids)
        here = _here()
        if parent is None and here.stack:
            parent = here.stack[-1].id
        self.parent = parent
        self.thread = here.thread
        self._region = None
        self.t0 = time.time_ns()

    def set(self, **attrs):
        """Add attrs known only once the work ran."""
        self.attrs.update(attrs)

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            region = _profiler.record_function(self.name)
            region.__enter__()
            self._region = region
        _here().stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end()
        _here().stack.pop()
        if self._region is not None:
            self._region.__exit__(None, None, None)
        return False

    def end(self, **attrs):
        """Close the span (once; later calls do nothing)."""
        if self.t0 is None:
            return
        t1 = time.time_ns()
        self.attrs.update(attrs)
        _kept.append((self.name, self.id, self.parent, self.request, self.thread, self.t0, t1,
                      self.attrs))
        self.t0 = None


def _here():
    """This thread's open spans and native id (read once: a system call)."""
    if not hasattr(_open, "thread"):
        _open.stack, _open.thread = [], threading.get_native_id()
    return _open


def annotate(name: str, *, parent: Optional[int] = None, request: Optional[int] = None,
             **attrs):
    """A span over the `with` block, the thread's innermost inside it; or,
    outside a `with`, open from now until its `.end(**attrs)`, and no
    thread's parent. `set()` adds attrs. Off, the shared no-op `OFF`, which
    is falsy, so attrs that cost work can wait for `if span:`."""
    if not (_recording or _profiler._is_profiler_enabled):
        return OFF
    return _Span(name, parent, request, attrs)


@contextlib.contextmanager
def recording():
    """Keep spans inside the block with no profiler running."""
    global _recording
    with _recording_lock:
        _recording += 1
    try:
        yield
    finally:
        with _recording_lock:
            _recording -= 1


def _trace_base_ns() -> int:
    """The `baseTimeNanoseconds` torch's Chrome trace export writes (its
    events' `ts` count microseconds from it), read once from the export
    of an empty CPU profile; 0 where the export writes none."""
    global _base_ns
    if _base_ns is None:
        from torch.profiler import ProfilerActivity, profile

        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "probe.json")
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                pass
            prof.export_chrome_trace(path)
            with open(path) as f:
                _base_ns = int(json.load(f).get("baseTimeNanoseconds", 0))
    return _base_ns


def _number(v):
    return v.item() if isinstance(v, torch.Tensor) and v.numel() == 1 else v


def recorded() -> List[Span]:
    """The kept spans in the order they ended, timed in seconds since the
    exported Chrome trace's base (its events' `ts` / 1e6), so they lay
    over a trace's device events with no shift; one-element tensors among
    the attrs read as numbers. Call it with no profiler running (the first
    call exports an empty profile to learn the base)."""
    items = list(_kept)
    if not items:
        return []
    base = _trace_base_ns()
    return [Span(name, sid, parent, req, thread, (t0 - base) * 1e-9, (t1 - base) * 1e-9,
                 {k: _number(v) for k, v in attrs.items()})
            for name, sid, parent, req, thread, t0, t1, attrs in items]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block, on every thread, into `logdir`
    (trace.json, ops.txt)."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


class MetricsLogger:
    """Append-only metrics.jsonl + optional wandb mirror."""

    def __init__(
        self,
        output_dir: str,
        project: Optional[str] = None,
        run_name: Optional[str] = None,
    ) -> None:
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if project:
            try:
                import wandb

                self._wandb = wandb.init(project=project, name=run_name, dir=output_dir)
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None):
        rec = dict(metrics)
        if step is not None:
            rec["step"] = step
        rec["time"] = time.time()
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
