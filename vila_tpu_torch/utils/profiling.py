"""Profiling and metrics, as `vila_tpu/utils/profiling.py`:

  * `trace(logdir)` — a `torch.profiler` trace (CPU and, on the card,
    CUDA activity) of the enclosed block, written to `logdir` as a Chrome
    trace plus a table of the ops by device time;
  * `annotate(name)` — a named host-side region (`record_function`): it
    shows in the trace's timeline, with the card's work beneath it, and
    as a row of the op table;
  * `device_memory_stats()` — current and peak allocated bytes per card;
  * `MetricsLogger` — a `metrics.jsonl` stream, mirrored to wandb when it
    imports and starts (a failing `wandb.init` leaves the stream alone).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block into `logdir` (trace.json, ops.txt)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    sort = "self_device_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(logdir, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=50))


def annotate(name: str):
    """Host-side named region (shows up in the trace timeline)."""
    from torch.profiler import record_function

    return record_function(name)


def device_memory_stats() -> Dict[str, Any]:
    """Per-card allocator stats (parity: GPU memory prints, train.py:887)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


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
