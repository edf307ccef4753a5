"""Training checkpoints and preemption, as `vila_tpu/train/checkpoint.py`.

`CheckpointManager` writes one directory per step, `checkpoint-<step>/`,
holding the state (`torch.save` of a tree of tensors, for example
{params, opt_state}), plus a `metadata-<step>.json` sidecar. A save is
atomic: it is written into a temporary directory that is then renamed, so a
`checkpoint-<step>` directory is always complete. Only the newest
`max_to_keep` steps are kept. Saves are synchronous (`wait` returns at
once).

`PreemptionGuard` is the JAX package's: save-and-stop on SIGTERM or near a
walltime limit, exit code 124.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import signal
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

_STEP_DIR = re.compile(r"^checkpoint-(\d+)$")


class CheckpointManager:
    """save(step, state) / restore(step) over `dir/checkpoint-<step>/`."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_STEP_DIR.match, os.listdir(self.directory))
                      if m and os.path.isdir(os.path.join(self.directory, m.group(0))))

    def save(self, step: int, state: Any, metadata: Optional[Dict] = None) -> None:
        tmp = os.path.join(self.directory, f".checkpoint-{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        final = self._path(step)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if metadata is not None:
            with open(os.path.join(self.directory, f"metadata-{step}.json"), "w") as f:
                json.dump(metadata, f)
        for old in self.steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self._path(old), ignore_errors=True)
            meta = os.path.join(self.directory, f"metadata-{old}.json")
            if os.path.exists(meta):
                os.remove(meta)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, map_location=None) -> Any:
        """The state saved at `step`, its tensors on `map_location`."""
        return torch.load(os.path.join(self._path(step), "state.pt"),
                          map_location=map_location, weights_only=True)

    def restore_latest(self, map_location=None) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, map_location)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""

    def close(self) -> None:
        """Nothing is held open."""


class PreemptionGuard:
    """Cooperative save-and-stop on SIGTERM/walltime.

    Usage: check `guard.should_stop(step)` each step; when True the caller
    saves and exits with code 124 (the reference's timeout convention, which
    `vila-run` retries indefinitely — llava/cli/run.py:117-131).
    """

    EXIT_CODE = 124

    def __init__(
        self,
        total_time_limit_s: Optional[float] = None,
        save_margin_s: float = 300.0,
        signals=(signal.SIGTERM,),
    ) -> None:
        self._start = time.monotonic()
        self._limit = total_time_limit_s
        self._margin = save_margin_s
        self._signaled = False
        for sig in signals:
            try:
                signal.signal(sig, self._handler)
            except ValueError:
                pass  # not in main thread

    def _handler(self, signum, frame):
        self._signaled = True

    @property
    def preempted(self) -> bool:
        return self._signaled

    def should_stop(self, step: int = 0) -> bool:
        if self._signaled:
            return True
        if self._limit is not None:
            return (
                time.monotonic() - self._start
                >= self._limit - self._margin
            )
        return False
