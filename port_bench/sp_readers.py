"""The sequence-parallel cells' per-layer metrics (`metrics/*.sp4.py`),
read from rank 0's record: its traced window (`trace.Trace`) and the
program's spans that opened and closed inside it (`program_spans`, the
`vila_tpu_torch.utils.profiling` spans, on the trace's clock). A reading
is None where the run holds nothing to read: an untraced run, a program
without the span, or a window without a whole step.

A device operation belongs to a span when its launch, on any thread,
falls inside it (autograd launches the backward, the ring's and the
ZeRO-3 gradients' collectives included, from a thread of its own); the
spans a reading takes do not overlap one another. Per-step readings are
over the window's whole `train.step` spans and the spans inside them.
"""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Tuple

from port_bench import flops
from port_bench.harness import PEAK_BF16_FLOPS
from port_bench.program_spans import _launched, _named

NCCL = "nccl"


def _spans(rec: Dict[str, Any]) -> Optional[list]:
    if rec.get("trace") is None:
        return None
    return rec.get("program_spans") or None


def _steps(spans) -> int:
    return len(_named(spans, "train.step"))


def _is_nccl(name: str) -> bool:
    return NCCL in name.lower()


def _ops(rec, names: Tuple[str, ...], keep=lambda name: True) -> Optional[List[tuple]]:
    """(start, end, name) of each device operation launched inside a span
    named in `names`, None where the window has no step or no such span."""
    spans = _spans(rec)
    steps = _named(spans, "train.step") if spans else []
    if not steps:
        return None
    inside = sorted(iv for n in names for iv in _named(spans, n)
                    if any(a <= iv[0] and iv[1] <= b for a, b in steps))
    if not inside:
        return None
    tr = rec["trace"]
    ops = {(s, e) for _, s, e in _launched(tr, inside)}
    return [(s, e, name) for s, e, name, _ in tr.device if (s, e) in ops and keep(name)]


def span_ms(rec: Dict[str, Any], *names: str, nccl_only: bool = False) -> Optional[float]:
    """Device ms a step of the operations launched inside the `names`
    spans (only NCCL's kernels with `nccl_only`)."""
    ops = _ops(rec, names, _is_nccl if nccl_only else (lambda name: True))
    if ops is None:
        return None
    return 1e3 * sum(e - s for s, e, _ in ops) / _steps(_spans(rec))


def step_idle_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Device-idle ms inside a step, the mean over the window's steps: a
    step runs from its `train.step` span's start to the later of its end
    and the end of the last operation launched inside it (as
    `program_spans.steps`)."""
    spans = _spans(rec)
    named = _named(spans, "train.step") if spans else []
    if not named:
        return None
    tr = rec["trace"]
    ends = [e for _, e in named]
    for i, _, e in _launched(tr, named):
        ends[i] = max(ends[i], e)
    busy = tr.busy_intervals()
    idle = 0.0
    for (a, _), b in zip(named, ends):
        b = min(b, tr.t1)
        idle += (b - a) - sum(max(0.0, min(b, e) - max(a, s)) for s, e in busy)
    return 1e3 * idle / len(named)


def data_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Host ms of one `data.collate` plus one `train.to_device`, each the
    mean of its spans in the window."""
    spans = _spans(rec)
    parts = [_named(spans, n) for n in ("data.collate", "train.to_device")] if spans else []
    if not parts or not all(parts):
        return None
    return 1e3 * sum(statistics.fmean(e - s for s, e in p) for p in parts)


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(a, b) for a, b in out]


def exposed_ms(rec: Dict[str, Any], *names: str) -> Optional[float]:
    """Device ms a step of the NCCL kernels launched inside the `names`
    spans during which no compute kernel (any kernel but NCCL's, copies
    and memsets) ran."""
    ops = _ops(rec, names, _is_nccl)
    if ops is None:
        return None
    tr = rec["trace"]
    compute = _union((s, e) for s, e, name, _ in tr.device
                     if not _is_nccl(name) and not name.startswith(("Memcpy", "Memset")))
    exposed = 0.0
    for s, e in _union((s, e) for s, e, _ in ops):
        covered = sum(max(0.0, min(e, b) - max(s, a)) for a, b in compute if a < e and b > s)
        exposed += (e - s) - covered
    return 1e3 * exposed / _steps(_spans(rec))


def flash_roofline(rec: Dict[str, Any]) -> Optional[float]:
    """The least time of rank 0's attention in the traced steps (K7
    forward, K8 + K9 backward, once a layer) for the (q, k) pairs the
    causal and segment masks allow its queries, over the device time of
    the K7-K9 launches inside those steps (the recomputed forward
    included). Steps are the driver's `train_step#k` spans inside the
    window."""
    from port_bench.trace import kernel_label

    tr = rec.get("trace")
    if tr is None:
        return None
    inside = sorted((s, e, int(n.split("#")[1])) for spans in tr.spans.values()
                    for s, e, n in spans
                    if n.startswith("train_step#") and s >= tr.t0 and e <= tr.t1)
    spent, hit = 0.0, set()
    for s, e, name, corr in tr.device:
        where = tr.launch.get(corr)
        if where is None or kernel_label(name) not in ("K7", "K8", "K9"):
            continue
        for a, b, k in inside:
            if a <= where[1] <= b:
                spent += e - s
                hit.add(k)
                break
    if spent <= 0:
        return None
    llm = rec["config"]["llm"]
    least = sum(llm["num_hidden_layers"] * flops.flash_least_s(
        llm, rec["steps"][k]["rank_pairs"], rec["steps"][k]["rank_tokens"]) for k in hit)
    return 100.0 * least / spent


def train_mfu(rec: Dict[str, Any], chips: int) -> Optional[float]:
    """Model FLOPs of the window's untraced steps (the LLM over each row's
    real tokens and masked pairs, the tower and projector over its frames,
    forward and backward, recomputation not counted) over their walls at
    `chips` x the bf16 peak."""
    steps = [s for s in rec.get("steps", {}).values() if not s["traced"]]
    if not steps or rec.get("trace") is None:
        return None
    total = sum(flops.train_step_flops(rec["config"], s["tokens"], s["pairs"], s["tiles"])
                for s in steps)
    return 100.0 * total / (sum(s["wall"] for s in steps) * chips * PEAK_BF16_FLOPS)
