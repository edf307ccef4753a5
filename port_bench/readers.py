"""The per-layer metrics' arithmetic, shared by the readers in `metrics/`
(one file a metric, found by its name). A reader takes the driver's record
of a traced run and returns a number, or None where the run holds nothing
to read: the harness then leaves the metric out of the result line. No
reader returns 0 for a share it could not measure.

Span-based readings count only spans that opened and closed inside the
profiled window, so each has all its kernels in the trace.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from port_bench import flops
from port_bench.harness import PEAK_BF16_FLOPS


def _spans_inside(tr) -> set:
    return {name for spans in tr.spans.values() for s, e, name in spans
            if s >= tr.t0 and e <= tr.t1}


def _by_span(tr, kind: str, labels=None) -> Dict[str, float]:
    """Device seconds of the kernels launched inside each whole span of
    `kind` ("kind#n"), optionally only those with a K label in `labels`."""
    from port_bench.trace import kernel_label

    inside = _spans_inside(tr)
    out: Dict[str, float] = {}
    for sp, name, dur in tr.kernels_by_span():
        if sp is None or sp.split("#")[0] != kind or sp not in inside:
            continue
        if labels is not None and kernel_label(name) not in labels:
            continue
        out[sp] = out.get(sp, 0.0) + dur
    return out


def idle_share(rec: Dict[str, Any]) -> Optional[float]:
    tr = rec.get("trace")
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def decode_step_ms(rec: Dict[str, Any]) -> Optional[float]:
    walls = rec.get("step_walls")
    return 1e3 * sum(walls) / len(walls) if walls else None


def media_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Device ms per media encode (tower and projector, W8A8 linears)."""
    tr = rec.get("trace")
    per = _by_span(tr, "vision") if tr is not None else {}
    return 1e3 * sum(per.values()) / len(per) if per else None


def decode_roofline(rec: Dict[str, Any]) -> Optional[float]:
    """The least time of the traced decode steps' K6 layers and K1 output
    head, from the weight bytes and the live cache rows each step reads,
    over their device time."""
    tr = rec.get("trace")
    if tr is None:
        return None
    per = _by_span(tr, "decode_step", {"K6", "K1"})
    llm = rec["config"]["llm"]
    least = 0.0
    for sp in per:
        parts = flops.decode_step_least_s(llm, rec["steps"][int(sp.split("#")[1])]["rows"])
        least += parts["layers"] + parts["lm_head"]
    spent = sum(per.values())
    return 100.0 * least / spent if spent > 0 else None


def prefill_roofline(rec: Dict[str, Any]) -> Optional[float]:
    """K2's least time at each traced prefill's real prompt rows over its
    device time."""
    tr = rec.get("trace")
    if tr is None:
        return None
    per = _by_span(tr, "prefill", {"K2"})
    llm = rec["config"]["llm"]
    least = sum(flops.prefill_w4_least_s(llm, rec["prefills"][int(sp.split("#")[1])])
                for sp in per)
    spent = sum(per.values())
    return 100.0 * least / spent if spent > 0 else None


def decode_mfu(rec: Dict[str, Any]) -> Optional[float]:
    """Model FLOPs of the window's decode steps over the sum of their
    walls at the bf16 peak."""
    steps, walls = rec.get("steps"), rec.get("step_walls")
    if not steps or not walls:
        return None
    llm = rec["config"]["llm"]
    total = spent = 0.0
    for i, k in enumerate(rec["window_step_ids"]):
        rows = steps[k - rec["step_offset"]]["rows"]
        total += flops.llm_forward_flops(llm, len(rows), sum(rows), len(rows))
        spent += walls[i]
    return 100.0 * total / (spent * PEAK_BF16_FLOPS) if spent else None


def row_fill(rec: Dict[str, Any]) -> Optional[float]:
    """Non-padding share of the window's packed rows."""
    steps = rec.get("steps")
    if not steps:
        return None
    seq = rec["config"]["training"]["seq_len"] * rec["config"]["training"]["rows"]
    return 100.0 * sum(s["tokens"] for s in steps.values()) / (seq * len(steps))


def optimizer_ms(rec: Dict[str, Any]) -> Optional[float]:
    """Device ms per step of the kernels launched inside the optimizer's
    update."""
    tr = rec.get("trace")
    per = _by_span(tr, "optimizer") if tr is not None else {}
    return 1e3 * sum(per.values()) / len(per) if per else None


def flash_roofline(rec: Dict[str, Any]) -> Optional[float]:
    """The least time of the traced steps' attention (K7 forward, K8 + K9
    backward) over the (q, k) pairs the segment and causal masks allow,
    over their device time. The backward launches from autograd's own
    thread, so kernels are matched to a step by the time of their launch."""
    from port_bench.trace import kernel_label

    tr = rec.get("trace")
    if tr is None:
        return None
    inside = [(s, e, n) for spans in tr.spans.values() for s, e, n in spans
              if n.startswith("train_step#") and s >= tr.t0 and e <= tr.t1]
    spent, hit = 0.0, set()
    for s, e, name, corr in tr.device:
        if kernel_label(name) not in ("K7", "K8", "K9"):
            continue
        where = tr.launch.get(corr)
        for a, b, n in inside:
            if where and a <= where[1] <= b:
                spent += e - s
                hit.add(n)
                break
    llm = rec["config"]["llm"]
    least = 0.0
    for n in hit:
        st = rec["steps"][int(n.split("#")[1])]
        least += llm["num_hidden_layers"] * flops.flash_least_s(llm, st["pairs"], st["tokens"])
    return 100.0 * least / spent if spent > 0 else None


def train_mfu(rec: Dict[str, Any]) -> Optional[float]:
    """Model FLOPs of the window's steps (the LLM over each row's real
    tokens and masked pairs, the tower and projector over its tiles,
    forward and backward) over their walls at the bf16 peak; the steps
    beside the profiler left out."""
    steps = [s for s in rec.get("steps", {}).values() if not s["traced"]]
    if not steps:
        return None
    total = sum(flops.train_step_flops(rec["config"], s["tokens"], s["pairs"], s["tiles"])
                for s in steps)
    return 100.0 * total / (sum(s["wall"] for s in steps) * PEAK_BF16_FLOPS)


def window_stat(rec: Dict[str, Any], name: str) -> Optional[float]:
    """A client-side statistic of the traced run's window (the host clock,
    as the untraced runs take it)."""
    return rec.get("metrics", {}).get(name)
