"""Serving cells: NVILA answering image questions through the program's
`ContinuousBatcher` over a `GenerationEngine`, the deployment's W4A16 LLM
and W8A8 tower quantized by the program in set-up.

The load is an open loop: independent users arriving at the cell's rate,
each request timed from when it was due. A run has a lead-in, the
measured window and a tail that keeps the load on until the window's
requests have finished. Requests are greedy with an exact length (no stop
token). Every request is sent from the main thread. Its tokens are taken
as the batcher hands them out: each `put` on the output queue that
`submit` returned is stamped on the batcher's own thread, so no reader
thread of the benchmark competes with the batcher for the interpreter.
A traced run profiles a few seconds after the window, under the same
load, so its window is timed as an untraced run's is.

After the window: the device's peak memory is read, the program's state is
freed, and a sample of finished requests (drawn from the seed, the
longest among them) is held against the plain reference
(`reference/vlm.py`): the widest gap by which a served token's logit lies
below the reference's best at its position.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from typing import Any, Dict, List

from port_bench import harness, program, trace, traffic, weights
from port_bench.tokenizer import ByteTokenizer

WARMUP_GRID = 32  # warm-up prompts every this many tokens over the mix's range
WARMUP_WAIT_S = 120.0  # a warm-up request's wait for its last token


def build_engine(torch, config: Dict[str, Any], seed: int, device):
    """The deployment: seeded bf16 weights made on the device, the LLM
    quantized to W4A16 and the tower's encoder linears to W8A8 by the
    program's quantizers, in a `GenerationEngine`."""
    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import siglip
    from vila_tpu_torch.ops import quant

    dep = config["deployment"]
    if dep["llm_weights"] != "w4a16" or dep["vision_weights"] != "w8a8":
        raise ValueError(f"the serving driver runs W4A16 + W8A8, not {dep}")
    cfg = program.vlm_config(config, dep["compute_dtype"], config["image_aspect_ratio"])
    tree = weights.vlm_tree(torch, config, seed, device, getattr(torch, dep["compute_dtype"]))
    llm = quant.quantize_llm_params(tree.pop("llm"), group_size=dep["w4_group_size"],
                                    fuse=True, cfg=cfg.llm)
    tower = siglip.quantize_siglip_w8a8(tree.pop("vision_tower"))
    params = {"llm": llm, "vision_tower": tower, "mm_projector": tree.pop("mm_projector")}
    return GenerationEngine(params, cfg, ByteTokenizer(), device=device)


class Client:
    """One request's record as its client sees it."""

    def __init__(self, spec: Dict[str, Any], due: float):
        self.spec = spec
        self.due = due  # host clock
        self.sent = None
        self.times: List[float] = []
        self.tokens: List[int] = []
        self.error = None
        self.done = threading.Event()
        self.late = 0  # items handed over before `attach` took the stream
        self._lock = threading.Lock()

    def take(self, item, t: float) -> None:
        """One item of the stream: token ids, an exception, or the None
        that ends it."""
        if item is None:
            self.done.set()
        elif isinstance(item, BaseException):
            self.error = repr(item)
        else:
            self.tokens.extend(item)
            self.times.extend([t] * len(item))

    def attach(self, out) -> None:
        """Take the stream of `out` (the queue `submit` returned) as the
        batcher puts to it: each item is stamped with the host clock on
        the putting thread and kept here, and the queue stays empty.
        Anything put before the hook is stamped now, later than it came
        and never earlier."""
        def stamped(item, *a, **kw):
            t = time.perf_counter()
            with self._lock:
                self.take(item, t)

        with self._lock:
            out.put = stamped
            while True:
                try:
                    item = out.get_nowait()
                except queue.Empty:
                    break
                self.late += 1
                self.take(item, time.perf_counter())

    @property
    def finished(self) -> bool:
        return (self.done.is_set() and self.error is None
                and len(self.tokens) == self.spec["new_tokens"])


def submit(batcher, gen_config, images, c: Client) -> None:
    """Send a request and take its stream; a refused request is a failed
    one."""
    c.sent = time.perf_counter()
    try:
        out = batcher.submit([images[c.spec["image"]], c.spec["question"]],
                             gen_config(max_new_tokens=c.spec["new_tokens"],
                                        stop_token_ids=(-1,)))
    except Exception as e:  # noqa: BLE001 - a refused request is a failed one
        c.error = repr(e)
        c.done.set()
        return
    c.attach(out)


class Schedule:
    """Actions at fixed host times, run by the main thread whenever it
    waits (`sleep_until`): the window's marks, the profiler's start and
    stop."""

    def __init__(self, events):
        self.events = sorted(events, key=lambda e: e[0])

    def add(self, t: float, action) -> None:
        self.events = sorted(self.events + [(t, action)], key=lambda e: e[0])

    def poll(self, now: float) -> None:
        while self.events and now >= self.events[0][0]:
            self.events.pop(0)[1]()

    def next_time(self) -> float:
        return self.events[0][0] if self.events else float("inf")


def sleep_until(t: float, sched: Schedule) -> None:
    while True:
        now = time.perf_counter()
        sched.poll(now)
        if now >= t:
            return
        time.sleep(max(0.0, min(t, sched.next_time(), now + 0.05) - now))


def run_open(batcher, gen_config, images, reqs, t0, w0, w1, tail_end, sched, hold=None):
    """Send each request at its due time (host clock t0 + due). After the
    window the load goes on until the window's requests are done and
    `hold()` (if given) is false, or the tail's time is up."""
    clients, window = [], []

    def busy():
        return (not all(c.done.is_set() for c in window)
                or (hold is not None and hold()))

    for spec in reqs:
        due = t0 + spec["due"]
        if due >= tail_end or (due >= w1 and not busy()):
            break
        sleep_until(due, sched)
        c = Client(spec, due)
        clients.append(c)
        if w0 <= due < w1:
            window.append(c)
        submit(batcher, gen_config, images, c)
    while time.perf_counter() < tail_end and busy():
        sleep_until(time.perf_counter() + 0.05, sched)
    return clients


def waiting(clients: List[Client], t: float) -> int:
    """Requests due by host time t that had no first token by then: the
    backlog a user sees."""
    return sum(1 for c in clients if c.due <= t and not (c.times and c.times[0] <= t))


def question_lengths(traffic_cfg: Dict[str, Any]) -> List[int]:
    """Question lengths to warm up: a grid over the mix's range."""
    q = traffic_cfg["question_tokens"]
    lo = q.get("min", q.get("uniform", [0])[0])
    hi = q.get("max", q.get("uniform", [0, 0])[-1])
    return sorted(set(list(range(lo, hi, WARMUP_GRID)) + [hi]))


def warm_up(batcher, gen_config, images, traffic_cfg, seed) -> None:
    """One short request per grid point of the mix's question lengths, so
    every prompt shape the traffic takes has run once."""
    r = traffic.rng(seed, "warmup")
    for n in question_lengths(traffic_cfg):
        spec = {"question": traffic.question_text(r, n), "new_tokens": 2,
                "image": int(r.integers(0, len(images)))}
        c = Client(spec, time.perf_counter())
        submit(batcher, gen_config, images, c)
        c.done.wait(timeout=WARMUP_WAIT_S)
        if not c.finished:
            raise RuntimeError(f"warm-up request failed: {c.error}")


def install_spans(batcher, engine, run: Dict[str, Any], spans) -> None:
    """The traced run's spans around the batcher's and engine's calls: a
    decode step (with the cache rows each active slot reads), a media
    encode, a prefill (with its real prompt length), a slot insert and
    a request's host preparation."""
    steps: Dict[int, Dict[str, Any]] = {}
    prefills: Dict[int, int] = {}
    run["steps"], run["prefills"], run["step_offset"] = steps, prefills, batcher.steps
    count = {"step": 0, "vision": 0, "prefill": 0}

    def step_name(active):
        k = count["step"]
        count["step"] += 1
        steps[k] = {"rows": [s.position for s in batcher.slots if s.active],
                    "t": time.perf_counter()}
        return f"decode_step#{k}"

    def numbered(kind, record=None):
        def name(*a, **kw):
            k = count[kind]
            count[kind] += 1
            if record is not None:
                record(k, *a, **kw)
            return f"{kind}#{k}"
        return name

    def prefill_len(k, ids, valid, media_embeds, media_pos, cache, prompt_len):
        prefills[k] = int(prompt_len)

    spans.wrap(batcher, "_step", step_name)
    spans.wrap(engine, "encode_media", numbered("vision"))
    spans.wrap(engine, "_prefill", numbered("prefill", prefill_len))
    spans.wrap(batcher, "_insert", lambda *a, **kw: "insert")
    spans.wrap(engine, "prepare_inputs", lambda *a, **kw: "prepare_inputs")


def sample(clients: List[Client], seed: int, tokens: int, limit: int) -> List[Client]:
    """Finished requests for the check, drawn from the seed: the longest,
    then others in a random order until `tokens` served tokens or `limit`
    requests."""
    done = [c for c in clients if c.finished]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    order = [longest] + [int(i) for i in traffic.rng(seed, "sample").permutation(len(done))
                         if i != longest]
    out, n = [], 0
    for i in order:
        if n >= tokens or len(out) >= limit:
            break
        out.append(done[i])
        n += len(done[i].tokens)
    return out


def check(torch, config, seed, picked: List[Client], images, device, control=False):
    """The widest gap, over every served token of the sample, by which its
    logit lies below the reference's best; with `control`, also the widest
    gap of the tokens the fp8 control (`reference/vlm.py`) puts first at
    the same positions."""
    from port_bench.reference import vlm as ref

    items = [{"pixels": images[c.spec["image"]], "question": c.spec["question"],
              "tokens": c.tokens} for c in picked]
    rows = ref.served_logits(torch, config, seed, items, device)
    out = {"gap": max(max(ref.gaps(torch, r, c.tokens)) for r, c in zip(rows, picked))}
    if control:
        low = ref.served_logits(torch, config, seed, items, device, act="fp8")
        out["control_gap"] = max(max(ref.gaps(torch, r, lo.argmax(-1).tolist()))
                                 for r, lo in zip(rows, low))
    return out


def window_metrics(clients: List[Client], w0: float, w1: float, seconds: float):
    """The readings of a window (ms, tokens/s) and counts."""
    due = [c for c in clients if w0 <= c.due < w1]
    ttft = [1e3 * (c.times[0] - c.due) if c.times and c.error is None else float("inf")
            for c in due]
    gaps = [1e3 * (b - a) for c in clients for a, b in zip(c.times, c.times[1:])
            if w0 <= b < w1]
    toks = sum(1 for c in clients for t in c.times if w0 <= t < w1)
    late = [c.sent - c.due for c in due if c.sent is not None]
    out = {f"ttft_p{q}_ms": harness.percentile(ttft, q) if ttft else None for q in (50, 90, 99)}
    out.update({f"itl_p{q}_ms": harness.percentile(gaps, q) if gaps else None
                for q in (50, 90, 95, 99)})
    out.update(out_tok_s=toks / seconds, due=due, ttft=ttft, late_s=late)
    return out


READINGS = ("ttft_p50_ms", "ttft_p90_ms", "ttft_p99_ms", "itl_p50_ms", "itl_p90_ms",
            "itl_p95_ms", "itl_p99_ms", "out_tok_s")


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    """One run of a serving cell: set-up, lead-in, window, tail (and, in a
    traced run, the profiled seconds after the window), then the check.
    Returns the driver's record (see `run.py`)."""
    import torch

    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    config, mix, work = cell["config"], cell["traffic"], cell["workload"]
    on_card = device.type == "cuda"
    if on_card:
        _build.build_all()
    engine = build_engine(torch, config, seed, device)
    batcher = ContinuousBatcher(engine, max_batch=work["max_batch"], max_len=work["max_len"])
    images = traffic.pool_images(mix, seed)
    warm_up(batcher, GenerationConfig, images, mix, seed)
    rec: Dict[str, Any] = {"config": config, "layers": config["llm"]["num_hidden_layers"]}
    session = None
    if ctx["trace"]:
        session = trace.Session(ctx["trace_path"])
        install_spans(batcher, engine, rec, session.spans)
        session.warm()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t_start"]
    _build.reset_launches()
    steps_start = batcher.steps

    t0 = time.perf_counter() + 0.05
    w0 = t0 + mix["lead_in_s"]
    w1 = w0 + seconds
    marks: Dict[str, Any] = {}

    def mark(name):
        def act():
            marks[name] = (time.perf_counter(), batcher.steps, list(batcher.step_seconds))
        return act

    sched = Schedule([(w0, mark("w0")), (w1, mark("w1"))])
    hold = None
    if session is not None:
        def start_trace():
            session.start()
            sched.add(time.perf_counter() + mix["trace_s"], stop_trace)

        def stop_trace():
            session.stop()
            mark("tr1")()

        sched.add(w1 + mix["trace_after_s"], start_trace)
        hold = lambda: "tr1" not in marks  # noqa: E731 - the load stays on until then
    try:
        reqs = traffic.open_loop(mix, work["rate_per_s"], seconds, seed)
        clients = run_open(batcher, GenerationConfig, images, reqs, t0, w0, w1,
                           w1 + mix["tail_limit_s"], sched, hold)
        sched.poll(float("inf"))
    finally:
        batcher.shutdown()
    launches = dict(_build.LAUNCHES)
    steps_run = batcher.steps - steps_start
    memory_peak = (int(torch.cuda.max_memory_allocated(device)) if on_card else 0)

    wm = window_metrics(clients, w0, w1, seconds)
    failed = [c for c in wm["due"] if not c.finished]
    (_, s0, _), (_, s1, walls) = marks["w0"], marks["w1"]
    step_walls = walls[len(walls) - (s1 - s0):] if s1 > s0 else []
    picked = sample(wm["due"], seed, mix["sample_tokens"], mix["sample_requests"])
    rec.update(
        setup_s=setup_s, clients=clients, window=(w0, w1), step_walls=list(step_walls),
        window_step_ids=list(range(s1 - len(step_walls), s1)),
        launches=launches, steps_in_window=s1 - s0, steps_run=steps_run,
        memory_peak=memory_peak, attempted=len(wm["due"]), failed=len(failed),
        metrics={k: wm[k] for k in READINGS}, trace=trace.summarise(session))
    late = sorted(wm["late_s"])
    harness.log("[serve] window: " + ", ".join(f"{k} {wm[k]!r}" for k in READINGS)
                + f", requests finished {sum(c.finished for c in wm['due'])}")
    harness.log(
        f"[serve] {len(wm['due'])} requests in the window ({len(failed)} failed), "
        f"{sum(len(c.tokens) for c in clients)} tokens to {len(clients)} clients "
        f"({sum(c.late for c in clients)} stream items taken after their put); "
        f"{s1 - s0} decode steps in the window, {steps_run} in the run; requests "
        f"waiting for a first token at the window's start / end: {waiting(clients, w0)} / "
        f"{waiting(clients, w1)}; generator late by p50 "
        f"{1e3 * late[len(late) // 2] if late else 0:.2f} ms, "
        f"max {1e3 * late[-1] if late else 0:.2f} ms")
    for c in failed[:3]:
        harness.log(f"[serve] failed: due {c.due - w0:.3f} s into the window, "
                    f"{len(c.tokens)} of {c.spec['new_tokens']} tokens, error {c.error}")
    if step_walls:
        harness.log(f"[serve] decode step wall in the window: mean "
                    f"{1e3 * sum(step_walls) / len(step_walls):.2f} ms over {len(step_walls)} steps")
    route = ("K6 (fused_layer_batched)" if work["max_batch"] <= 16
             else "K4/K5 (fused_o_gateup, fused_down_qkv)")
    harness.log(f"[serve] route {route}: launches {launches}; layers x steps = "
                f"{rec['layers']} x {steps_run} = {rec['layers'] * steps_run}")

    # the check runs once the program's state is freed
    del batcher, engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    got = (check(torch, config, seed, picked, images, device, ctx.get("control", False))
           if picked else {"gap": float("inf")})
    gap = got["gap"]
    rec["control_gap"] = got.get("control_gap")
    harness.log(f"[serve] check: {len(picked)} requests, "
                f"{sum(len(c.tokens) for c in picked)} served tokens against the reference "
                f"in {time.perf_counter() - t:.1f} s; widest logit gap {gap!r}"
                + (f", the fp8 control's {rec['control_gap']!r}" if "control_gap" in got else ""))
    rec["compared"] = {"logit_gap": {"value": gap, "limit": work["limits"]["logit_gap"]}}
    rec["correct"] = (not failed and bool(picked)
                      and gap <= work["limits"]["logit_gap"])
    return rec
