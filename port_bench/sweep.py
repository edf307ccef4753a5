"""Find the knee of an open-loop serving cell: the highest arrival rate at
which the backlog does not grow over a window and the generator keeps
time. One process builds the deployment once, then runs the cell's
traffic at each rate and seed in turn (lead-in, window, tail) and prints a
line for each. Run once when a cell's rate is chosen, on the card:

    python3 port_bench/sweep.py --workload nvila8b-chat --seed 7 --seconds 50 \
        --rates 1.2 1.6 2.0 2.4 --repeats 3

The backlog is the number of requests due that have no first token yet,
read from the clients' own records. A rate holds on a seed when the
backlog's mean over the window's last `--edge` seconds exceeds its mean
over the first by less than one request, every request of the window
finished, and the generator ran late by under 50 ms; the knee is the
highest rate that holds on every seed, as does every rate below it. The cell's rate
(`workloads/<cell>.json`) is then set to about four fifths of the knee.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness, traffic  # noqa: E402
from port_bench.drivers import serve  # noqa: E402


LATE_LIMIT_S = 0.05  # the generator keeps time when no request is sent later


def mean_waiting(clients, t_from: float, t_to: float, step: float = 0.1) -> float:
    """The backlog's mean over [t_from, t_to), read every `step` seconds."""
    ts = [t_from + i * step for i in range(max(1, int((t_to - t_from) / step)))]
    return sum(serve.waiting(clients, t) for t in ts) / len(ts)


def at_rate(batcher, gen_config, images, mix, rate, seconds, seed, edge):
    t0 = time.perf_counter() + 0.05
    w0 = t0 + mix["lead_in_s"]
    w1 = w0 + seconds
    marks = {}

    def mark(name):
        def act():
            marks[name] = batcher.steps
        return act

    sched = serve.Schedule([(w0, mark("w0")), (w1, mark("w1"))])
    reqs = traffic.open_loop(mix, rate, seconds, seed)
    clients = serve.run_open(batcher, gen_config, images, reqs, t0, w0, w1,
                             w1 + mix["tail_limit_s"], sched)
    sched.poll(float("inf"))
    for c in clients:  # the tail's requests finish before the next rate
        c.done.wait(timeout=120)
    wm = serve.window_metrics(clients, w0, w1, seconds)
    late = sorted(wm["late_s"])
    first, last = mean_waiting(clients, w0, w0 + edge), mean_waiting(clients, w1 - edge, w1)
    failed = sum(1 for c in wm["due"] if not c.finished)
    late_max = late[-1] if late else 0.0
    return {"rate_per_s": rate, "seed": seed, "requests": len(wm["due"]), "failed": failed,
            "backlog_start": serve.waiting(clients, w0), "backlog_end": serve.waiting(clients, w1),
            "backlog_mean_first": first, "backlog_mean_last": last,
            "holds": bool(last - first < 1.0 and failed == 0 and late_max < LATE_LIMIT_S),
            "decode_steps": marks["w1"] - marks["w0"],
            **{k: wm[k] for k in serve.READINGS},
            "late_max_ms": 1e3 * late_max}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--repeats", type=int, default=1, help="seeds a rate")
    p.add_argument("--edge", type=float, default=10.0,
                   help="seconds at each end of the window whose backlog is compared")
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    harness.require_cards(cell["benchmark"]["chips"])
    import torch

    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    config, mix, work = cell["config"], cell["traffic"], cell["workload"]
    if mix["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    device = torch.device("cuda", 0)
    _build.build_all()
    engine = serve.build_engine(torch, config, args.seed, device)
    batcher = ContinuousBatcher(engine, max_batch=work["max_batch"], max_len=work["max_len"])
    images = traffic.pool_images(mix, args.seed)
    serve.warm_up(batcher, GenerationConfig, images, mix, args.seed)
    harness.log(f"[sweep] {args.workload} on {harness.nvidia_smi()}")
    holds = {}
    try:
        for k in range(args.repeats):
            for i, rate in enumerate(args.rates):
                row = at_rate(batcher, GenerationConfig, images, mix, rate, args.seconds,
                              args.seed + 1000 * k + i, args.edge)
                holds[rate] = holds.get(rate, True) and row["holds"]
                print(json.dumps(harness.finite(row)), flush=True)
    finally:
        batcher.shutdown()
    knee = None
    for rate in sorted(holds):  # the highest rate below which every rate holds
        if not holds[rate]:
            break
        knee = rate
    print(json.dumps({"knee_per_s": knee, "holds": holds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
