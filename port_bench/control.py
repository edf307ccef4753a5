"""Read the controls that set the limits of a cell's check, on the card at
the cell's own size. Not part of a benchmark run.

Serving cells: short runs of the cell (its load, a short window) through
the driver, each also computing the fp8 control (`reference/vlm.py`,
`act="fp8"`) over the same prompts and served tokens: the program's
widest logit gap (a lower reading) and the control's (an upper one).

Training cells: the reference's first steps in float32 against the fp8
control and against the half-batch fault (`reference/train.py`), each
read as the check reads the program. A step that leaves the state
unchanged reads 1 on the change and needs no run.

    python3 port_bench/control.py --workload nvila8b-chat --seconds 10 --seeds 11 12 13
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


def serve_readings(cell, seed, seconds, device):
    ctx = {"cell": cell, "seed": seed, "seconds": seconds, "trace": False, "device": device,
           "t_start": time.perf_counter(), "control": True,
           "trace_path": os.path.join(harness.WORK, "trace.json")}
    rec = harness.driver(cell["workload"]["driver"]).run(ctx)
    return {"seed": seed, "program_logit_gap": rec["compared"]["logit_gap"]["value"],
            "control_logit_gap": rec["control_gap"], "attempted": rec["attempted"],
            "failed": rec["failed"]}


def train_readings(cell, seed, device):
    import torch

    from port_bench.drivers import train as drv
    from port_bench.reference import train as ref
    from port_bench.tokenizer import ByteTokenizer

    config, mix = cell["config"], cell["traffic"]
    tc = config["training"]
    tok = ByteTokenizer()
    per_image = (config["vision"]["image_size"] // config["vision"]["patch_size"] // 2) ** 2
    samples = traffic.train_samples(mix, config["llm"]["vocab_size"],
                                    tok.media_token_ids["image"], per_image, seed)
    rows = traffic.rows(samples, tc["seq_len"], mix["check_steps"])
    want = ref.steps(torch, config, seed, rows, device)
    out = {"seed": seed, "reference_losses": want["losses"]}
    for name, kw in (("fp8", {"act": "fp8"}), ("half_batch", {"fault": "half"})):
        got = ref.steps(torch, config, seed, rows, device, **kw)
        got.pop("batches")
        out[name] = drv.compare(got, want)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = harness.cell(args.workload)
    harness.require_cards(cell["benchmark"]["chips"])
    import torch

    device = torch.device("cuda", 0)
    harness.log(f"[control] {args.workload} on {harness.nvidia_smi()}")
    for seed in args.seeds:
        if cell["workload"]["driver"] == "train":
            row = train_readings(cell, seed, device)
        else:
            row = serve_readings(cell, seed, args.seconds, device)
        print(json.dumps(harness.finite(row)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
