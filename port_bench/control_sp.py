"""The fp8 control of the sequence-parallel training cell's check, read on
the cards at the cell's own size: the plain reference's first-step loss on
the check's row with every linear's input and weight rounded to float8
e4m3 (`reference/long_train.loss`, `act="fp8"`), a forward only. Its gap
to the float32 loss (`--f32`, or the check's own log of a run with the
same seed) is read as the check reads the loss. Not part of a benchmark
run.

    python3 port_bench/control_sp.py --workload qwen2-7b-longvila-sp4 --seed 11 [--f32]
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

from port_bench import harness, longvideo  # noqa: E402
from port_bench import traffic  # noqa: E402
from port_bench.drivers.train_sp import check_row  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", default="qwen2-7b-longvila-sp4")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--f32", action="store_true", help="also the float32 loss")
    args = p.parse_args(argv)
    import torch

    from port_bench.reference import long_train as ref

    cell = harness.cell(args.workload)
    mix = cell["traffic"]
    row = longvideo.with_tiles(check_row(cell, args.seed), traffic.tile_pool(mix, args.seed))
    devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = {"workload": args.workload, "seed": args.seed, "devices": len(devices)}
    for act in (("f32", "fp8") if args.f32 else ("fp8",)):
        t = time.perf_counter()
        out[f"loss_{act}"] = ref.loss(torch, cell["config"], args.seed, row, devices, act,
                                      seq_len=mix["check_seq_len"])
        out[f"{act}_s"] = time.perf_counter() - t
        torch.cuda.empty_cache()
    if args.f32:
        out["loss_gap"] = abs(out["loss_fp8"] - out["loss_f32"]) / abs(out["loss_f32"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
