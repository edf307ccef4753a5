"""Run one cell of the port's benchmark on the card and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration and traffic
mix; `workloads/<cell>.json` names its driver (`drivers/<driver>.py`) and
holds the cell's own settings and the limits of its check. With
`--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (`metrics/<name>.py`), read from a
profiled sub-window, and a breakdown of the device's time.

The last line of standard output is the result (JSON); the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the result's last key. Without a card, or with JAX or
the JAX package loaded once the window has closed, it exits non-zero with
no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "port_bench", "_work", "cache")
# a library that would load JAX on its own keeps from it; every cache the
# run's libraries keep lives at a fixed path inside the checkout
for key, value in (("USE_FLAX", "0"), ("USE_TF", "0"),
                   ("TRITON_CACHE_DIR", os.path.join(CACHE, "triton")),
                   ("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions")),
                   ("CUDA_CACHE_PATH", os.path.join(CACHE, "cuda"))):
    os.environ[key] = value
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from port_bench import harness  # noqa: E402


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, rec, trace: bool):
    """The result's metrics, device record and breakdown from a driver's
    record."""
    metrics = {}
    if trace:
        for m in cell["per_layer"]:
            v = harness.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell["end_to_end"]:
            v = rec["setup_s"] if m["name"] == "setup_s" else rec["metrics"].get(m["name"])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    return metrics


def main(argv=None) -> int:
    args = parse(argv)
    cell = harness.cell(args.workload)
    chips = cell["benchmark"]["chips"]
    harness.require_cards(chips)
    import torch

    ctx = {"cell": cell, "seed": args.seed, "seconds": args.seconds, "trace": bool(args.trace),
           "device": torch.device("cuda", 0), "t_start": T_START,
           "trace_path": os.path.join(harness.WORK, "trace.json")}
    harness.log(f"[run] {args.workload} seed {args.seed} seconds {args.seconds} trace "
                f"{args.trace} on {harness.nvidia_smi()} (name, power limit, max SM clock)")
    rec = harness.driver(cell["workload"]["driver"]).run(ctx)
    metrics = result_line(cell, rec, bool(args.trace))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": rec["memory_peak"]}
    tr = rec.get("trace")
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
    numbers_ok = all(isinstance(m["value"], (int, float)) and math.isfinite(m["value"])
                     for m in metrics.values())
    result = {"correct": bool(rec["correct"] and numbers_ok), "attempted": rec["attempted"],
              "failed": rec["failed"], "metrics": metrics, "device": device}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["compared"] = rec["compared"]
    harness.log(f"[run] {device['kind']}, peak memory {device['memory_peak_bytes']} bytes "
                f"({device['memory_peak_bytes'] / 2**30:.2f} GiB); set-up {rec['setup_s']:.2f} s")
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"[run] refused: the process holds {bad} (JAX or the JAX package)")
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
