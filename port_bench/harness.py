"""What every cell of the benchmark shares: finding a cell's files by name,
the published peaks, statistics, seeds, the device record, the import
guard and the result line.

Nothing here imports the program (`vila_tpu_torch`) or JAX; the drivers
import the program inside their functions.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys
from typing import Any, Dict, List, Sequence

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "port_bench")
WORK = os.path.join(BENCH, "_work")  # traces and scratch of a run (git-ignored)

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# top-level module names the process may not hold once the window closed:
# JAX, and the JAX package that the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vila_tpu")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> Dict[str, Any]:
    """The cell `name` of BENCHMARK.json with its files: {"name", "config"
    (the configuration file's contents), "traffic" (the mix's), "workload"
    (the cell's own: driver, engine settings, limits), "benchmark" (the
    BENCHMARK.json entry)}. A cell kept ready but not benchmarked is found
    in `ready/<name>.json`, which has BENCHMARK.json's layout."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    ready = os.path.join(BENCH, "ready", name + ".json")
    if entry is None and os.path.exists(ready):
        bench = load_json(ready)
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return {
        "name": name,
        "benchmark": entry,
        "run_seconds": bench["run_seconds"],
        "config": load_json(os.path.join(ROOT, conf["file"])),
        "traffic": load_json(os.path.join(BENCH, "traffic", entry["traffic"] + ".json")),
        "workload": load_json(os.path.join(BENCH, "workloads", name + ".json")),
        "end_to_end": [m for m in bench["end_to_end"]
                       if name in m.get("workloads", [name])],
        "per_layer": [m for m in bench["per_layer"] if name in m.get("workloads", [name])],
    }


def load_module(path: str, name: str):
    """A Python file loaded by its path (names such as `vision_ms.chat`
    hold dots, so they cannot be imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str):
    """The reader of per-layer metric `name`: `metrics/<name>.py`'s
    `read(run) -> float | None`."""
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "port_bench_metric_" + name.replace(".", "_")).read


def driver(name: str):
    return load_module(os.path.join(BENCH, "drivers", name + ".py"),
                       "port_bench_driver_" + name)


def derive_seed(seed: int, *names: Any) -> int:
    """A 63-bit seed for one named stream of a run's seed: weights,
    traffic and pixels each draw from their own."""
    h = hashlib.sha256(("/".join(str(x) for x in (seed,) + names)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between order statistics (numpy's
    default); +inf counts as larger than every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]):
        return xs[hi] if pos > lo else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def nvidia_smi() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def require_cards(n: int) -> None:
    """Exit without a result unless CUDA sees at least `n` cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < n:
        raise SystemExit(f"the cell needs {n} cards, CUDA sees {torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the run may not hold,
    compared whole (`vila_tpu_torch` is not `vila_tpu`)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def finite(x):
    """x with every non-finite float replaced by None (JSON has no inf)."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    return x


def emit(result: Dict[str, Any]) -> None:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output, `compared` last."""
    result = finite(result)
    for name, c in result["compared"].items():
        log(f"compared {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
