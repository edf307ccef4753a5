"""`vila-torch-eval`: registry-driven evaluation runner, as
`vila_tpu/cli/eval.py`, over the port's registry (`eval/registry.yaml`,
read by the port's own YAML reader).

Capability parity: llava/cli/eval.py:29-239 — task filtering by name/tags,
concurrent subprocess execution (concurrency 10), metric collection via
JSON-paths from each task's metrics.json, tabulated report.

    vila-torch-eval -m MODEL [--tasks ...] [--tags ...] [-o runs/eval]
        [--device cuda|cpu]

Each task's command is templated with $MODEL, $OUTPUT_DIR and $DEVICE
(default `cuda`: every task runs on the card, and without CUDA it fails
and is reported as failed; `--device cpu` asks for the CPU). A command's
leading `python` is the interpreter running this CLI.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shlex
import subprocess
import sys
from string import Template
from typing import Any, Dict, Optional

from vila_tpu_torch.utils import yaml_lite

REGISTRY_PATH = os.path.join(
    os.path.dirname(os.path.dirname(__file__)), "eval", "registry.yaml"
)


def load_registry(path: Optional[str] = None) -> Dict[str, Any]:
    return yaml_lite.load_file(path or REGISTRY_PATH)


def json_path(obj: Any, path: str) -> Any:
    """Resolve a registry metric path against a metrics.json payload.

    Metric writers use two shapes: flat slash keys stored verbatim
    (benchmarks.py: {"mme/total": 1523.0}) and nested dicts
    (smoke.py: {"smoke": {"pass_rate": 1.0}}). Accept both — exact flat
    key wins, then nested traversal."""
    if isinstance(obj, dict) and path in obj:
        return obj[path]
    for key in path.split("/"):
        obj = obj[key]
    return obj


def command(spec: Dict[str, Any], model: str, out_dir: str, device: str) -> str:
    cmd = Template(spec["command"]).safe_substitute(
        MODEL=model, OUTPUT_DIR=out_dir, DEVICE=device
    )
    if cmd.startswith("python "):
        cmd = shlex.quote(sys.executable) + cmd[len("python"):]
    return cmd


def run_task(name: str, spec: Dict[str, Any], model: str, out_root: str,
             device: str = "cuda"):
    out_dir = os.path.join(out_root, name)
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "log.txt")
    with open(log, "w") as f:
        proc = subprocess.run(command(spec, model, out_dir, device), shell=True,
                              stdout=f, stderr=f)
    metrics = {}
    mfile = os.path.join(out_dir, "metrics.json")
    if proc.returncode == 0 and os.path.exists(mfile):
        with open(mfile) as f:
            raw = json.load(f)
        for mname, mpath in (spec.get("metrics") or {}).items():
            try:
                metrics[mname] = json_path(raw, mpath)
            except Exception:
                metrics[mname] = None
    return name, proc.returncode, metrics


def main(argv=None):
    parser = argparse.ArgumentParser("vila-torch-eval")
    parser.add_argument("--model-path", "-m", required=True)
    parser.add_argument("--model-name", default=None)
    parser.add_argument("--tasks", "-t", nargs="*", default=None)
    parser.add_argument("--tags", nargs="*", default=None)
    parser.add_argument("--output-dir", "-o", default="runs/eval")
    parser.add_argument("--concurrency", type=int, default=10)
    parser.add_argument("--registry", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda, or cpu for the plain versions (passed to every task)")
    args = parser.parse_args(argv)

    registry = load_registry(args.registry)
    selected = {}
    for name, spec in registry.items():
        if args.tasks and name not in args.tasks:
            continue
        if args.tags and not set(args.tags) & set(spec.get("tags", [])):
            continue
        selected[name] = spec
    if not selected:
        print("no tasks selected")
        return

    model_name = args.model_name or os.path.basename(
        os.path.normpath(args.model_path)
    )
    out_root = os.path.join(args.output_dir, model_name)
    os.makedirs(out_root, exist_ok=True)

    results = {}
    with concurrent.futures.ThreadPoolExecutor(args.concurrency) as pool:
        futures = [
            pool.submit(run_task, name, spec, args.model_path, out_root, args.device)
            for name, spec in selected.items()
        ]
        for fut in concurrent.futures.as_completed(futures):
            name, code, metrics = fut.result()
            results[name] = {"exit_code": code, "metrics": metrics}
            status = "OK" if code == 0 else f"FAIL({code})"
            print(f"[{status}] {name}: {metrics}")

    with open(os.path.join(out_root, "results.json"), "w") as f:
        json.dump(results, f, indent=2)

    # tabulate summary
    print("\n== summary ==")
    width = max((len(n) for n in results), default=4)
    for name in sorted(results):
        r = results[name]
        mtxt = ", ".join(f"{k}={v}" for k, v in r["metrics"].items())
        print(f"{name.ljust(width)}  exit={r['exit_code']}  {mtxt}")


if __name__ == "__main__":
    main()
