"""`python -m vila_tpu_torch.eval.lmms_cli`: run one lmms-eval task against a
checkpoint through the port, as `vila_tpu/eval/lmms_cli.py` (capability
parity: scripts/eval/lmms.sh + the `lmms-*` rows of
llava/eval/registry.yaml).

Maps the registry's task names onto the lmms-eval harness with our model
wrapper (vila_tpu_torch.eval.lmms.VILA, on the card unless `--device
cpu`), including the custom videomme /
videomme_w_subtitle tasks with per-run frame counts
(llava/eval/lmms/tasks/videomme.py parity). Writes
$OUTPUT_DIR/metrics.json with a flat {"lmms/<task>": value} mapping the
registry's JSON-paths point at.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vila_tpu_torch.eval.lmms_cli")
    p.add_argument("--task", required=True)
    p.add_argument("--model-path", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)

    try:
        import lmms_eval
        from lmms_eval.evaluator import simple_evaluate
    except Exception:
        print(
            "lmms-eval is not installed in this environment. Install it "
            "(pip install lmms-eval) to run lmms-* registry tasks; the "
            "in-repo equivalents (vila_tpu_torch.eval.benchmarks) run without it.",
            file=sys.stderr,
        )
        return 2

    import vila_tpu_torch.eval.lmms  # noqa: F401  (registers "vila_tpu_torch")
    from vila_tpu_torch.eval import lmms_tasks

    task_manager = lmms_tasks.register()

    model_args = f"model_path={args.model_path},device={args.device}"
    if args.frames:
        model_args += f",num_video_frames={args.frames}"

    kwargs = {}
    if task_manager is not None:
        import inspect

        if "task_manager" in inspect.signature(simple_evaluate).parameters:
            kwargs["task_manager"] = task_manager
    results = simple_evaluate(
        model="vila_tpu_torch",
        model_args=model_args,
        tasks=[args.task],
        limit=args.limit,
        batch_size=1,
        **kwargs,
    )

    os.makedirs(args.output_dir, exist_ok=True)
    metrics = {}
    for task, vals in (results or {}).get("results", {}).items():
        primary = None
        for key, v in vals.items():
            if not isinstance(v, (int, float)):
                continue
            metrics[f"lmms/{task}/{key}"] = v
            # headline metric = first non-stderr numeric (harness dicts
            # interleave "acc,none" with "acc_stderr,none")
            if primary is None and "stderr" not in key:
                primary = v
        if primary is not None:
            metrics[f"lmms/{task}"] = primary
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(metrics, f, indent=2)
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
