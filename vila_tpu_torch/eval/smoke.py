"""Smoke evaluation task, as `vila_tpu/eval/smoke.py`: load model, run
text/image generation, check the pipeline end-to-end. Used by the
registry's `regression` tag as the cheapest always-runnable task.

    python -m vila_tpu_torch.eval.smoke --model-path M --output-dir O
        [--mode text|image] [--device cuda|cpu]

runs on the card unless `--device cpu`; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, List, Tuple

import numpy as np

PROMPTS = ["Hello!", "What is the capital of France?"]


def prompts(mode: str) -> List[Any]:
    """The task's prompts: text alone, or each after a seeded 224² image."""
    if mode == "text":
        return list(PROMPTS)
    from PIL import Image as PILImage

    from vila_tpu_torch.media import Image

    img = PILImage.fromarray(
        np.random.default_rng(0).integers(0, 255, (224, 224, 3), np.uint8)
    )
    return [[Image(img), p] for p in PROMPTS]


def run(engine, mode: str = "text") -> Tuple[int, int, List[Any]]:
    """(passed, total, outputs): each prompt generated with 16 new tokens;
    a prompt passes when it gives a string (a failure is printed and
    counted, as the JAX task does)."""
    from vila_tpu_torch.inference.generate import GenerationConfig

    n_pass, n_total, outs = 0, 0, []
    for p in prompts(mode):
        n_total += 1
        try:
            out = engine.generate_content(p, GenerationConfig(max_new_tokens=16))
            outs.append(out)
            if isinstance(out, str):
                n_pass += 1
        except Exception as e:  # noqa: BLE001
            outs.append(None)
            print(f"smoke failure: {e}")
    return n_pass, n_total, outs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("vila_tpu_torch.eval.smoke")
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--mode", choices=["text", "image"], default="text")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = parser.parse_args(argv)

    from vila_tpu_torch.entry import load

    engine = load(args.model_path, device=args.device)
    n_pass, n_total, _ = run(engine, args.mode)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump({"smoke": {"pass_rate": n_pass / n_total}}, f)
    print(f"smoke: {n_pass}/{n_total} passed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
