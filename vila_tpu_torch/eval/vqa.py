"""Generic VQA-style evaluation, as `vila_tpu/eval/vqa.py`: generate over a
JSON dataset, score by exact/fuzzy match, write results.json +
metrics.json.

Capability parity: the shape of the reference's in-repo eval scripts
(llava/eval/*.py, e.g. textvqa / video QA suites) and the vila-eval
contract (llava/cli/eval.py:216-231 — metrics extracted by JSON-path from
$OUTPUT_DIR/metrics.json).

Dataset format (jsonl or json list):
  {"image": "path.jpg" | null, "video": "path.mp4" | null,
   "question": "...", "answer": "..." | ["...", ...]}

    python -m vila_tpu_torch.eval.vqa --model-path M --dataset D.jsonl
        --output-dir O [--media-root R] [--device cuda|cpu]

runs on the card unless `--device cpu`; without CUDA it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import string
from typing import Any, Dict, List


def normalize_answer(s: str) -> str:
    """Lowercase, strip articles/punctuation (standard VQA normalization)."""
    s = s.lower().strip()
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    s = s.translate(str.maketrans("", "", string.punctuation))
    return " ".join(s.split())


def score_answer(pred: str, golds: List[str]) -> Dict[str, float]:
    p = normalize_answer(pred)
    gs = [normalize_answer(g) for g in golds]
    exact = float(any(p == g for g in gs))
    contains = float(any(g and g in p for g in gs))
    return {"exact": exact, "contains": contains}


def load_dataset(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def run_eval(
    engine,
    dataset: List[Dict[str, Any]],
    *,
    max_new_tokens: int = 64,
    media_root: str = "",
) -> Dict[str, Any]:
    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.media import Image, Video

    gc = GenerationConfig(max_new_tokens=max_new_tokens)
    results = []
    agg = {"exact": 0.0, "contains": 0.0}
    for ex in dataset:
        prompt: List[Any] = []
        if ex.get("image"):
            prompt.append(Image(os.path.join(media_root, ex["image"])))
        if ex.get("video"):
            prompt.append(Video(os.path.join(media_root, ex["video"])))
        prompt.append(ex["question"])
        pred = engine.generate_content(prompt, gc)
        golds = ex["answer"] if isinstance(ex["answer"], list) else [ex["answer"]]
        s = score_answer(pred, golds)
        for k in agg:
            agg[k] += s[k]
        results.append({**ex, "prediction": pred, **s})
    n = max(len(dataset), 1)
    metrics = {f"vqa/{k}": v / n for k, v in agg.items()}
    metrics["vqa/count"] = len(dataset)
    return {"results": results, "metrics": metrics}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vila_tpu_torch.eval.vqa")
    p.add_argument("--model-path", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--media-root", default="")
    p.add_argument("--max-new-tokens", type=int, default=64)
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)

    from vila_tpu_torch.entry import load

    engine = load(args.model_path, device=args.device)
    dataset = load_dataset(args.dataset)
    out = run_eval(
        engine, dataset,
        max_new_tokens=args.max_new_tokens, media_root=args.media_root,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(out["results"], f, indent=2)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(out["metrics"], f, indent=2)
    print(json.dumps(out["metrics"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
