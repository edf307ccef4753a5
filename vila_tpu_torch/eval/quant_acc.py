"""Quantized accuracy: bf16 against W4-RTN and W4-AWQ on the committed
pope-mini fixture, with the committed trained probe model
(`vila_tpu/eval/fixtures/quant_probe`, read as data), as
`scripts/quant_acc.py` measures it for the JAX package.

For each engine: pope-mini accuracy, precision, recall, F1 and yes-ratio
(`benchmarks.run_benchmark(..., "pope", max_new_tokens=4)`), then, against
the bf16 engine, the first-token top-1 agreement and mean |logit
difference| over every prompt (through each engine's prefill), and the two
accuracy deltas. The recipe is the JAX script's: calibration ids are the
first 32 questions, 48 tokens each (zero-padded); RTN is
`quantize_llm_params(fuse=True, cfg=...)`; AWQ is `awq_quantize_llm` with
its defaults (its 128 calibration rows drawn with a torch generator, seed
0, where the JAX script draws with `jax.random`).

    python -m vila_tpu_torch.eval.quant_acc [--limit N] [--device cpu] [--output F]

prints the JSON, and writes it only to the path `--output` names.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from vila_tpu_torch.eval.benchmarks import FIXTURE_ROOT, load_dataset, resolve_dataset

PROBE = os.path.join(FIXTURE_ROOT, "quant_probe")
DATASET = "fixture:mini/pope.jsonl"
POPE_SUFFIX = "\nAnswer the question with yes or no."
ENGINES = ("bf16", "w4_rtn", "w4_awq")


def first_token_logits(engine, prep) -> np.ndarray:
    """The full first-token logits (f32) of a prepared prompt through the
    engine's prefill path (the prompt padded to its bucket, as served)."""
    from vila_tpu_torch.inference.generate import (
        PROMPT_BUCKETS, _bucket, _round_up, padded_prompt,
    )
    from vila_tpu_torch.models import qwen2

    cfg, dev = engine.cfg, engine.device
    prompt_len = int(prep["input_ids"].shape[0])
    s_pad = _bucket(prompt_len, PROMPT_BUCKETS)
    ids, valid, media_pos = padded_prompt(prep, s_pad, dev)
    media_embeds = engine.encode_media(prep["media"])
    cache = qwen2.init_cache(cfg.llm, batch=1, max_len=_round_up(s_pad + 8, 256), device=dev)
    logits, _ = engine._prefill(ids, valid, media_embeds, media_pos, cache, prompt_len)
    return logits[0].float().cpu().numpy()


def calibration_ids(tokenizer, dataset: List[Dict[str, Any]], n: int = 32,
                    length: int = 48) -> torch.Tensor:
    """(n, length) int64: the first n questions' ids, cut to `length` and
    zero-padded (the JAX script's calibration set)."""
    texts = [r["question"] for r in dataset[:n]]
    calib = torch.zeros((len(texts), length), dtype=torch.int64)
    for i, t in enumerate(texts):
        ids = tokenizer(t, add_special_tokens=False).input_ids[:length]
        calib[i, :len(ids)] = torch.tensor(ids, dtype=torch.int64)
    return calib


def build_engines(engine, calib: torch.Tensor, timings: Optional[dict] = None,
                  sample_rows: int = 128):
    """{"bf16": engine, "w4_rtn": ..., "w4_awq": ...} over the same tower,
    projector and tokenizer (AWQ keeps `sample_rows` calibration rows);
    `timings` receives each quantizer's seconds."""
    import time

    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.ops.awq import awq_quantize_llm
    from vila_tpu_torch.ops.quant import quantize_llm_params

    cfg, tok, dev = engine.cfg, engine.tokenizer, engine.device
    bf16_llm = engine.params["llm"]
    engines = {"bf16": engine}
    for name, quantize in (
        ("w4_rtn", lambda: quantize_llm_params(bf16_llm, bits=4, fuse=True, cfg=cfg.llm)),
        ("w4_awq", lambda: awq_quantize_llm(bf16_llm, cfg.llm, calib.to(dev),
                                            sample_rows=sample_rows)),
    ):
        t0 = time.perf_counter()
        llm = quantize()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if timings is not None:
            timings[name] = time.perf_counter() - t0
        engines[name] = GenerationEngine({**engine.params, "llm": llm}, cfg, tok, device=dev)
    return engines


def accuracy(engines, dataset, media_root: str, names=ENGINES):
    """({engine: pope metrics rounded to 4 places}, {engine: the
    predictions, in dataset order})."""
    from vila_tpu_torch.eval.benchmarks import run_benchmark

    metrics, preds = {}, {}
    for name in names:
        r = run_benchmark(engines[name], "pope", dataset, max_new_tokens=4,
                          media_root=media_root)
        metrics[name] = {k: round(float(v), 4) for k, v in r["metrics"].items()}
        preds[name] = [row["prediction"] for row in r["results"]]
    return metrics, preds


def prompts(engine, dataset, media_root: str):
    """Every example's prepared prompt (its image and the pope question)."""
    from PIL import Image

    preps = []
    for r in dataset:
        with Image.open(os.path.join(media_root, r["image"])) as img:
            img.load()
            preps.append(engine.prepare_inputs([img, r["question"] + POPE_SUFFIX]))
    return preps


def fidelity(engines, preps):
    """{engine: (first-token top-1 agreement, mean |logit diff|)} of the W4
    engines against the bf16 engine over the prepared prompts."""
    ref = [first_token_logits(engines["bf16"], p) for p in preps]
    out = {}
    for name in ("w4_rtn", "w4_awq"):
        agree, l1 = 0, 0.0
        for p, rl in zip(preps, ref):
            ql = first_token_logits(engines[name], p)
            agree += int(np.argmax(ql) == np.argmax(rl))
            l1 += float(np.mean(np.abs(ql - rl)))
        out[name] = (round(agree / len(preps), 4), round(l1 / len(preps), 4))
    return out


def measure(engine, limit: Optional[int] = None, timings: Optional[dict] = None,
            model_path: str = PROBE, sample_rows: int = 128):
    """The whole measurement on the probe loaded from `model_path`: (result
    dict as the JAX script writes it, {engine: predictions}, the engines)."""
    ds_path = resolve_dataset(DATASET)
    dataset = load_dataset(ds_path)
    if limit:
        dataset = dataset[:limit]
    media_root = os.path.dirname(ds_path)
    engines = build_engines(engine, calibration_ids(engine.tokenizer, dataset), timings,
                            sample_rows)
    out: Dict[str, Any] = {"task": "pope-mini", "n_examples": len(dataset),
                           "model": "trained tiny probe (data_prepare/train_quant_probe.py)"}
    meta_path = os.path.join(model_path, "probe_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            out["probe_meta"] = json.load(f)
    metrics, preds = accuracy(engines, dataset, media_root)
    out.update(metrics)
    for name, (agree, l1) in fidelity(engines, prompts(engine, dataset, media_root)).items():
        out[name]["first_token_top1_agreement"] = agree
        out[name]["mean_abs_logit_diff"] = l1
    acc = "pope/accuracy"
    out["acc_delta_rtn"] = round(out["bf16"][acc] - out["w4_rtn"][acc], 4)
    out["acc_delta_awq"] = round(out["bf16"][acc] - out["w4_awq"][acc], 4)
    return out, preds, engines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("vila_tpu_torch.eval.quant_acc")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--model", default=PROBE)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--output", default=None, help="also write the JSON to this path")
    args = ap.parse_args(argv)

    from vila_tpu_torch.entry import load

    out, _, _ = measure(load(args.model, device=args.device), args.limit,
                        model_path=args.model)
    text = json.dumps(out)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, indent=2)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
