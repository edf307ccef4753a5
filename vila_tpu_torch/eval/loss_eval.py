"""Loss regression eval, as `vila_tpu/eval/loss_eval.py`: deterministic CE
on a fixed synthetic batch.

Capability parity: the reference's `--debug_e2e` loss-curve comparison
(llava/train/args.py:281-284, llava_trainer.py:849-854) — the de-facto
integration test for training-path changes. A fixed seed makes the number
comparable across commits.

    python -m vila_tpu_torch.eval.loss_eval --model-path M --output-dir O
        [--seq-len 64] [--device cuda|cpu]

runs on the card unless `--device cpu`; without CUDA it raises. On the card
a bf16 model with head dim 128 and a sequence a multiple of 128 takes the
flash route (K7, one launch a layer).
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Tuple

import numpy as np
import torch


def fixed_batch(cfg, seq_len: int = 64, device="cpu") -> dict:
    """The fixed batch: 2 rows of `seq_len` ids drawn from numpy's generator
    at seed 0, labels equal to the ids, one segment a row."""
    rng = np.random.default_rng(0)
    b, s = 2, seq_len
    ids = rng.integers(1, min(cfg.llm.vocab_size, 1000), size=(b, s)).astype(np.int32)
    ids = torch.tensor(ids, device=device)
    return {
        "input_ids": ids,
        "labels": ids,
        "positions": torch.arange(s, dtype=torch.int32, device=device).expand(b, s),
        "segment_ids": torch.ones((b, s), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def loss(params, cfg, seq_len: int = 64, device="cpu") -> Tuple[float, int]:
    """(mean next-token cross entropy, tokens counted) of `params` on the
    fixed batch (`fixed_batch`, `vlm.forward_batch`,
    `losses.causal_lm_loss`)."""
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.train.losses import causal_lm_loss

    batch = fixed_batch(cfg, seq_len, device)
    logits = vlm.forward_batch(params, cfg, batch)
    value, n = causal_lm_loss(logits, batch["labels"])
    return float(value), int(n)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("vila_tpu_torch.eval.loss_eval")
    parser.add_argument("--model-path", required=True)
    parser.add_argument("--output-dir", required=True)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    args = parser.parse_args(argv)

    from vila_tpu_torch.entry import load

    engine = load(args.model_path, device=args.device)
    value, n = loss(engine.params, engine.cfg, args.seq_len, engine.device)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump({"loss_eval": {"loss": value, "n_tokens": n}}, f)
    print(f"loss={value:.6f} over {n} tokens")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
