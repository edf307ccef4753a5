"""Direct Preference Optimization, as `vila_tpu/train/dpo.py` (capability
parity: the reference's vendored TRL `DPOTrainer` subset,
llava/trl/trainer/dpo_trainer.py, `VILADPOTrainer`,
llava/train/llava_trainer.py:441, and `DPODataCollator`,
llava/train/train.py:224-416).

One step evaluates the policy and the frozen reference on the chosen and
rejected halves of a pair batch; the reference runs under `torch.no_grad`
with its own parameter tree.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vila_tpu_torch.constants import IGNORE_INDEX
from vila_tpu_torch.models import vlm
from vila_tpu_torch.train.step import apply_gradients


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    label_smoothing: float = 0.0
    loss_type: str = "sigmoid"  # sigmoid | ipo
    # sequence log-prob chunking (never forms (B, S, V)); None: one
    # full-logits projection (tiny models only)
    chunk_size: Optional[int] = 1024


def sequence_logp(params, cfg, batch_side: Dict[str, torch.Tensor],
                  chunk_size: Optional[int] = 1024) -> torch.Tensor:
    """(B,) sum of log p(labels) per sequence of a collated batch; with
    `chunk_size` through `losses.chunked_sequence_logp`."""
    if chunk_size:
        from vila_tpu_torch.train.losses import chunked_sequence_logp

        hidden = vlm.forward_batch(params, cfg, batch_side, return_hidden=True)
        return chunked_sequence_logp(hidden, params["llm"], cfg.llm, batch_side["labels"],
                                     chunk_size)
    logits = vlm.forward_batch(params, cfg, batch_side)[:, :-1].float()
    targets = batch_side["labels"][:, 1:].to(logits.device)
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    tok = torch.log_softmax(logits, dim=-1).gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, tok, 0.0).sum(-1)


def dpo_loss(policy_chosen: torch.Tensor, policy_rejected: torch.Tensor,
             ref_chosen: torch.Tensor, ref_rejected: torch.Tensor,
             dcfg: DPOConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """TRL's sigmoid / IPO DPO objective and its four reward metrics."""
    h = (policy_chosen - policy_rejected) - (ref_chosen - ref_rejected)
    if dcfg.loss_type == "ipo":
        loss = (h - 1.0 / (2.0 * dcfg.beta)).square().mean()
    else:
        loss = -((1.0 - dcfg.label_smoothing) * F.logsigmoid(dcfg.beta * h)
                 + dcfg.label_smoothing * F.logsigmoid(-dcfg.beta * h)).mean()
    chosen_reward = dcfg.beta * (policy_chosen - ref_chosen)
    rejected_reward = dcfg.beta * (policy_rejected - ref_rejected)
    metrics = {
        "rewards_chosen": chosen_reward.mean(),
        "rewards_rejected": rejected_reward.mean(),
        "reward_margin": (chosen_reward - rejected_reward).mean(),
        "reward_accuracy": (chosen_reward > rejected_reward).float().mean(),
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def dpo_step_fn(params, ref_params, batch: Dict[str, Dict[str, torch.Tensor]], *,
                cfg, dcfg: DPOConfig, optimizer, opt_state):
    """One DPO update of `params` (in place) on a {"chosen", "rejected"}
    pair batch. Returns (params, opt_state, metrics)."""
    cs = dcfg.chunk_size

    def compute_loss():
        pc = sequence_logp(params, cfg, batch["chosen"], cs)
        pr = sequence_logp(params, cfg, batch["rejected"], cs)
        with torch.no_grad():
            rc = sequence_logp(ref_params, cfg, batch["chosen"], cs)
            rr = sequence_logp(ref_params, cfg, batch["rejected"], cs)
        return dpo_loss(pc, pr, rc, rr, dcfg)

    loss, metrics, _, opt_state = apply_gradients(params, compute_loss, optimizer, opt_state)
    metrics["loss"] = loss
    return params, opt_state, metrics


class DPOCollator:
    """Pairs of (chosen, rejected) examples -> two collated batches."""

    def __init__(self, base_collator) -> None:
        self.base = base_collator

    def __call__(self, pairs):
        return {"chosen": self.base([p["chosen"] for p in pairs]),
                "rejected": self.base([p["rejected"] for p in pairs])}
