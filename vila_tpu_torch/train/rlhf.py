"""RLHF: reward modeling and PPO with a value head, and a plain SFT step,
as `vila_tpu/train/rlhf.py` (capability parity: the reference's vendored
TRL trainers beyond DPO, llava/trl/trainer/{reward_trainer,ppo_trainer,
sft_trainer}.py, and llava/trl/models/modeling_value_head.py).

  * Reward model: the LLM with a scalar head on the last valid token's
    hidden state; pairwise Bradley–Terry loss −log σ(r_chosen − r_rejected).
  * PPO: a value head on the policy trunk, per-token KL-shaped rewards
    against a frozen reference, GAE, clipped surrogate and clipped value
    loss (TRL's `cliprange`, `cliprange_value`, `vf_coef`, whitened
    advantages).
  * SFT: one causal-LM step (`train/trainer.py` is the full loop).

The experience pass runs under `torch.no_grad`; GAE is a reversed loop
over the time steps (JAX: a reversed `lax.scan`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from vila_tpu_torch.constants import IGNORE_INDEX
from vila_tpu_torch.models import qwen2, vlm
from vila_tpu_torch.train.step import apply_gradients

# --------------------------------------------------------------------------
# per-token logp and the value head
# --------------------------------------------------------------------------


def init_value_head(generator: torch.Generator, hidden_size: int, dtype=torch.float32):
    """Scalar head (TRL's ValueHead: a linear layer), N(0, 1/D) weights,
    drawn on the generator's device."""
    dev = generator.device
    k = torch.randn((hidden_size, 1), generator=generator, device=dev) * hidden_size ** -0.5
    return {"kernel": k.to(dtype), "bias": torch.zeros((1,), dtype=dtype, device=dev)}


def _hidden(params, cfg, batch) -> torch.Tensor:
    """(B, S, D) final hidden states of a collated batch (media-aware)."""
    return vlm.forward_batch(params, cfg, batch, return_hidden=True)


def value_forward(head, hidden: torch.Tensor) -> torch.Tensor:
    """(B, S) value estimates from (B, S, D) hidden states."""
    h = hidden.to(head["kernel"].dtype)
    return (h @ head["kernel"] + head["bias"])[..., 0]


def token_logp(params, cfg, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logp (B, S-1) of input_ids[t+1] given <= t, hidden (B, S, D)).
    Forms the (B, S-1, V) logits: PPO rows are prompt + response."""
    hidden = _hidden(params, cfg, batch)
    logits = qwen2.compute_logits(params["llm"], cfg.llm, hidden)[:, :-1].float()
    targets = batch["input_ids"][:, 1:].to(logits.device).long()
    logp = torch.log_softmax(logits, dim=-1)
    return logp.gather(-1, targets[..., None])[..., 0], hidden


# --------------------------------------------------------------------------
# reward modeling
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    center_coef: float = 0.0  # optional reward-centering L2


def sequence_reward(params, head, cfg, batch,
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) rewards: the value head on the last valid token's hidden state.
    `valid` (B, S) marks real tokens; by default the collator's
    `segment_ids != 0`, and without segment ids the tokens whose id is not
    0 or whose label is kept."""
    hidden = _hidden(params, cfg, batch)
    if valid is None:
        if "segment_ids" in batch:
            valid = batch["segment_ids"] != 0
        else:
            valid = batch["input_ids"] != 0
            if "labels" in batch:
                valid = valid | (batch["labels"] != IGNORE_INDEX)
    valid = valid.to(hidden.device)
    last = (valid.shape[1] - 1 - valid.flip(1).int().argmax(1)).clamp(min=0)
    h_last = hidden[torch.arange(hidden.shape[0], device=hidden.device), last]
    return (h_last.to(head["kernel"].dtype) @ head["kernel"] + head["bias"])[..., 0]


def reward_loss(r_chosen: torch.Tensor, r_rejected: torch.Tensor,
                rcfg: RewardConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pairwise Bradley–Terry loss (TRL reward_trainer compute_loss)."""
    loss = -F.logsigmoid(r_chosen - r_rejected).mean()
    if rcfg.center_coef:
        loss = loss + rcfg.center_coef * (r_chosen.square() + r_rejected.square()).mean()
    metrics = {
        "reward_accuracy": (r_chosen > r_rejected).float().mean(),
        "reward_margin": (r_chosen - r_rejected).mean(),
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def reward_step_fn(params, head, batch, *, cfg, rcfg: RewardConfig, optimizer, opt_state):
    """One reward-model update of (params, head) in place on a
    {"chosen", "rejected"} pair batch. Returns (params, head, opt_state,
    metrics)."""

    def compute_loss():
        rc = sequence_reward(params, head, cfg, batch["chosen"])
        rr = sequence_reward(params, head, cfg, batch["rejected"])
        return reward_loss(rc, rr, rcfg)

    loss, metrics, _, opt_state = apply_gradients((params, head), compute_loss, optimizer,
                                                  opt_state)
    metrics["loss"] = loss
    return params, head, opt_state, metrics


# --------------------------------------------------------------------------
# PPO
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    kl_coef: float = 0.05  # per-token KL penalty against the reference
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 0.1
    whiten_advantages: bool = True


def compute_gae(rewards: torch.Tensor, values: torch.Tensor, mask: torch.Tensor,
                gamma: float, lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation, TRL's semantics
    (ppo_trainer.compute_advantages): values and rewards zeroed by the mask
    before the recursion, which then runs unmasked from the last step back.
    Returns (advantages, returns)."""
    values = values * mask
    rewards = rewards * mask
    next_adv = torch.zeros_like(rewards[:, 0])
    next_value = torch.zeros_like(rewards[:, 0])
    adv = []
    for t in range(rewards.shape[1] - 1, -1, -1):
        delta = rewards[:, t] + gamma * next_value - values[:, t]
        next_adv = delta + gamma * lam * next_adv
        next_value = values[:, t]
        adv.append(next_adv)
    advantages = torch.stack(adv[::-1], dim=1) * mask
    return advantages, advantages + values


def _whiten(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n = mask.sum().clamp(min=1.0)
    mean = (x * mask).sum() / n
    var = ((x - mean).square() * mask).sum() / n
    return (x - mean) * torch.rsqrt(var + 1e-8) * mask


@torch.no_grad()
def make_experience(params, ref_params, value_head, batch: Dict[str, torch.Tensor],
                    response_mask: torch.Tensor, scores: torch.Tensor, *, cfg,
                    pcfg: PPOConfig) -> Dict[str, torch.Tensor]:
    """The PPO rollout buffer: old per-token logp, values, KL-shaped
    per-token rewards (the score added at the last response token; a row
    with an empty response drops its score), GAE advantages and returns.
    `response_mask` (B, S-1) is 1 where token t+1 is a response token."""
    old_logp, hidden = token_logp(params, cfg, batch)
    ref_logp, _ = token_logp(ref_params, cfg, batch)
    values = value_forward(value_head, hidden)[:, :-1]
    response_mask = response_mask.to(old_logp.device).float()
    scores = scores.to(old_logp.device)
    kl = old_logp - ref_logp
    rewards = -pcfg.kl_coef * kl * response_mask
    has_resp = response_mask.sum(dim=1) > 0
    idx = (response_mask.shape[1] - 1 - response_mask.flip(1).argmax(1)).clamp(min=0)
    rows = torch.arange(rewards.shape[0], device=rewards.device)
    rewards = rewards.index_put((rows, idx), torch.where(has_resp, scores, 0.0),
                                accumulate=True)
    advantages, returns = compute_gae(rewards, values, response_mask, pcfg.gamma, pcfg.lam)
    if pcfg.whiten_advantages:
        advantages = _whiten(advantages, response_mask)
    return {
        "old_logp": old_logp,
        "values": values,
        "advantages": advantages,
        "returns": returns,
        "kl": (kl * response_mask).sum() / response_mask.sum().clamp(min=1.0),
    }


def ppo_loss(logp: torch.Tensor, vpred: torch.Tensor, exp: Dict[str, torch.Tensor],
             mask: torch.Tensor, pcfg: PPOConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped surrogate + clipped value loss (TRL ppo_trainer.loss)."""
    n = mask.sum().clamp(min=1.0)
    ratio = torch.exp(logp - exp["old_logp"])
    pg1 = -exp["advantages"] * ratio
    pg2 = -exp["advantages"] * ratio.clamp(1.0 - pcfg.cliprange, 1.0 + pcfg.cliprange)
    pg_loss = (torch.maximum(pg1, pg2) * mask).sum() / n
    v_clip = exp["values"] + (vpred - exp["values"]).clamp(-pcfg.cliprange_value,
                                                          pcfg.cliprange_value)
    vf1 = (vpred - exp["returns"]).square()
    vf2 = (v_clip - exp["returns"]).square()
    vf_loss = 0.5 * (torch.maximum(vf1, vf2) * mask).sum() / n
    loss = pg_loss + pcfg.vf_coef * vf_loss
    metrics = {
        "pg_loss": pg_loss,
        "vf_loss": vf_loss,
        "ratio_mean": (ratio * mask).sum() / n,
        "clipfrac": (((ratio - 1.0).abs() > pcfg.cliprange) * mask).sum() / n,
    }
    return loss, {k: v.detach() for k, v in metrics.items()}


def ppo_step_fn(params, value_head, batch, response_mask, exp: Dict[str, torch.Tensor], *,
                cfg, pcfg: PPOConfig, optimizer, opt_state):
    """One PPO minibatch update of (policy params, value head) in place.
    Returns (params, value_head, opt_state, metrics)."""
    mask = response_mask.to(exp["old_logp"].device).float()

    def compute_loss():
        logp, hidden = token_logp(params, cfg, batch)
        vpred = value_forward(value_head, hidden)[:, :-1]
        return ppo_loss(logp, vpred, exp, mask, pcfg)

    loss, metrics, _, opt_state = apply_gradients((params, value_head), compute_loss,
                                                  optimizer, opt_state)
    metrics["loss"] = loss
    return params, value_head, opt_state, metrics


# --------------------------------------------------------------------------
# SFT single step
# --------------------------------------------------------------------------


def sft_step_fn(params, batch, *, cfg, optimizer, opt_state,
                chunk_size: Optional[int] = 1024):
    """A plain causal-LM step (TRL's sft_trainer), for alternating PPO and
    SFT updates; `train/trainer.py` is the full loop. Returns (params,
    opt_state, {"loss"})."""
    from vila_tpu_torch.train.losses import chunked_causal_lm_loss

    def compute_loss():
        hidden = _hidden(params, cfg, batch)
        loss, _ = chunked_causal_lm_loss(hidden, params["llm"], cfg.llm, batch["labels"],
                                         chunk_size or batch["labels"].shape[1])
        return loss, None

    loss, _, _, opt_state = apply_gradients(params, compute_loss, optimizer, opt_state)
    return params, opt_state, {"loss": loss}
