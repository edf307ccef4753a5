"""Training losses, as `vila_tpu/train/losses.py`: next-token cross
entropy (shift inside, IGNORE_INDEX masking), full and chunked; the
chunked per-sequence log-probability that DPO needs; the soft cross
entropy over time tokens (llava/model/loss.py:11-48); and PS3's DICE and
token-selection losses (llava_trainer.py:861-915). The mean is over all
valid tokens of the batch, the weighting the reference rebuilds by hand for
packed rows.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vila_tpu_torch.constants import IGNORE_INDEX


def _nll(logits: torch.Tensor, targets: torch.Tensor, z_loss: float):
    """Per-token negative log-likelihood (0 where the target is ignored)
    and the valid mask."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - logits.gather(-1, safe[..., None])[..., 0]
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    return torch.where(valid, nll, 0.0), valid


def causal_lm_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) int with IGNORE_INDEX masking
    z_loss: float = 0.0,
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Next-token cross entropy. Returns (loss, n_valid_tokens). With
    `shift=False` labels[i] is already the target of position i."""
    if shift:
        logits, targets = logits[:, :-1], labels[:, 1:]
    else:
        targets = labels
    nll, valid = _nll(logits, targets.to(logits.device), z_loss)
    n = valid.sum()
    return nll.sum() / n.clamp(min=1), n


def _chunk_nll(hc, tc, llm_params, llm_cfg, z_loss):
    from vila_tpu_torch.models import qwen2

    nll, valid = _nll(qwen2.compute_logits(llm_params, llm_cfg, hc), tc, z_loss)
    return nll.sum(), valid.sum()


def chunked_causal_lm_loss(
    hidden: torch.Tensor,  # (B, S, D) final hidden states (before lm_head)
    llm_params,
    llm_cfg,
    labels: torch.Tensor,  # (B, S) int with IGNORE_INDEX masking
    chunk_size: int = 1024,
    z_loss: float = 0.0,
    shift: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross entropy over sequence chunks of `chunk_size` tokens: each
    chunk's vocabulary projection and loss run under
    `torch.utils.checkpoint`, so the backward recomputes that chunk's logits
    and peak memory holds one chunk's (chunk, V) logits, not (B*S, V)."""
    b, s, d = hidden.shape
    labels = labels.to(hidden.device)
    if shift:
        h, t = hidden[:, :-1].reshape(-1, d), labels[:, 1:].reshape(-1)
    else:
        h, t = hidden.reshape(-1, d), labels.reshape(-1)
    pad = (-h.shape[0]) % chunk_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        t = F.pad(t, (0, pad), value=IGNORE_INDEX)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c in range(0, h.shape[0], chunk_size):
        nll, nv = checkpoint(_chunk_nll, h[c:c + chunk_size], t[c:c + chunk_size],
                             llm_params, llm_cfg, z_loss, use_reentrant=False)
        total = total + nll
        count = count + nv
    return total / count.clamp(min=1), count


def _chunk_logp(hc, tc, llm_params, llm_cfg):
    """(B,) sum of target log-probs of one (B, C, D) chunk."""
    from vila_tpu_torch.models import qwen2

    logits = qwen2.compute_logits(llm_params, llm_cfg, hc).float()
    valid = tc != IGNORE_INDEX
    safe = torch.where(valid, tc, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    tl = logits.gather(-1, safe[..., None])[..., 0]
    return torch.where(valid, tl - logz, 0.0).sum(-1)


def chunked_sequence_logp(
    hidden: torch.Tensor,  # (B, S, D) final hidden states (before lm_head)
    llm_params,
    llm_cfg,
    labels: torch.Tensor,  # (B, S) int with IGNORE_INDEX masking
    chunk_size: int = 1024,
) -> torch.Tensor:
    """(B,) per-sequence sum of next-token target log-probs without forming
    (B, S, V): chunks of `chunk_size` positions, each chunk's vocabulary
    projection and log-softmax under `torch.utils.checkpoint`."""
    labels = labels.to(hidden.device)
    h, t = hidden[:, :-1], labels[:, 1:]
    pad = (-h.shape[1]) % chunk_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        t = F.pad(t, (0, pad), value=IGNORE_INDEX)
    total = hidden.new_zeros((hidden.shape[0],), dtype=torch.float32)
    for c in range(0, h.shape[1], chunk_size):
        total = total + checkpoint(_chunk_logp, h[:, c:c + chunk_size], t[:, c:c + chunk_size],
                                   llm_params, llm_cfg, use_reentrant=False)
    return total


def soft_cross_entropy(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S)
    soft_tokens: torch.Tensor,  # (K,) candidate token ids (time tokens)
    std: float = 1.0,
    ignore_index: int = IGNORE_INDEX,
) -> torch.Tensor:
    """Gaussian-soft cross entropy over a token subset: where the label is
    one of `soft_tokens`, the target is a gaussian over the soft tokens'
    positions centred on the label's."""
    logits = logits[:, :-1].float()
    targets = labels[:, 1:].to(logits.device)
    soft_tokens = soft_tokens.to(logits.device).long()
    k = soft_tokens.shape[0]
    eq = targets[..., None] == soft_tokens  # (B, S-1, K)
    is_soft = eq.any(-1)
    tgt_idx = eq.int().argmax(-1)  # the first match; 0 where none
    positions = torch.arange(k, dtype=torch.float32, device=logits.device)
    dist = positions - tgt_idx[..., None].float()
    soft_target = torch.softmax(-0.5 * (dist / std).square(), dim=-1)
    logp = torch.log_softmax(logits[..., soft_tokens], dim=-1)
    nll = -(soft_target * logp).sum(-1)
    valid = is_soft & (targets != ignore_index)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


def dice_loss(probs: torch.Tensor, targets: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """DICE loss over (N, ...) maps, flattened per instance."""
    p = probs.reshape(probs.shape[0], -1).float()
    t = targets.reshape(targets.shape[0], -1).float()
    num = 2.0 * (p * t).sum(-1)
    den = p.sum(-1) + t.sum(-1)
    return 1.0 - (num + eps) / (den + eps)


def token_selection_loss(
    selection_probs: List[torch.Tensor],  # [(N, g, g) f32] per high-res scale
    gt_selection_maps: torch.Tensor,  # (N, H, W) binary; all-zero = no gt
) -> torch.Tensor:
    """PS3's selection supervision: BCE + DICE per scale (the gt map
    area-resized to the scale's grid, then > 0), averaged over the scales;
    instances without a gt map are masked out."""
    from vila_tpu_torch.models.ps3 import _area_resize

    gt_f = gt_selection_maps.float()
    has_gt = (gt_f.sum(dim=(-1, -2)) > 0).float()  # (N,)
    denom = has_gt.sum().clamp(min=1.0)
    total = gt_f.new_zeros(())
    for probs in selection_probs:
        g = probs.shape[1]
        gt = (_area_resize(gt_f, g, g) > 0).float()
        p = probs.float().clamp(1e-6, 1.0 - 1e-6)
        bce = -(gt * torch.log(p) + (1.0 - gt) * torch.log(1.0 - p))
        bce = (bce.mean(dim=(-1, -2)) * has_gt).sum() / denom
        dice = (dice_loss(p, gt) * has_gt).sum() / denom
        total = total + bce + dice
    return total / max(len(selection_probs), 1)
