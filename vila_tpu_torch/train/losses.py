"""Training losses, as `vila_tpu/train/losses.py`: next-token cross
entropy (shift inside, IGNORE_INDEX masking), full and chunked. The mean is
over all valid tokens of the batch, the weighting the reference rebuilds by
hand for packed rows. The soft, DICE and token-selection losses come with
the time tokens and PS3.
"""

from __future__ import annotations

from typing import Tuple

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
