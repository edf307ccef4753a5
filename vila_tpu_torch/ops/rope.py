"""Rotary position embeddings, as `vila_tpu/ops/rope.py`.

Rotate-half formulation (HF `modeling_qwen2`): inv_freq and cos/sin in
float32, applied in float32 and cast back to the activation dtype.
"""

from __future__ import annotations

import torch


def rope_cos_sin(
    positions: torch.Tensor,
    head_dim: int,
    theta: float = 10000.0,
    linear_scaling: float = 1.0,
):
    """(cos, sin) float32 of shape (..., S, head_dim) for int positions (..., S)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / (theta ** (exps / head_dim))
    pos = positions.float()
    if linear_scaling != 1.0:
        pos = pos / linear_scaling
    freqs = pos[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, head_dim); cos/sin: (B, S, head_dim) or (S, head_dim)."""
    if cos.ndim == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x32 = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-x32[..., half:], x32[..., :half]], dim=-1)
    return (x32 * cos + rotated * sin).to(x.dtype)
