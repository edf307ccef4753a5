"""Normalization layers (functional), as `vila_tpu/ops/norms.py`.

Statistics in float32, result cast back to the input dtype (HF
`Qwen2RMSNorm` / `nn.LayerNorm` semantics).
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return (scale.float() * x32).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    eps: float = 1e-6,
) -> torch.Tensor:
    """LayerNorm with float32 statistics."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
