"""Multimodal projector, as `vila_tpu/models/projector.py` (the
`mlp_downsample` type; the other types are not ported yet).

Parameters are keyed by the reference's nn.Sequential indices ("1", "2",
...), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from vila_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    projector_type: str = "mlp_downsample"
    mm_hidden_size: int = 1152  # vision feature dim
    hidden_size: int = 1536  # LLM embedding dim
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downsample_rate(self) -> int:
        return 2 if self.projector_type == "mlp_downsample" else 1


def flat_square(x: torch.Tensor, r: int) -> torch.Tensor:
    """Reference pixel-unshuffle: (N, H, W, C) -> (N, H/r, W/r, C*r*r), the
    sides zero-padded to a multiple of r, with the reference's channel
    interleaving (adjacent columns first, then adjacent rows)."""
    n, h, w, c = x.shape
    ph, pw = (r - h % r) % r, (r - w % r) % r
    if ph or pw:
        x = torch.nn.functional.pad(x, (0, 0, 0, pw, 0, ph))
    n, h, w, c = x.shape
    x = x.reshape(n, h, w // r, c * r).permute(0, 2, 1, 3)
    x = x.reshape(n, w // r, h // r, c * r * r).permute(0, 2, 1, 3)
    return x


Spec = List[Tuple[str, int, int]]  # (op, dim_in, dim_out)


def build_spec(cfg: ProjectorConfig) -> Spec:
    if cfg.projector_type != "mlp_downsample":
        raise NotImplementedError(
            f"projector_type={cfg.projector_type!r} is not ported yet")
    m, h = cfg.mm_hidden_size, cfg.hidden_size
    return [
        ("down2", 0, 0),
        ("ln", 4 * m, 4 * m),
        ("linear", 4 * m, h),
        ("gelu", 0, 0),
        ("linear", h, h),
    ]


def init_params(generator: torch.Generator, cfg: ProjectorConfig,
                param_dtype=torch.float32) -> Params:
    dev = generator.device
    params: Params = {}
    for i, (op, din, dout) in enumerate(build_spec(cfg)):
        if op == "linear":
            w = 0.02 * torch.randn((din, dout), generator=generator, device=dev)
            params[str(i)] = {
                "kernel": w.to(param_dtype),
                "bias": torch.zeros((dout,), dtype=param_dtype, device=dev),
            }
        elif op == "ln":
            params[str(i)] = {
                "scale": torch.ones((din,), dtype=param_dtype, device=dev),
                "bias": torch.zeros((din,), dtype=param_dtype, device=dev),
            }
    return params


def forward(params: Params, cfg: ProjectorConfig, x: torch.Tensor) -> torch.Tensor:
    """x: (N, S, mm_hidden) with S a perfect square -> (N, S / r^2, hidden)."""
    dtype = cfg.compute_dtype
    x = x.to(dtype)
    for i, (op, _, _) in enumerate(build_spec(cfg)):
        if op == "down2":
            n, s, c = x.shape
            side = int(round(s ** 0.5))
            assert side * side == s, f"projector input not square: {s}"
            x = flat_square(x.reshape(n, side, side, c), 2)
            x = x.reshape(n, -1, x.shape[-1])
        elif op == "ln":
            p = params[str(i)]
            x = layer_norm(x, p["scale"], p["bias"], eps=1e-5)
        elif op == "linear":
            p = params[str(i)]
            x = x @ p["kernel"].to(dtype) + p["bias"].to(dtype)
        elif op == "gelu":
            x = torch.nn.functional.gelu(x)
    return x
