"""Multimodal projector, NVILA's token-compression module, as
`vila_tpu/models/projector.py` (capability parity:
llava/model/multimodal_projector/base_projector.py), every type:
`identity`, `linear`, `mlp_downsample`, `mlp_downsample_2x2_fix`,
`mlp_downsample_3x3_fix`, `mlp_downsample_3x3_s2`,
`mlp_downsample_3x3_s2_new` and `mlp{N}x_gelu`.

The 2x2 / 3x3 "flat_square" downsample is a layout transform
(pixel-unshuffle with the reference's channel order). Parameters are keyed
by the reference's nn.Sequential indices ("1", "2", ...), as in the JAX
package, so HF projector checkpoints map one to one (`utils/hf_import.py`).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple

import torch

from vila_tpu_torch.ops.norms import layer_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ProjectorConfig:
    projector_type: str = "mlp_downsample"
    mm_hidden_size: int = 1152  # vision feature dim (x the number of scales for S2)
    hidden_size: int = 1536  # LLM embedding dim
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downsample_rate(self) -> int:
        if self.projector_type in ("mlp_downsample", "mlp_downsample_2x2_fix"):
            return 2
        if self.projector_type.startswith("mlp_downsample_3x3"):
            return 3
        return 1


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
    m, h = cfg.mm_hidden_size, cfg.hidden_size
    t = cfg.projector_type
    if t == "identity":
        return []
    if t == "linear":
        return [("linear", m, h)]
    if t in ("mlp_downsample", "mlp_downsample_2x2_fix"):
        return [
            ("down2", 0, 0),
            ("ln", 4 * m, 4 * m),
            ("linear", 4 * m, h),
            ("gelu", 0, 0),
            ("linear", h, h),
        ]
    if t == "mlp_downsample_3x3_fix":
        return [
            ("down3", 0, 0),
            ("ln", 9 * m, 9 * m),
            ("linear", 9 * m, 3 * m),
            ("gelu", 0, 0),
            ("ln", 3 * m, 3 * m),
            ("linear", 3 * m, h),
            ("gelu", 0, 0),
            ("linear", h, h),
        ]
    if t == "mlp_downsample_3x3_s2":
        dims = [9 * m, 3 * m, m, m // 3, h, h]
    elif t == "mlp_downsample_3x3_s2_new":
        dims = [9 * m, 4 * m, 2 * m, m, m // 3, h, h]
    else:
        match = re.match(r"^mlp(\d+)x_gelu$", t)
        if match:
            spec: Spec = [("linear", m, h)]
            for _ in range(1, int(match.group(1))):
                spec += [("gelu", 0, 0), ("linear", h, h)]
            return spec
        raise ValueError(f"unknown projector type: {t}")

    # the *_s2 family: down3x3, then [ln, linear, gelu] blocks, ending with a
    # plain linear (no gelu + ln before it)
    spec = [("down3", 0, 0)]
    for i in range(len(dims) - 2):
        spec.append(("ln", dims[i], dims[i]))
        spec.append(("linear", dims[i], dims[i + 1]))
        spec.append(("gelu", 0, 0))
    spec.append(("linear", dims[-2], dims[-1]))
    return spec


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
    """x: (N, S, mm_hidden) with S a perfect square per tile -> (N, S',
    hidden), S' = ceil(sqrt(S) / r)^2 for the downsampling types."""
    dtype = cfg.compute_dtype
    x = x.to(dtype)
    for i, (op, _, _) in enumerate(build_spec(cfg)):
        if op in ("down2", "down3"):
            n, s, c = x.shape
            side = int(round(s ** 0.5))
            assert side * side == s, f"projector input not square: {s}"
            x = flat_square(x.reshape(n, side, side, c), 2 if op == "down2" else 3)
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
