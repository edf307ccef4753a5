"""Simulated (fake) quantization for QAT, as `vila_tpu/ops/fake_quant.py`
(capability parity: the reference's simulated-quant module zoo,
llava/model/quantization/ — QLinear, QAct, QGELU, QLayerNorm, QMul — and
QLinearTE's simulated-FP8 path).

Every op is a plain function: `fake_quant` quantizes and dequantizes in
the forward and passes the gradient straight through (an
`autograd.Function`), so a fake-quantized forward trains with ordinary
autograd. Formats: FP8 E4M3 / E5M2 with a scale per row or per tensor,
symmetric int8 / int4 with a scale per group of the last axis (round to
nearest even, clipped to [−qmax − 1, qmax]). Divisions by the format's
maximum divide by a tensor (`quant._div`), casts to fp8 go through
`fp8.to_fp8`, so the card gives the CPU's values.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from vila_tpu_torch.ops.fp8 import E4M3, E5M2, to_fp8
from vila_tpu_torch.ops.quant import _div

_FP8_MAX = {"e4m3": 448.0, "e5m2": 57344.0}
_FP8_DTYPE = {"e4m3": E4M3, "e5m2": E5M2}


@dataclasses.dataclass(frozen=True)
class FakeQuantConfig:
    """What to simulate. fmt: "e4m3" | "e5m2" | "int8" | "int4"."""

    weight_fmt: Optional[str] = "int4"
    act_fmt: Optional[str] = "e4m3"
    group_size: int = 128  # contraction-dim group for the int formats
    per_tensor: bool = False  # FP8: one scale per tensor instead of per row


def _fq(x: torch.Tensor, fmt: str, group_size: int, per_tensor: bool) -> torch.Tensor:
    x32 = x.float()
    if fmt in _FP8_MAX:
        amax = x32.abs().amax() if per_tensor else x32.abs().amax(dim=-1, keepdim=True)
        scale = torch.clamp(_div(amax, _FP8_MAX[fmt]), min=1e-12)
        q = to_fp8(x32 / scale, _FP8_DTYPE[fmt])
        return (q.float() * scale).to(x.dtype)
    qmax = {"int8": 127, "int4": 7}[fmt]
    d = x32.shape[-1]
    g = group_size if d % group_size == 0 else d
    grouped = x32.reshape(*x32.shape[:-1], d // g, g)
    scale = torch.clamp(_div(grouped.abs().amax(dim=-1, keepdim=True), float(qmax)), min=1e-12)
    q = torch.clamp(torch.round(grouped / scale), -qmax - 1, qmax)
    return (q * scale).reshape(x32.shape).to(x.dtype)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt, group_size, per_tensor):
        return _fq(x, fmt, group_size, per_tensor)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None  # straight through


def fake_quant(x: torch.Tensor, fmt: str, group_size: int = 128,
               per_tensor: bool = False) -> torch.Tensor:
    """Quantize-dequantize `x` in `fmt`; the gradient passes straight
    through."""
    return _FakeQuant.apply(x, fmt, group_size, per_tensor)


def fq_act(x: torch.Tensor, cfg: FakeQuantConfig) -> torch.Tensor:
    """QAct: a fake-quantized activation."""
    if cfg.act_fmt is None:
        return x
    return fake_quant(x, cfg.act_fmt, cfg.group_size, cfg.per_tensor)


def fq_linear(x: torch.Tensor, w: torch.Tensor, cfg: FakeQuantConfig,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QLinear: fake-quantized weight and activation, exact matmul."""
    if cfg.weight_fmt is not None:
        w = fake_quant(w, cfg.weight_fmt, cfg.group_size, cfg.per_tensor)
    y = fq_act(x, cfg) @ w
    return y if bias is None else y + bias


def fq_gelu(x: torch.Tensor, cfg: FakeQuantConfig) -> torch.Tensor:
    """QGELU: the activation quantized after the nonlinearity (gelu's tanh
    form, `jax.nn.gelu`'s default)."""
    return fq_act(F.gelu(x, approximate="tanh"), cfg)


def fq_silu_mul(gate: torch.Tensor, up: torch.Tensor, cfg: FakeQuantConfig) -> torch.Tensor:
    """QMul(SiLU): silu(gate) * up with simulated quantization."""
    return fq_act(F.silu(gate) * up, cfg)


def fq_rms_norm(x: torch.Tensor, scale: torch.Tensor, cfg: FakeQuantConfig,
                eps: float = 1e-6) -> torch.Tensor:
    """QRMSNorm: f32 statistics, quantized output."""
    from vila_tpu_torch.ops.norms import rms_norm

    return fq_act(rms_norm(x, scale, eps), cfg)


def quantization_error(x: torch.Tensor, fmt: str, group_size: int = 128) -> torch.Tensor:
    """Relative RMS error of a format on a tensor."""
    q = _fq(x, fmt, group_size, False)
    num = (x - q).square().mean().sqrt()
    den = x.square().mean().sqrt().clamp(min=1e-12)
    return num / den
