"""FP8 numerics, as `vila_tpu/ops/fp8.py`: per-block, per-tensor,
per-group and per-tile quantizers, and the COAT linear layers and
activation ops whose forward takes E4M3 operands and whose backward takes
E5M2 gradients (capability parity: the reference's COAT stack,
`llava/model/coat/`, and `QLinearTE`, llava/model/qlinear_te.py:20).

Quantizers keep the JAX layouts: an f32 amax, a scale max(amax / FP8_MAX,
1e-12), values zero-padded to the block, `(nb, block)`, `(*lead, ng,
group)` and `(nk, bk, nn, bn)`. Two rules make the bytes equal on every
device and equal to the JAX package's run op by op:
  * the quotient amax / FP8_MAX divides by a tensor (`quant._div`): on the
    card PyTorch multiplies by the reciprocal of a Python scalar divisor;
  * the cast to fp8 is `to_fp8`, which gives JAX's result past the range:
    PyTorch's CPU cast saturates E4M3 to ±448 where JAX gives NaN, and the
    two write E5M2's NaN as different bytes.

`fp8_linear` (per-tensor scales) runs its three products on the card on
Hopper's fp8 tensor cores through `torch._scaled_mm` (f32 accumulation,
scaled by sa·sb, out in the compute dtype; JAX's `_fp8_dot`), and on the
CPU as the f32 product of the same fp8 values: the tensor's device picks
the route. `fp8_linear_grouped` (per-(row, 128) activations, per-(128 ×
128) weights) dequantizes both operands and multiplies once, as JAX does,
on every device. The activation ops compute their forward exactly and keep
per-group fp8 copies of their inputs for the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from vila_tpu_torch.ops.quant import _div

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
E4M3_MAX = 448.0
E5M2_MAX = 57344.0
DEFAULT_BLOCK = 128
# the largest |x| that rounds into E4M3's range (halfway between 448 and
# the 480 it lacks; a tie rounds to the even 448)
_E4M3_LAST = 464.0
_NAN_BYTE = {E4M3: 0x7F, E5M2: 0x7E}  # JAX's NaN bytes, sign bit apart


def _fp8_max(dtype) -> float:
    return E4M3_MAX if dtype == E4M3 else E5M2_MAX


def to_fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """`x` (f32) cast to `dtype` as `jnp.astype` casts: round to nearest
    even; E4M3 past ±464 and NaN become NaN, E5M2 overflows to ±inf and
    writes NaN as byte 0x7E, the sign kept in both."""
    bits = x.to(dtype).view(torch.uint8)
    bad = torch.isnan(x)
    if dtype == E4M3:
        bad = bad | (x.abs() > _E4M3_LAST)
    nan = torch.signbit(x).to(torch.uint8) * 0x80 + _NAN_BYTE[dtype]
    return torch.where(bad, nan, bits).view(dtype)


def _scale(amax: torch.Tensor, dtype) -> torch.Tensor:
    return torch.clamp(_div(amax, _fp8_max(dtype)), min=1e-12)


def quantize_blockwise(
    x: torch.Tensor, dtype=E4M3, block: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor, Tuple[int, ...]]:
    """Flatten -> pad -> (nb, block) fp8 values + (nb,) f32 scales.
    Returns (q, scales, orig_shape)."""
    shape = tuple(x.shape)
    flat = x.reshape(-1).float()
    pad = (-flat.shape[0]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = _scale(blocks.abs().amax(dim=1, keepdim=True), dtype)
    return to_fp8(blocks / scale, dtype), scale[:, 0], shape


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor, shape,
                         out_dtype=torch.float32) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    x = q.float() * scale[:, None]
    return x.reshape(-1)[:n].reshape(shape).to(out_dtype)


def quantize_tensor(x: torch.Tensor, dtype=E4M3) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale for the whole tensor (the fp8 matmul's operands)."""
    x32 = x.float()
    scale = _scale(x32.abs().amax(), dtype)
    return to_fp8(x32 / scale, dtype), scale


def quantize_grouped(
    x: torch.Tensor, dtype=E4M3, group: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A scale per (row, group of the last axis), the last axis zero-padded
    to a group multiple. Returns q (*lead, ng, group), scales (*lead, ng)
    f32."""
    *lead, k = x.shape
    xf = x.float()
    pad = (-k) % group
    if pad:
        xf = F.pad(xf, (0, pad))
    g = xf.reshape(*lead, -1, group)
    scale = _scale(g.abs().amax(dim=-1), dtype)
    return to_fp8(g / scale[..., None], dtype), scale


def dequantize_grouped(q: torch.Tensor, scale: torch.Tensor, k: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    x = q.float() * scale[..., None]
    return x.reshape(*q.shape[:-2], -1)[..., :k].to(out_dtype)


def quantize_block2d(
    w: torch.Tensor, dtype=E4M3, block: int = DEFAULT_BLOCK
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (K, N) weight with one scale per (block, block) tile. Returns q
    (nk, bk, nn, bn), scales (nk, nn) f32."""
    k, n = w.shape
    wf = w.float()
    pk, pn = (-k) % block, (-n) % block
    if pk or pn:
        wf = F.pad(wf, (0, pn, 0, pk))
    t = wf.reshape(-1, block, wf.shape[1] // block, block)
    scale = _scale(t.abs().amax(dim=(1, 3)), dtype)
    return to_fp8(t / scale[:, None, :, None], dtype), scale


def dequantize_block2d(q: torch.Tensor, scale: torch.Tensor, k: int, n: int,
                       out_dtype=torch.float32) -> torch.Tensor:
    t = q.float() * scale[:, None, :, None]
    nk, bk, nn, bn = t.shape
    return t.reshape(nk * bk, nn * bn)[:k, :n].to(out_dtype)


# --------------------------------------------------------------------------
# per-tensor fp8 linear
# --------------------------------------------------------------------------


def _pad_to_16(t: torch.Tensor, dims) -> torch.Tensor:
    """Zero rows / columns appended to `dims` of a 2-D fp8 tensor up to a
    multiple of 16 (`_scaled_mm`'s rule; no padding at the models' widths)."""
    pads = [0, 0, 0, 0]
    for d in dims:
        pads[2 * (1 - d) + 1] = (-t.shape[d]) % 16
    if not any(pads):
        return t
    return F.pad(t.view(torch.uint8), pads).view(t.dtype)


def fp8_mm_plain(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor, sb: torch.Tensor,
                 out_dtype) -> torch.Tensor:
    """The plain version of the fp8 product: the fp8 values upcast to f32,
    multiplied, times sa·sb, cast to `out_dtype` (on any device)."""
    return ((a.float() @ b.float()) * (sa * sb)).to(out_dtype)


def _fp8_mm(a: torch.Tensor, sa: torch.Tensor, b: torch.Tensor, sb: torch.Tensor,
            out_dtype) -> torch.Tensor:
    """(M, K) x (K, N) fp8 product accumulated in f32, times sa·sb, cast to
    `out_dtype` (JAX's `_fp8_dot`). On the card one `torch._scaled_mm`: `a`
    copied row-major and `b` column-major where their layouts differ, and
    M, K, N zero-padded to multiples of 16 where they are not. On the CPU
    `fp8_mm_plain`."""
    if a.device.type == "cpu":
        return fp8_mm_plain(a, sa, b, sb, out_dtype)
    m, n = a.shape[0], b.shape[1]
    a = _pad_to_16(a.contiguous(), (0, 1))
    b = _pad_to_16(b.t().contiguous(), (0, 1)).t()
    y = torch._scaled_mm(a, b, scale_a=sa.float(), scale_b=sb.float(),
                         out_dtype=out_dtype, use_fast_accum=False)
    return y[:m, :n]


class _FP8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        qx, sx = quantize_tensor(x, E4M3)
        qw, sw = quantize_tensor(w, E4M3)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.dtypes = (x.dtype, w.dtype)
        lead = x.shape[:-1]
        y = _fp8_mm(qx.reshape(-1, x.shape[-1]), sx, qw, sw, x.dtype)
        return y.reshape(*lead, w.shape[1])

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        qg, sg = quantize_tensor(g, E5M2)
        qg2 = qg.reshape(-1, qg.shape[-1])
        qx2 = qx.reshape(-1, qx.shape[-1])
        dx = _fp8_mm(qg2, sg, qw.t(), sw, x_dtype).reshape(*qx.shape[:-1], qw.shape[0])
        # dw = x^T g, contracting every leading dim
        dw = _fp8_mm(qx2.t(), sx, qg2, sg, w_dtype)
        return dx, dw


def fp8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w with per-tensor E4M3 operands (forward) and an E5M2
    gradient (backward): the COAT / TransformerEngine recipe."""
    return _FP8Linear.apply(x, w)


# --------------------------------------------------------------------------
# per-group fp8 linear (COAT's per-group recipe)
# --------------------------------------------------------------------------


class _FP8LinearGrouped(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        k, n = w.shape
        qx, sx = quantize_grouped(x, E4M3)
        qw, sw = quantize_block2d(w, E4M3)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.dims = (k, n, x.dtype, w.dtype)
        xd = dequantize_grouped(qx, sx, k, x.dtype)
        wd = dequantize_block2d(qw, sw, k, n, x.dtype)
        return xd @ wd

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        k, n, x_dtype, w_dtype = ctx.dims
        qg, sg = quantize_grouped(g, E5M2)
        gd = dequantize_grouped(qg, sg, n)
        wd = dequantize_block2d(qw, sw, k, n)
        xd = dequantize_grouped(qx, sx, k)
        dx = (gd @ wd.T).to(x_dtype)
        dw = (xd.reshape(-1, k).T @ gd.reshape(-1, n)).to(w_dtype)
        return dx, dw


def fp8_linear_grouped(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w with per-group E4M3 operands (activations per (row, 128),
    the weight per (128, 128) tile) and per-group E5M2 gradients; one dense
    product over the dequantized operands."""
    return _FP8LinearGrouped.apply(x, w)


# --------------------------------------------------------------------------
# activation ops whose saved inputs are per-group fp8
# --------------------------------------------------------------------------


class _FP8Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        q, s = quantize_grouped(x, E4M3)
        ctx.save_for_backward(q, s)
        ctx.meta = (x.shape[-1], x.dtype)
        return F.gelu(x)

    @staticmethod
    def backward(ctx, g):
        q, s = ctx.saved_tensors
        k, dtype = ctx.meta
        x = dequantize_grouped(q, s, k)
        # d gelu(x) / dx = Phi(x) + x phi(x)
        cdf = 0.5 * torch.erfc(-x * 0.7071067811865476)
        pdf = torch.exp(-0.5 * x * x) * 0.3989422804014327
        return (g.float() * (cdf + x * pdf)).to(dtype)


def fp8_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact gelu whose saved activation is per-group E4M3."""
    return _FP8Gelu.apply(x)


class _FP8SiluMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gate, up):
        qg, sg = quantize_grouped(gate, E4M3)
        qu, su = quantize_grouped(up, E4M3)
        ctx.save_for_backward(qg, sg, qu, su)
        ctx.meta = (gate.shape[-1], gate.dtype)
        return F.silu(gate) * up

    @staticmethod
    def backward(ctx, g):
        qg, sg, qu, su = ctx.saved_tensors
        k, dtype = ctx.meta
        gate = dequantize_grouped(qg, sg, k)
        up = dequantize_grouped(qu, su, k)
        g32 = g.float()
        sig = torch.sigmoid(gate)
        silu = gate * sig
        dsilu = sig * (1.0 + gate * (1.0 - sig))
        return (g32 * up * dsilu).to(dtype), (g32 * silu).to(dtype)


def fp8_silu_mul(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu(gate) * up (the SwiGLU pair) with fp8 saved inputs."""
    return _FP8SiluMul.apply(gate, up)


class _FP8RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        q, s = quantize_grouped(x, E4M3)
        x32 = x.float()
        rstd = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
        ctx.save_for_backward(q, s, rstd, scale)
        ctx.meta = (x.shape[-1], x.dtype)
        return (x32 * rstd * scale.float()).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        q, s, rstd, scale = ctx.saved_tensors
        k, dtype = ctx.meta
        x = dequantize_grouped(q, s, k)
        g32 = g.float() * scale.float()
        xn = x * rstd
        dx = (g32 - xn * (g32 * xn).mean(dim=-1, keepdim=True)) * rstd
        dscale = (g.float() * xn).sum(dim=tuple(range(g.ndim - 1)))
        return dx.to(dtype), dscale.to(scale.dtype), None


def fp8_rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm whose saved activation is per-group E4M3 (COAT's
    func_rmsnorm)."""
    return _FP8RMSNorm.apply(x, scale, eps)
