"""The LM head and its cross entropy on the card: every product a
tensor-core product of bf16 operands with f32 accumulation and f32 output,
what the JAX package's `jnp.dot(h_bf16, w_bf16, preferred_element_type=f32)`
computes, and one row kernel between them (`csrc/ce_rows_sm90.cu`, the
port's own: the JAX package leaves the loss to XLA; its role is the
reference's Liger fused cross entropy).

  * `tensor_core_head(device, dtype, vp)`: whether the head's products
    run on the tensor cores (the card, bf16, no vocabulary split), the one
    test that `qwen2.compute_logits` and `train.losses.fused_route` share;
  * `mm_f32(a, b)`: a @ b of bf16 operands in f32, `torch.mm(...,
    out_dtype=torch.float32)` on the card and the f32 product of the same
    bf16 values on the CPU;
  * `split_hi_lo(g)`: an f32 tensor as hi + lo, two bf16 tensors whose sum
    is within 2^-16 of it (relative), so that a backward product takes the
    f32 cotangent through bf16 operands at twice the depth;
  * `ce_rows(logits, targets, z_loss, grad)` (the kernel; plain
    `ce_rows_plain` on CPU tensors): each row's nll as `train.losses._nll`
    defines it and, with `grad`, d nll / d logits as hi rows over lo rows;
  * `head_logits(x, w)`: the f32 logits x @ w, differentiable through the
    hi / lo backward (`qwen2.compute_logits`' route on the card);
  * `lm_head_nll(h, w, targets, z_loss, chunk)`: the fused route, the sum
    of the rows' nll over chunks of rows. Each chunk's logits (one
    product), its row kernel, and the chunk's gradients (dX = G W^T and
    dW = X^T G, each one product over [G_hi; G_lo]) run in the forward, as
    Liger's do, in one logits buffer and one gradient buffer that every
    chunk reuses, so no (rows, vocab) tensor outlives the call; the backward
    scales them by the incoming gradient and rounds them to the inputs'
    dtype, as the backward of today's `.to(bf16)` casts did.

On CPU tensors every piece takes its plain version, so the CPU tests run
the route forced; `train.losses` takes it only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vila_tpu_torch.constants import IGNORE_INDEX
from vila_tpu_torch.ops import _build
from vila_tpu_torch.utils import profiling

_SOURCE = "ce_rows_sm90.cu"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p]
# f32 logits a chunk holds at most (1 GiB; its bf16 hi / lo gradient as much again)
CHUNK_ENTRIES = 1 << 28


def chunk_rows(rows: int, vocab: int) -> int:
    """Rows a chunk: the fewest equal chunks within `CHUNK_ENTRIES`."""
    chunks = max(1, -(-rows * vocab // CHUNK_ENTRIES))
    return max(1, -(-rows // chunks))


def tensor_core_head(device: torch.device, dtype: torch.dtype, vp=None) -> bool:
    """Whether the LM head's products take the tensor cores: the card, a
    bf16 head and no vocabulary split (`vp`, the `vocab_plan`). Elsewhere
    the head is the f32 product of the compute-dtype values."""
    return device.type == "cuda" and vp is None and dtype == torch.bfloat16


def mm_f32(a: torch.Tensor, b: torch.Tensor, acc: Optional[torch.Tensor] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, K) @ (K, N) of bf16 operands, accumulated and returned in f32;
    with `acc` (M, N) f32, added to it in place (on the card inside the
    product: `addmm`, beta 1); with `out` (M, N) f32, written there."""
    if a.device.type == "cuda":
        if acc is not None:
            return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
        if out is not None:
            return torch.mm(a, b, out_dtype=torch.float32, out=out)
        return torch.mm(a, b, out_dtype=torch.float32)
    prod = a.float() @ b.float()
    if acc is not None:
        return acc.add_(prod)
    return prod if out is None else out.copy_(prod)


def split_hi_lo(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) bf16 with hi + lo within 2^-16 |g|: hi = bf16(g), lo =
    bf16(g - hi)."""
    hi = g.to(torch.bfloat16)
    return hi, (g - hi.float()).to(torch.bfloat16)


# --------------------------------------------------------------------------
# The row kernel and its plain version
# --------------------------------------------------------------------------


def _into(out: Optional[torch.Tensor], value: torch.Tensor) -> torch.Tensor:
    return value if out is None else out.copy_(value)


def ce_rows_plain(logits: torch.Tensor, targets: torch.Tensor, z_loss: float, grad: bool,
                  nll_out: Optional[torch.Tensor] = None, g_out: Optional[torch.Tensor] = None):
    """(nll (R,) f32, the gradient (2R, V) bf16 or None): lse =
    logsumexp(x), nll = lse - x[t] + z_loss lse^2, g = exp(x - lse) (1 +
    2 z_loss lse) - onehot(t); ignored rows 0; g as its hi rows over its lo
    rows (`split_hi_lo`). Written into `nll_out` / `g_out` where given."""
    valid = targets != IGNORE_INDEX
    safe = torch.where(valid, targets, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, safe[:, None])[:, 0] + z_loss * lse.square()
    nll = _into(nll_out, torch.where(valid, nll, 0.0))
    if not grad:
        return nll, None
    g = torch.exp(logits - lse[:, None]) * (1.0 + 2.0 * z_loss * lse)[:, None]
    g = g.scatter_add(-1, safe[:, None], -valid[:, None].float())
    hi, lo = split_hi_lo(torch.where(valid[:, None], g, 0.0))
    return nll, _into(g_out, torch.cat([hi, lo]))


def ce_rows(logits: torch.Tensor, targets: torch.Tensor, z_loss: float, grad: bool,
            nll_out: Optional[torch.Tensor] = None, g_out: Optional[torch.Tensor] = None):
    """`ce_rows_plain` on CPU tensors; on the card one launch of
    `ce_rows_sm90.cu` over (R, V) f32 logits and (R,) int64 targets, into
    `nll_out` ((R,) f32) and `g_out` ((2R, V) bf16) where given."""
    if logits.device.type == "cpu":
        return ce_rows_plain(logits, targets, z_loss, grad, nll_out, g_out)
    from vila_tpu_torch.ops.quant import _fn, _ptr, _stream, require_cuda

    dev = require_cuda(logits, targets)
    if logits.dtype != torch.float32 or targets.dtype != torch.int64 or logits.dim() != 2 \
            or targets.shape != logits.shape[:1] or not logits.is_contiguous() \
            or not targets.is_contiguous():
        raise ValueError(f"ce_rows takes contiguous (R, V) f32 logits and (R,) int64 targets, got "
                         f"{logits.dtype} {tuple(logits.shape)}, {targets.dtype} "
                         f"{tuple(targets.shape)}")
    r, v = logits.shape
    nll = torch.empty(r, dtype=torch.float32, device=dev) if nll_out is None else nll_out
    g = None
    if grad:
        g = torch.empty((2 * r, v), dtype=torch.bfloat16, device=dev) if g_out is None else g_out
    for name, t, shape, dtype in (("nll_out", nll, (r,), torch.float32),
                                  ("g_out", g, (2 * r, v), torch.bfloat16)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype
                              or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"ce_rows: {name} must be a contiguous {dtype} {shape} on {dev}")
    status = _fn(_SOURCE, "ce_rows", _ARGTYPES)(
        logits.data_ptr(), targets.data_ptr(), nll.data_ptr(), _ptr(g), r, v,
        float(z_loss), _stream(dev))
    _build.check(status, "ce_rows")
    _build.count("ce_rows")
    return nll, g


# --------------------------------------------------------------------------
# The products and the autograd Functions
# --------------------------------------------------------------------------


def _input_grad(g2: torch.Tensor, w: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dX = (G_hi + G_lo) W^T in f32 (into `out` where given): one product
    over [G_hi; G_lo], its two halves summed."""
    x2 = mm_f32(g2, w.t())
    m = x2.shape[0] // 2
    return torch.add(x2[:m], x2[m:], out=out)


def _weight_grad(x: torch.Tensor, g2: torch.Tensor, w: torch.Tensor,
                 acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dW = x^T (G_hi + G_lo) in f32 (added to `acc` where given), one
    product over [x; x] and [G_hi; G_lo], laid out as w is ((D, V), or the
    transpose of a (V, D) table)."""
    x2 = torch.cat([x, x])
    if w.stride(-1) == 1:
        return mm_f32(x2.t(), g2, acc)
    return mm_f32(g2.t(), x2, None if acc is None else acc.t()).t()


def _rounded(x: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x * scale, rounded once to `dtype` (one pass)."""
    return torch.mul(x, scale, out=torch.empty_like(x, dtype=dtype))


class _HeadProduct(torch.autograd.Function):
    """x (M, D) @ w (D, V) in f32 from bf16 operands; the backward carries
    the f32 cotangent as hi + lo."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = torch.cat(split_hi_lo(g))
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _input_grad(g2, w).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x, g2, w).to(w.dtype)
        return dx, dw


def head_logits(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., V) f32 logits of bf16 x (..., D) and w (D, V)."""
    lead = x.shape[:-1]
    out = _HeadProduct.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[1])


class _FusedNLL(torch.autograd.Function):
    """The sum of the rows' nll of h @ w, with its gradients made chunk by
    chunk in the forward."""

    @staticmethod
    def forward(ctx, h, w, targets, z_loss, chunk, need_h, need_w):
        (n, d), v = h.shape, w.shape[1]
        rows = min(chunk, n)
        # one chunk's logits and its gradient (hi rows over lo rows), reused
        # by every chunk; the rows' nll and dX in place
        logits = h.new_empty((rows, v), dtype=torch.float32)
        g2 = h.new_empty((2 * rows, v), dtype=torch.bfloat16) if need_h or need_w else None
        nll = h.new_empty((n,), dtype=torch.float32)
        dh = h.new_empty((n, d), dtype=torch.float32) if need_h else None
        dw = None  # None: no rows, no gradient
        for c in range(0, n, chunk):
            m = min(chunk, n - c)
            hc, gc = h[c:c + m], None if g2 is None else g2[:2 * m]
            ce_rows(mm_f32(hc, w, out=logits[:m]), targets[c:c + m], z_loss, gc is not None,
                    nll_out=nll[c:c + m], g_out=gc)
            if need_h:
                _input_grad(gc, w, out=dh[c:c + m])
            if need_w:
                dw = _weight_grad(hc, gc, w, dw)
        ctx.grads = (dh, dw)
        ctx.dtypes = (h.dtype, w.dtype)
        ctx.attrs = dict(route="fused", tokens=n, chunks=-(-n // chunk))
        return nll.sum()

    @staticmethod
    def backward(ctx, grad):
        (dh, dw), (h_dtype, w_dtype) = ctx.grads, ctx.dtypes
        ctx.grads = None
        with profiling.annotate("train.lm_head", **ctx.attrs):
            gh = None if dh is None else _rounded(dh, grad, h_dtype)
            gw = None if dw is None else _rounded(dw, grad, w_dtype)
        return gh, gw, None, None, None, None, None


def lm_head_nll(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor, z_loss: float,
                chunk: int) -> torch.Tensor:
    """Sum over the rows of h (N, D) bf16 of the cross entropy of h @ w
    (w (D, V) bf16) against targets (N,) (IGNORE_INDEX rows count 0), in
    chunks of `chunk` rows."""
    grads = torch.is_grad_enabled()
    return _FusedNLL.apply(h, w, targets.long(), float(z_loss), int(chunk),
                           grads and h.requires_grad, grads and w.requires_grad)
