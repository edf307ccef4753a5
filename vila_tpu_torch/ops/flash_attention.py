"""Flash attention for training: forward (K7) and backward (K8 dQ, K9
dK/dV), as `vila_tpu/ops/flash_attention.py`.

The three kernels are CUDA C++ for Hopper, all in
`csrc/flash_attn_sm90.cu` (wgmma, TMA and an mbarrier ring, skipping the
tiles that the causal and segment masks empty; `tile_may_attend` is their
skip test in Python). Beside each sits its
plain PyTorch version, computed densely with the same roundings, which the
wrappers take for CPU tensors only (a CUDA tensor launches the kernel or
raises):

  * `flash_fwd` (K7) -> (out, lse), plain `flash_fwd_plain`;
  * `flash_bwd_dq` (K8), plain `flash_bwd_dq_plain`;
  * `flash_bwd_dkv` (K9, dK and dV summed over the GQA group), plain
    `flash_bwd_dkv_plain`.

`flash_attention` is differentiable through `_FlashCore`, the counterpart of
the JAX package's `custom_vjp`: its forward saves q, k, v, out and lse; its
backward computes delta = rowsum(dO * O) in f32 (XLA's part in JAX) and
launches K8 and K9. `flash_block_backward` is the ring-attention backward
primitive (LSE and delta given from outside).

Semantics kept from the TPU kernels: layout (B, S, H, D); causal masking
only when Sq == Skv; scores (q . k in f32) * scale; padding never attends
(here by bounds checks instead of padded segment ids); a row with nothing
to attend to outputs 0 with LSE -1e30 and carries no gradient; P rounded to
the input dtype before P.V, dS and P before the dQ, dK, dV products; dK and
dV summed over the group. The TPU-only tiling arguments (`block_q`,
`block_kv`) have no counterpart. The kernels take bf16 with head dim 128.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vila_tpu_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIM = 128  # the only head dim the kernels take

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SOURCE = "flash_attn_sm90.cu"  # holds every entry point
_ARGTYPES = {
    "flash_fwd": [_P] * 7 + [_I] * 7 + [_F, _P],
    "flash_bwd_dq": [_P] * 9 + [_I] * 7 + [_F, _P],
    "flash_bwd_dkv": [_P] * 11 + [_I] * 7 + [_F, _P],
}


# --------------------------------------------------------------------------
# Plain versions (dense, the kernels' roundings)
# --------------------------------------------------------------------------


def _mask(b, sq, skv, causal, q_seg, kv_seg, device) -> Optional[torch.Tensor]:
    """(B, Sq, Skv) bool, True = may attend; None when nothing is masked."""
    mask = None
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=device).tril()[None]
    if q_seg is not None:
        seg = q_seg.to(device)[:, :, None] == kv_seg.to(device)[:, None, :]
        mask = seg if mask is None else mask & seg
    return None if mask is None else mask.expand(b, sq, skv)


def _scores(q, k, mask, scale):
    """(B, Hkv, G, Sq, Skv) f32 scores, masked entries -inf."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
    return s


def _group(x, hkv):
    """(B, Hq, Sq) -> (B, Hkv, G, Sq, 1)."""
    b, hq, sq = x.shape
    return x.reshape(b, hkv, hq // hkv, sq, 1)


def flash_fwd_plain(q, k, v, q_seg=None, kv_seg=None, *, causal, scale):
    """(out (B, Sq, Hq, D) in q's dtype, lse (B, Hq, Sq) f32)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    s = _scores(q, k, _mask(b, sq, skv, causal, q_seg, kv_seg, q.device), scale)
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)  # masked entries: exp(-inf) = 0
    l = p.sum(-1, keepdim=True)
    pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    out = torch.where(l == 0, 0.0, pv / torch.where(l == 0, 1.0, l))
    lse = torch.where(l == 0, _NEG_INF, m + torch.log(torch.where(l == 0, 1.0, l)))
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
    return out, lse[..., 0].reshape(b, hq, sq)


def _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale):
    """P recomputed from the LSE (rows at -1e30 carry none) and
    dS = P * (dP - delta), both (B, Hkv, G, Sq, Skv) f32."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    s = _scores(q, k, _mask(b, sq, skv, causal, q_seg, kv_seg, q.device), scale)
    lse = _group(lse.float(), hkv)
    valid = lse > _NEG_INF / 2
    p = torch.where(valid, torch.exp(s - torch.where(valid, lse, 0.0)), 0.0)
    dof = do.float().reshape(b, sq, hkv, hq // hkv, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    return p, p * (dp - _group(delta.float(), hkv))


def flash_bwd_dq_plain(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                       causal, scale):
    """dQ (B, Sq, Hq, D) in q's dtype."""
    b, sq, hq, d = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).reshape(b, sq, hq, d).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *,
                        causal, scale):
    """(dK, dV) (B, Skv, Hkv, D), summed over the GQA group, in k's and v's
    dtypes."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, q_seg, kv_seg, causal, scale)
    dof = do.to(torch.float32).reshape(b, sq, hkv, hq // hkv, d)
    qf = q.float().reshape(b, sq, hkv, hq // hkv, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p.to(do.dtype).float(), dof)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds.to(q.dtype).float(), qf) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def _range(seg, lo, hi):
    """(min, max) of the segment ids of rows [lo, hi), the padding id 0
    ordered above every sample id."""
    keys = [int(x) for x in seg[lo:hi]]
    keys = [float("inf") if x == 0 else x for x in keys]
    return min(keys), max(keys)


def tile_may_attend(q_seg, kv_seg, q0, kv0, tile, causal) -> bool:
    """The kernels' tile-skip test: False only when no (q, k) pair of the q
    tile starting at row q0 and the kv tile starting at row kv0 may attend.

    `q_seg` / `kv_seg` are one batch row's segment ids (None without
    segments); `tile` is the tile size, or (q rows, kv rows) (K7 walks
    128 x 128, K8 128 q rows x 64 kv rows, K9 64 q rows x 128 kv rows). Causal: the kv tile starts past
    the q tile's last row. Segments: the id ranges of the two tiles (rows
    inside the sequence) do not meet, with the collator's padding id 0
    ordered above every sample id. Conservative: a tile it keeps may still
    hold no allowed pair (ids out of order)."""
    tq, tkv = (tile, tile) if isinstance(tile, int) else tile
    if causal and kv0 > q0 + tq - 1:
        return False
    if q_seg is None:
        return True
    q_lo, q_hi = _range(q_seg, q0, min(q0 + tq, len(q_seg)))
    k_lo, k_hi = _range(kv_seg, kv0, min(kv0 + tkv, len(kv_seg)))
    return k_lo <= q_hi and q_lo <= k_hi


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------


def _fn(name: str):
    fn = getattr(_build.load(_SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _on_card(*tensors: Optional[torch.Tensor]) -> torch.device:
    """Checks of a kernel's tensors: one CUDA device, contiguous, 16-byte
    aligned; raises otherwise (never falls back)."""
    from vila_tpu_torch.ops.quant import require_cuda

    present = [t for t in tensors if t is not None]
    dev = require_cuda(*present)
    for t in present:
        if t.data_ptr() % 16:
            raise ValueError("flash kernels need 16-byte aligned tensors")
    return dev


def _check(q, k, v, q_seg, kv_seg):
    b, sq, hq, d = q.shape
    if q.dtype != torch.bfloat16 or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernels take bf16 q, k, v, got {q.dtype}")
    if d != HEAD_DIM or k.shape[3] != d or hq % k.shape[2]:
        raise ValueError(f"flash kernels take head dim {HEAD_DIM} and Hq % Hkv == 0, "
                         f"got q {tuple(q.shape)}, k {tuple(k.shape)}")
    for seg, s in ((q_seg, sq), (kv_seg, k.shape[1])):
        if seg is not None and (seg.dtype != torch.int32 or seg.shape != (b, s)):
            raise ValueError("segment ids must be int32 (B, S)")


def _segs(q_seg, kv_seg, device):
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("give both q and kv segment ids, or neither")
    if q_seg is None:
        return None, None
    return (q_seg.to(device, torch.int32).contiguous(),
            kv_seg.to(device, torch.int32).contiguous())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd(q, k, v, q_seg=None, kv_seg=None, *, causal, scale):
    """K7: (out (B, Sq, Hq, D), lse (B, Hq, Sq) f32)."""
    q_seg, kv_seg = _segs(q_seg, kv_seg, q.device)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check(q, k, v, q_seg, kv_seg)
    dev = _on_card(q, k, v, q_seg, kv_seg)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=dev)
    status = _fn("flash_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(q_seg), _ptr(kv_seg),
        out.data_ptr(), lse.data_ptr(), b, sq, skv, hq, hkv, d, int(causal),
        float(scale), _stream(dev))
    _build.check(status, "flash_fwd")
    _build.count("flash_fwd")
    return out, lse


def _bwd_inputs(q, k, v, do, lse, delta, q_seg, kv_seg):
    """The backward kernels' inputs made contiguous and checked, and their
    device."""
    q, k, v, do = (x.contiguous() for x in (q, k, v, do))
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    _check(q, k, v, q_seg, kv_seg)
    dev = _on_card(q, k, v, do, lse, delta, q_seg, kv_seg)
    b, sq, hq, _ = q.shape
    if do.shape != q.shape or do.dtype != q.dtype or lse.shape != (b, hq, sq) \
            or delta.shape != (b, hq, sq):
        raise ValueError("dO must match q, and lse / delta be (B, Hq, Sq)")
    return q, k, v, do, lse, delta, dev


def flash_bwd_dq(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *, causal, scale):
    """K8: dQ (B, Sq, Hq, D) from the saved LSE and delta (B, Hq, Sq) f32."""
    q_seg, kv_seg = _segs(q_seg, kv_seg, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, q_seg, kv_seg,
                                  causal=causal, scale=scale)
    q, k, v, do, lse, delta, dev = _bwd_inputs(q, k, v, do, lse, delta, q_seg, kv_seg)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dq = torch.empty_like(q)
    status = _fn("flash_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg), dq.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), float(scale), _stream(dev))
    _build.check(status, "flash_bwd_dq")
    _build.count("flash_bwd_dq")
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, q_seg=None, kv_seg=None, *, causal, scale):
    """K9: (dK, dV) (B, Skv, Hkv, D): per-head f32 blocks (one launch),
    summed over the GQA group in head order and rounded once (a second
    launch), as the TPU kernel and its group sum outside."""
    q_seg, kv_seg = _segs(q_seg, kv_seg, q.device)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_seg, kv_seg,
                                   causal=causal, scale=scale)
    q, k, v, do, lse, delta, dev = _bwd_inputs(q, k, v, do, lse, delta, q_seg, kv_seg)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty((2, b, skv, hq, d), dtype=torch.float32, device=dev)
    status = _fn("flash_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), _ptr(q_seg), _ptr(kv_seg), ws.data_ptr(), dk.data_ptr(),
        dv.data_ptr(),
        b, sq, skv, hq, hkv, d, int(causal), float(scale), _stream(dev))
    _build.check(status, "flash_bwd_dkv")
    _build.count("flash_bwd_dkv")
    return dk, dv


# --------------------------------------------------------------------------
# Differentiable entry points
# --------------------------------------------------------------------------


class _FlashCore(torch.autograd.Function):
    """out = attention(q, k, v); backward through K8 and K9."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale):
        out, lse = flash_fwd(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,  # (B, Sq)
    kv_segment_ids: Optional[torch.Tensor] = None,  # (B, Skv)
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention; differentiable when `return_lse` is False. With
    `return_lse` it returns (out, lse (B, Hq, Sq)) without a gradient, the
    form ring attention merges (its backward is `flash_block_backward`)."""
    sq, d = q.shape[1], q.shape[3]
    if scale is None:
        scale = d ** -0.5
    causal = causal and sq == k.shape[1]
    q_seg, kv_seg = _segs(q_segment_ids, kv_segment_ids, q.device)
    if return_lse:
        return flash_fwd(q, k, v, q_seg, kv_seg, causal=causal, scale=scale)
    return _FlashCore.apply(q, k, v, q_seg, kv_seg, causal, float(scale))


def flash_block_backward(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    do: torch.Tensor,  # (B, Sq, Hq, D) upstream cotangent
    lse: torch.Tensor,  # (B, Hq, Sq) merged log-sum-exp
    delta: torch.Tensor,  # (B, Hq, Sq) rowsum(dO * O_final)
    *,
    causal: bool = True,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's (dq, dk, dv) given externally merged LSE and delta (the
    ring-attention backward primitive), in the public layout."""
    sq, d = q.shape[1], q.shape[3]
    if scale is None:
        scale = d ** -0.5
    kw = dict(causal=causal and sq == k.shape[1], scale=float(scale))
    q_seg, kv_seg = _segs(q_segment_ids, kv_segment_ids, q.device)
    do = do.to(q.dtype)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, **kw)
    return dq, dk, dv
