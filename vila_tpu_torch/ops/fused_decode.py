"""One whole bs=1 W4 decoder layer (K3), as
`vila_tpu/ops/fused_decode.py:fused_layer`.

On the TPU the layer is one Pallas kernel whose sequential grid and ~100 MB
of VMEM keep every intermediate on chip. A Hopper block has neither, so on
the card the same function is five hand-written launches on one stream:

  1. `decode_attn` (`csrc/decode_attn.cu`): GQA attention of the
     pre-scaled, group-padded q over the live prefix [0, fill] of layer l's
     flat cache, additive mask, f32 softmax; pad heads write zeros;
  2. o GEMV + residual:          h32  = h + x_att @ W_o[l]           (f32)
  3. gate_up GEMV, RMSNorm in:   gu   = rms(h32) * g_post[l] @ W_gu[l]
  4. down GEMV, SiLU*up in,
     residual out:               h32b = h32 + (silu(g) * u) @ W_d[l] (f32)
  5. qkv GEMV, RMSNorm in,
     bias out:                   qkv  = rms(h32b) * g_in[l+1] @ W_qkv[l+1] + b

Steps 2-5 are the W4 GEMV kernel (`csrc/w4_gemv.cu`) with its fused
prologue / epilogue variants and the TPU kernel's int8-digit arithmetic;
the residual stream stays f32 inside the layer, as on the TPU.

The TPU kernel spreads the head outputs block-diagonally over 8 rows and
sums the o product over rows only to fill MXU rows; here the padded-head
attention output is one `(1, Hkv*P*hd)` row (zeros in the pad heads) fed to
the GQA-padded o weights (`quant.pad_o_heads`). The math is the same; the
digit expansion then sees one row instead of eight, which changes only
float rounding.

The public signature is the JAX one: 8 broadcast rows of `h` in, and
`(h_new, qkv_{l+1})` out as 8-row expanded views.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Dict, Optional, Tuple

import torch

from vila_tpu_torch.ops import _build
from vila_tpu_torch.ops import quant

_P = ctypes.c_void_p
_I = ctypes.c_int
_ATTN_ARGTYPES = [_P] * 7 + [_I] * 7 + [_P]
_ATTN_CHUNK = 32  # cache rows per block of decode_attn.cu
_attn_counters: Dict[torch.device, torch.Tensor] = {}


def _rms_scale(h32, gamma_row, eps):
    var = h32.square().mean(-1, keepdim=True)
    return (h32 * torch.rsqrt(var + eps)) * gamma_row.float()


def _dout(slot) -> int:
    return slot["packed"].shape[-3] * slot["packed"].shape[-1]


def _decode_attn_ref(q32, k_rows, v_rows, mask_row, hkv, hd, grp):
    """Plain attention of the padded q (Hkv*P, hd) against live rows
    (n, Hkv*hd); returns the (1, Hkv*P*hd) bf16 o input."""
    p_rows = q32.shape[0] // hkv
    n = k_rows.shape[0]
    q = q32.float().reshape(hkv, p_rows, hd)
    k = k_rows.float().reshape(n, hkv, hd).permute(1, 0, 2)
    v = v_rows.float().reshape(n, hkv, hd).permute(1, 0, 2)
    sc = torch.einsum("gpd,gnd->gpn", q, k) + mask_row.float()
    o = torch.einsum("gpn,gnd->gpd", torch.softmax(sc, dim=-1), v)
    o[:, grp:] = 0.0
    return o.reshape(1, hkv * p_rows * hd).to(torch.bfloat16)


def _plan(q32, o_slot, qkv_slot, k_cache, gamma_post, gamma_in, layer_index,
          fill, hkv, num_q_heads):
    """Layer indices, live rows, group sizes and the bf16 rows of the
    per-layer vectors, shared by the kernel path and its plain version."""
    L = o_slot["packed"].shape[0]
    l = operator.index(layer_index)
    l_next = min(l + 1, L - 1)
    n_rows = k_cache.shape[2] if fill is None else operator.index(fill) + 1
    p_rows = q32.shape[0] // hkv
    grp = num_q_heads // hkv if num_q_heads else p_rows
    bias = qkv_slot.get("bias")
    rows = (
        gamma_post[l].to(torch.bfloat16),
        gamma_in[l_next].to(torch.bfloat16),
        None if bias is None else bias[l_next].to(torch.bfloat16),
    )
    return l, l_next, n_rows, p_rows, grp, rows


def _fused_layer_ref(q32, mask, h, layer_index, k_cache, v_cache,
                     o_slot, gu_slot, down_slot, qkv_slot,
                     gamma_post, gamma_in, *, hkv, hd, eps=1e-6, fill=None,
                     num_q_heads=None):
    """Plain version of the five launches (the signature of `fused_layer`)."""
    l, l_next, n_rows, _, grp, (gpost, gin, bias) = _plan(
        q32, o_slot, qkv_slot, k_cache, gamma_post, gamma_in, layer_index,
        fill, hkv, num_q_heads,
    )
    x_att = _decode_attn_ref(
        q32, k_cache[l, 0, :n_rows], v_cache[l, 0, :n_rows],
        mask[0, :n_rows], hkv, hd, grp,
    )
    h32 = h[0:1].float() + quant._w4_gemv_ref(
        x_att, o_slot["packed"], o_slot["scales"], l, out_f32=True)
    x1 = _rms_scale(h32, gpost, eps).to(torch.bfloat16)
    gu = quant._w4_gemv_ref(x1, gu_slot["packed"], gu_slot["scales"], l)
    inter = gu.shape[1] // 2
    gu32 = gu.float()
    m_act = (torch.nn.functional.silu(gu32[:, :inter]) * gu32[:, inter:]).to(
        torch.bfloat16)
    h32b = h32 + quant._w4_gemv_ref(
        m_act, down_slot["packed"], down_slot["scales"], l, out_f32=True)
    x2 = _rms_scale(h32b, gin, eps).to(torch.bfloat16)
    qkv = quant._w4_gemv_ref(
        x2, qkv_slot["packed"], qkv_slot["scales"], l_next, out_f32=True)
    if bias is not None:
        qkv = qkv + bias.float()
    d_model = h.shape[1]
    h_new, qkv = h32b.to(h.dtype), qkv.to(torch.bfloat16)
    return h_new.expand(8, d_model), qkv.expand(8, qkv.shape[1])


def _launch_attn(q32, k_cache, v_cache, mask, l, n_rows, hkv, hd, grp, out):
    dev = quant.require_cuda(q32, k_cache, v_cache, mask, out)
    if q32.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 or (
        v_cache.dtype != torch.bfloat16
    ):
        raise TypeError("decode attention takes a bf16 q and a bf16 cache")
    if mask.dtype != torch.float32:
        raise TypeError("the additive mask is f32")
    _, b, s_len, kv_ld = k_cache.shape
    p_rows = q32.shape[0] // hkv
    if (b != 1 or kv_ld != hkv * hd or not 0 < n_rows <= s_len or hd % 32
            or hd > 256 or not grp <= p_rows <= 8):
        raise ValueError(f"cache {tuple(k_cache.shape)}, rows {n_rows}, hd {hd}, "
                         f"group {grp} of {p_rows}")
    nsplit = -(-n_rows // _ATTN_CHUNK)
    ws = torch.empty((hkv * p_rows, nsplit, hd + 2), dtype=torch.float32, device=dev)
    if dev not in _attn_counters or _attn_counters[dev].numel() < hkv:
        _attn_counters[dev] = torch.zeros(max(hkv, 64), dtype=torch.int32, device=dev)
    layer_off = l * s_len * kv_ld * 2
    fn = quant._fn("decode_attn.cu", "decode_attn", _ATTN_ARGTYPES)
    status = fn(
        q32.data_ptr(), k_cache.data_ptr() + layer_off,
        v_cache.data_ptr() + layer_off, mask.data_ptr(), out.data_ptr(),
        ws.data_ptr(), _attn_counters[dev].data_ptr(),
        hkv, n_rows, grp, p_rows, hd, kv_ld, nsplit,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(status, "decode_attn")


def fused_layer(
    q32: torch.Tensor,  # (Hkv*P, hd) bf16: rope'd, scaled, group-padded q
    mask: torch.Tensor,  # (1, S) f32 additive
    h: torch.Tensor,  # (8, D), row 0 real
    layer_index: int,
    k_cache: torch.Tensor,  # (L, 1, S, Hkv*hd) flat decode cache
    v_cache: torch.Tensor,
    o_slot, gu_slot, down_slot, qkv_slot,
    gamma_post: torch.Tensor,  # (L, D)
    gamma_in: torch.Tensor,  # (L, D)
    *,
    hkv: int, hd: int, eps: float = 1e-6,
    fill: Optional[int] = None,  # last written cache slot
    num_q_heads: Optional[int] = None,  # real q heads (pad heads -> zeros)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer (bs=1, W4): returns (h_new (8, D), qkv of layer
    l+1 (8, dqkv)), row 0 real. Attention reads only the live prefix
    [0, fill] of the cache. `num_q_heads` (an addition to the JAX
    signature) names the real heads so the pad heads' outputs are zero."""
    if q32.device.type == "cpu":
        return _fused_layer_ref(
            q32, mask, h, layer_index, k_cache, v_cache,
            o_slot, gu_slot, down_slot, qkv_slot, gamma_post, gamma_in,
            hkv=hkv, hd=hd, eps=eps, fill=fill, num_q_heads=num_q_heads,
        )
    l, l_next, n_rows, p_rows, grp, (gpost, gin, bias) = _plan(
        q32, o_slot, qkv_slot, k_cache, gamma_post, gamma_in, layer_index,
        fill, hkv, num_q_heads,
    )
    if h.dtype != torch.bfloat16:
        raise TypeError("the card's fused layer carries h in bf16")
    dev, d_model = q32.device, h.shape[1]
    x_att = torch.empty((1, hkv * p_rows * hd), dtype=torch.bfloat16, device=dev)
    _launch_attn(q32, k_cache, v_cache, mask, l, n_rows, hkv, hd, grp, x_att)
    h32 = torch.empty((1, d_model), dtype=torch.float32, device=dev)
    quant.launch_gemv(x_att, o_slot["packed"], o_slot["scales"], l, m=1,
                      res_bf16=h[0:1], out_f32=h32)
    gu = torch.empty((1, _dout(gu_slot)), dtype=torch.bfloat16, device=dev)
    quant.launch_gemv(h32, gu_slot["packed"], gu_slot["scales"], l, m=1,
                      prologue=quant.PRO_RMS, gamma=gpost, eps=eps, out_bf16=gu)
    h32b = torch.empty((1, d_model), dtype=torch.float32, device=dev)
    h_new = torch.empty((1, d_model), dtype=torch.bfloat16, device=dev)
    quant.launch_gemv(gu, down_slot["packed"], down_slot["scales"], l, m=1,
                      prologue=quant.PRO_SILU, res_f32=h32, out_f32=h32b,
                      out_bf16=h_new)
    qkv = torch.empty((1, _dout(qkv_slot)), dtype=torch.bfloat16, device=dev)
    quant.launch_gemv(h32b, qkv_slot["packed"], qkv_slot["scales"], l_next,
                      m=1, prologue=quant.PRO_RMS, gamma=gin, eps=eps,
                      bias=bias, out_bf16=qkv)
    _build.LAUNCHES["fused_layer"] += 1
    return h_new.expand(8, d_model), qkv.expand(8, qkv.shape[1])
