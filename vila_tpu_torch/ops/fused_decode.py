"""The fused W4 decode layers, as `vila_tpu/ops/fused_decode.py`: K3
`fused_layer` (bs=1), K6 `fused_layer_batched` (1 < B <= 16) and the
two-kernel layer K4 `fused_o_gateup` + K5 `fused_down_qkv` (any m <= 32).

On the TPU each is one Pallas kernel whose sequential grid and ~100 MB of
VMEM keep every intermediate on chip. The layer's stages are:

  1. attention: GQA attention of the pre-scaled, group-padded q over each
     row's live prefix [0, fill] of layer l's flat cache, additive mask,
     f32 softmax; pad heads write zeros;
  2. o GEMV + residual:          h32  = h + x_att @ W_o[l]           (f32)
  3. gate_up GEMV, RMSNorm in:   gu   = rms(h32) * g_post[l] @ W_gu[l]
  4. down GEMV, SiLU*up in,
     residual out:               h32b = h32 + (silu(g) * u) @ W_d[l] (f32)
  5. qkv GEMV, RMSNorm in,
     bias out:                   qkv  = rms(h32b) * g_in[l+1] @ W_qkv[l+1] + b

K3 is one persistent cooperative launch per layer
(`csrc/decode_layer_sm90.cu`: one CTA per SM, grid-wide barriers between
the stages, every weight tile streamed by TMA from the launch on; its plan:
`layer_plan`, `attn_plan`). K6 is nine launches: attention
(`csrc/decode_attn.cu` `decode_attn_batched`, on the tensor cores), then per
product the digit pass `w4_digits` and one tensor-core weight pass for all
rows (`quant.launch_gemv_rows`, `csrc/w4_gemv_mma.cu`).

K4 is stages 2-3 and K5 stages 4-5, one persistent cooperative launch each
(`csrc/w4_pair_sm90.cu`: both products' weights streamed by TMA from the
launch on, each prologue computed once over the grid, one tensor-core weight
pass for all m <= 32 rows; its plan: `quant.unit_plan`); unlike the whole layer
they hand h back rounded to h's dtype in between (K5 adds to K4's rounded
h_new), while each RMSNorm still reads its unrounded f32 sum, as on the
TPU. Every route keeps the TPU kernels' int8-digit arithmetic, with rows =
the m tokens or batch rows, and the prologue values of `csrc/w4_common.cuh`
(`quant._prologue_ref`). The W4 groups are any multiple of 16 up to 128
(112 at Qwen2-0.5B's D = 896), the head dims 64 or 128.

The TPU kernels spread the head outputs block-diagonally over 8 rows and
pad the batch to 8 or 16 rows only to fill MXU rows; here each row's
padded-head attention output is one `(Hkv*P*hd)` row (zeros in the pad
heads) fed to the GQA-padded o weights (`quant.pad_o_heads`), and no pad
rows are added. The math is the same; the digit expansion then sees other
rows, which changes only float rounding.

Each wrapper takes its plain PyTorch version for CPU tensors only; a CUDA
tensor launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vila_tpu_torch.ops import _build
from vila_tpu_torch.ops import quant
from vila_tpu_torch.utils.device import host_to_device

_P = ctypes.c_void_p
_I = ctypes.c_int
_ATTN_B_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
_ATTN_B_CHUNK = 128  # cache rows per block of decode_attn.cu's batched kernel
_ATTN_COUNTER_SLOTS = 1024  # (batch row, kv head) arrival counters
HEAD_DIMS = (64, 128)  # the head dims of K3's and K6's attention
_attn_counters: Dict[torch.device, torch.Tensor] = {}
_rows_memo: Dict[torch.device, Tuple[Tuple[int, ...], torch.Tensor]] = {}
_layer_ws: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_layer_ws_floats: Dict[Tuple[int, ...], int] = {}
_state_lock = threading.Lock()


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


def _layer_rows(o_slot, qkv_slot, gamma_post, gamma_in, layer_index):
    """Layer indices and the bf16 rows of the per-layer vectors (layer l's
    post-attention norm, layer l+1's input norm and qkv bias; the last
    layer streams its own qkv again, clamped as in the JAX package)."""
    L = o_slot["packed"].shape[0]
    l = operator.index(layer_index)
    l_next = min(l + 1, L - 1)
    bias = qkv_slot.get("bias")
    rows = (
        gamma_post[l].to(torch.bfloat16),
        gamma_in[l_next].to(torch.bfloat16),
        None if bias is None else bias[l_next].to(torch.bfloat16),
    )
    return l, l_next, rows


def _live_rows(fill, batch: int, s_len: int) -> Tuple[int, ...]:
    """Cache rows each batch row attends over: `fill` (the last written
    slot, one int or one per row, host values) + 1, clamped to the cache (an
    idle slot's cursor runs past it); all of it when `fill` is None."""
    if fill is None:
        return (s_len,) * batch
    fills = list(fill) if hasattr(fill, "__iter__") else [fill] * batch
    if len(fills) != batch:
        raise ValueError(f"{len(fills)} cursors for {batch} rows")
    return tuple(min(operator.index(f) + 1, s_len) for f in fills)


def _group(q_rows, hkv, num_q_heads):
    """(padded group P, real group G) of a group-padded q."""
    p_rows = q_rows // hkv
    return p_rows, (num_q_heads // hkv if num_q_heads else p_rows)


# Plain versions of the GEMV stages (`quant._w4_gemv_ref` with the
# kernel's prologues and epilogues written out; f32 sums unrounded)


def _o_gateup_ref(x_att, h, l, o_slot, gu_slot, gpost, eps):
    """(h32, gu): h32 = h + x_att @ W_o[l] (f32); gu = rms(h32)*g @ W_gu[l]."""
    h32 = h.float() + quant._w4_gemv_ref(
        x_att, o_slot["packed"], o_slot["scales"], l, out_f32=True)
    x1 = quant._prologue_ref(h32, quant.PRO_RMS, gpost, eps).to(torch.bfloat16)
    return h32, quant._w4_gemv_ref(x1, gu_slot["packed"], gu_slot["scales"], l)


def _down_qkv_ref(gu, h, l, l_next, down_slot, qkv_slot, gin, bias, eps):
    """(h32, qkv): h32 = h + (silu(g)*u) @ W_d[l] (f32);
    qkv = rms(h32)*g @ W_qkv[l+1] + b, rounded to bf16 once."""
    m_act = quant._prologue_ref(gu, quant.PRO_SILU).to(torch.bfloat16)
    h32 = h.float() + quant._w4_gemv_ref(
        m_act, down_slot["packed"], down_slot["scales"], l, out_f32=True)
    x2 = quant._prologue_ref(h32, quant.PRO_RMS, gin, eps).to(torch.bfloat16)
    qkv = quant._w4_gemv_ref(
        x2, qkv_slot["packed"], qkv_slot["scales"], l_next, out_f32=True)
    if bias is not None:
        qkv = qkv + bias.float()
    return h32, qkv.to(torch.bfloat16)


def _layer_tail_ref(x_att, h, l, l_next, slots, rows, eps):
    """Plain o / gate_up / down / qkv_{l+1} of a whole layer (the residual
    stays f32 between them); returns (h_new in h's dtype, qkv bf16)."""
    o_slot, gu_slot, down_slot, qkv_slot = slots
    gpost, gin, bias = rows
    h32, gu = _o_gateup_ref(x_att, h, l, o_slot, gu_slot, gpost, eps)
    h32b, qkv = _down_qkv_ref(gu, h32, l, l_next, down_slot, qkv_slot, gin, bias, eps)
    return h32b.to(h.dtype), qkv


def _fused_layer_ref(q32, mask, h, layer_index, k_cache, v_cache,
                     o_slot, gu_slot, down_slot, qkv_slot,
                     gamma_post, gamma_in, *, hkv, hd, eps=1e-6, fill=None,
                     num_q_heads=None):
    """Plain version of the layer kernel (the signature of `fused_layer`)."""
    l, l_next, rows = _layer_rows(o_slot, qkv_slot, gamma_post, gamma_in, layer_index)
    (n_rows,) = _live_rows(fill, 1, k_cache.shape[2])
    _, grp = _group(q32.shape[0], hkv, num_q_heads)
    x_att = _decode_attn_ref(
        q32, k_cache[l, 0, :n_rows], v_cache[l, 0, :n_rows],
        mask[0, :n_rows], hkv, hd, grp,
    )
    h_new, qkv = _layer_tail_ref(
        x_att, h[0:1], l, l_next, (o_slot, gu_slot, down_slot, qkv_slot), rows, eps)
    d_model = h.shape[1]
    return h_new.expand(8, d_model), qkv.expand(8, qkv.shape[1])


def _fused_layer_batched_ref(q32, mask, h, layer_index, k_cache, v_cache,
                             o_slot, gu_slot, down_slot, qkv_slot,
                             gamma_post, gamma_in, *, hkv, hd, eps=1e-6,
                             fill=None, num_q_heads=None):
    """Plain version of `fused_layer_batched`: row b attends over its own
    live prefix, then the layer's four products with rows = batch rows."""
    l, l_next, rows = _layer_rows(o_slot, qkv_slot, gamma_post, gamma_in, layer_index)
    _, grp = _group(q32.shape[1], hkv, num_q_heads)
    x_att = torch.cat([
        _decode_attn_ref(q32[b], k_cache[l, b, :n], v_cache[l, b, :n],
                         mask[b, :n], hkv, hd, grp)
        for b, n in enumerate(_live_rows(fill, q32.shape[0], k_cache.shape[2]))
    ])
    return _layer_tail_ref(
        x_att, h, l, l_next, (o_slot, gu_slot, down_slot, qkv_slot), rows, eps)


def _fused_o_gateup_ref(attn_out, h, layer_index, o_slot, gu_slot, gamma_post,
                        eps=1e-6):
    l = operator.index(layer_index)
    h32, gu = _o_gateup_ref(attn_out, h, l, o_slot, gu_slot,
                            gamma_post[l].to(torch.bfloat16), eps)
    return h32.to(h.dtype), gu


def _fused_down_qkv_ref(gu, h, layer_index, down_slot, qkv_slot, gamma_in,
                        eps=1e-6):
    l, l_next, (_, gin, bias) = _layer_rows(
        down_slot, qkv_slot, gamma_in, gamma_in, layer_index)
    h32, qkv = _down_qkv_ref(gu, h, l, l_next, down_slot, qkv_slot, gin, bias, eps)
    return h32.to(h.dtype), qkv


def _check_attn_dtypes(q32, k_cache, v_cache, mask):
    if q32.dtype != torch.bfloat16 or k_cache.dtype != torch.bfloat16 or (
        v_cache.dtype != torch.bfloat16
    ):
        raise TypeError("decode attention takes a bf16 q and a bf16 cache")
    if mask.dtype != torch.float32:
        raise TypeError("the additive mask is f32")


def _attn_counters_of(dev: torch.device, n: int) -> torch.Tensor:
    """Zeroed arrival counters of decode_attn.cu on a device (at least n),
    made once; every launch leaves them zeroed. Launches share them, so
    they must run on one stream (the serving loop and its admission thread
    both use the device's current stream)."""
    with _state_lock:
        c = _attn_counters.get(dev)
        if c is None or c.numel() < n:
            c = _attn_counters[dev] = torch.zeros(
                max(n, _ATTN_COUNTER_SLOTS), dtype=torch.int32, device=dev)
        return c


def _live_rows_on(dev: torch.device, n_rows: Tuple[int, ...]) -> torch.Tensor:
    """The (B,) int32 live-row counts on the card. Every layer of a decode
    step passes the same counts, so the last copy is kept: one host-to-device
    copy (pinned, asynchronous) per step, none per layer, no read back."""
    with _state_lock:
        hit = _rows_memo.get(dev)
        if hit is None or hit[0] != n_rows:
            hit = _rows_memo[dev] = (
                n_rows, host_to_device(np.asarray(n_rows, np.int32), dev))
        return hit[1]


def _launch_attn_batched(q32, k_cache, v_cache, mask, l, n_rows, hkv, hd, grp, out):
    """Batched attention (`decode_attn_batched`, head dim 64 or 128): q32 (B,
    Hkv*P, hd), mask (B, S), layer l of the (L, B, S, Hkv*hd) caches, host
    live rows `n_rows` (B,), out (B, Hkv*P*hd)."""
    dev = quant.require_cuda(q32, k_cache, v_cache, mask, out)
    _check_attn_dtypes(q32, k_cache, v_cache, mask)
    L, b, s_len, kv_ld = k_cache.shape
    q_b, q_rows, q_hd = q32.shape
    p_rows = q_rows // hkv
    if (q_b != b or len(n_rows) != b or mask.shape != (b, s_len) or q_hd != hd
            or kv_ld != hkv * hd or hd not in HEAD_DIMS
            or not grp <= p_rows <= 8 or p_rows * hkv != q_rows
            or not all(0 < n <= s_len for n in n_rows) or not 0 <= l < L):
        raise ValueError(f"q {tuple(q32.shape)}, cache {tuple(k_cache.shape)}, "
                         f"rows {n_rows}, hd {hd}, group {grp} of {p_rows}")
    nsplit = -(-max(n_rows) // _ATTN_B_CHUNK)
    ws = torch.empty((b, q_rows, nsplit, hd + 2), dtype=torch.float32, device=dev)
    layer_off = l * b * s_len * kv_ld * 2
    fn = quant._fn("decode_attn.cu", "decode_attn_batched", _ATTN_B_ARGTYPES)
    status = fn(
        q32.data_ptr(), k_cache.data_ptr() + layer_off,
        v_cache.data_ptr() + layer_off, mask.data_ptr(), out.data_ptr(),
        ws.data_ptr(), _attn_counters_of(dev, b * hkv).data_ptr(),
        _live_rows_on(dev, tuple(n_rows)).data_ptr(),
        b, hkv, s_len, grp, p_rows, hd, kv_ld, nsplit, quant._stream(dev),
    )
    _build.check(status, "decode_attn_batched")


def _residual(h: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rows GEMV's epilogue argument that adds residual rows h (bf16
    rows, or the f32 sum of the layer's previous stage)."""
    return {"res_bf16": h} if h.dtype == torch.bfloat16 else {"res_f32": h}


def _launch_o_gateup(x_att, h, l, o_slot, gu_slot, gpost, eps, h_new=None):
    """K6's o and gate_up stages, each a digit pass and a tensor-core rows
    GEMV (`quant.launch_gemv_rows`): h32 = h + x_att @ W_o[l] (f32, and
    rounded into `h_new` when given); gu = rms(h32)*g @ W_gu[l]. Returns
    (h32, gu)."""
    m, dev = x_att.shape[0], x_att.device
    h32 = torch.empty((m, h.shape[1]), dtype=torch.float32, device=dev)
    quant.launch_gemv_rows(x_att, o_slot["packed"], o_slot["scales"], l, m=m,
                           out_f32=h32, out_bf16=h_new, **_residual(h))
    gu = torch.empty((m, _dout(gu_slot)), dtype=torch.bfloat16, device=dev)
    quant.launch_gemv_rows(h32, gu_slot["packed"], gu_slot["scales"], l, m=m,
                           prologue=quant.PRO_RMS, gamma=gpost, eps=eps, out_bf16=gu)
    return h32, gu


def _launch_down_qkv(gu, h, l, l_next, down_slot, qkv_slot, gin, bias, eps,
                     h_new=None):
    """K6's down and qkv stages (as `_launch_o_gateup`): h32 = h +
    (silu(g)*u) @ W_d[l] (f32, and rounded into `h_new` when given); qkv =
    rms(h32)*g @ W_qkv[l+1] + b (bf16). Returns (h32, qkv)."""
    m, dev = gu.shape[0], gu.device
    h32 = torch.empty((m, h.shape[1]), dtype=torch.float32, device=dev)
    quant.launch_gemv_rows(gu, down_slot["packed"], down_slot["scales"], l, m=m,
                           prologue=quant.PRO_SILU, out_f32=h32, out_bf16=h_new,
                           **_residual(h))
    qkv = torch.empty((m, _dout(qkv_slot)), dtype=torch.bfloat16, device=dev)
    quant.launch_gemv_rows(h32, qkv_slot["packed"], qkv_slot["scales"], l_next, m=m,
                           prologue=quant.PRO_RMS, gamma=gin, eps=eps, bias=bias,
                           out_bf16=qkv)
    return h32, qkv


def _bf16_like(h: torch.Tensor) -> torch.Tensor:
    """An empty tensor for h_new: the card's fused layers carry h in bf16."""
    if h.dtype != torch.bfloat16:
        raise TypeError(f"the card's fused layers carry h in bf16, got {h.dtype}")
    return torch.empty(h.shape, dtype=h.dtype, device=h.device)


def _launch_layer_tail(x_att, h, l, l_next, slots, rows, eps):
    """K6's four GEMV stages with rows = x_att's rows (each a digit pass
    and one tensor-core weight pass for all rows); the residual stays f32
    from o to down. Returns (h_new bf16, qkv bf16)."""
    o_slot, gu_slot, down_slot, qkv_slot = slots
    gpost, gin, bias = rows
    h_new = _bf16_like(h)
    h32, gu = _launch_o_gateup(x_att, h, l, o_slot, gu_slot, gpost, eps)
    _, qkv = _launch_down_qkv(gu, h32, l, l_next, down_slot, qkv_slot, gin, bias,
                              eps, h_new=h_new)
    return h_new, qkv


# --------------------------------------------------------------------------
# K4, K5: one persistent launch each (csrc/w4_pair_sm90.cu)
# --------------------------------------------------------------------------

# the most K splits of a product's column tiles: product 1's partials are
# summed by each row's owner CTA, two splits a round (few), product 2's by a
# pass spread over the grid
PAIR_SPLIT_CAPS = (4, 16)
_PAIR_PTRS = ctypes.c_void_p * 13
_PAIR_INTS = ctypes.c_int * 23
_pair_ws: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_pair_ws_floats: Dict[Tuple[int, ...], int] = {}
_pair_last: Dict[torch.device, ctypes.Array] = {}


def pair_work(dims, n_cta: int):
    """Every unit of K4's or K5's two products, (din, dout) or (din, dout,
    group) each in `dims` (the group is the quantizer's, `quant.group_for`,
    when not given), as the kernel deals them: (product, CTA, column tile,
    split, columns range, groups range)."""
    for p, dim in enumerate(dims):
        din, dout = dim[:2]
        gs = dim[2] if len(dim) > 2 else quant.group_for(din // 2)
        ngh = din // 2 // gs
        whole, ks, gps = quant.unit_plan(dout, ngh, n_cta, PAIR_SPLIT_CAPS[p])
        tiles = dout // LAYER_TILE_N
        rest = tiles - whole
        for u in range(whole + rest * ks):
            if u < whole:
                tile, z, g = u, 0, (0, ngh)
            else:
                z, t = divmod(u - whole, rest)
                tile, g = whole + t, (z * gps, min(ngh, (z + 1) * gps))
            yield (p, u % n_cta, tile, z,
                   (tile * LAYER_TILE_N, (tile + 1) * LAYER_TILE_N), g)


def _pair_workspace(dev: torch.device, ints) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's K4/K5 scratch (f32, grown to what the plan needs, else
    made once) and its words (zeroed once): the grid barrier's 64-bit
    arrival count, which every launch advances and none resets, then the two
    products' (row, plane) amax words, which it leaves zeroed. Launches share
    them, so they run on one stream."""
    key = tuple(ints[:6]) + tuple(ints[7:])
    with _state_lock:
        floats = _pair_ws_floats.get(key)
        if floats is None:
            fn = getattr(_build.load("w4_pair_sm90.cu"), "w4_pair_ws_floats")
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_longlong
            floats = _pair_ws_floats[key] = int(fn(ctypes.cast(ints, ctypes.c_void_p)))
        ws, bar = _pair_ws.get(dev, (None, None))
        if bar is None:
            bar = torch.zeros(2 + 4 * 32, dtype=torch.int32, device=dev)
        if ws is None or ws.numel() < floats:
            ws = torch.empty(floats, dtype=torch.float32, device=dev)
        _pair_ws[dev] = (ws, bar)
        return ws, bar


def pair_first_digits(dev: torch.device):
    """The digits (2, 2, m_pad, ngh * gp) int8 and lo-plane group sums (ngh,
    2, m_pad) int32 of product 1 of the device's last K4/K5 launch, as the
    launch left them in its workspace (for checks: `quant._w4_digits_ref`'s
    layout)."""
    ints = _pair_last[dev]
    ws, _ = _pair_ws[dev]
    fn = getattr(_build.load("w4_pair_sm90.cu"), "w4_pair_ws_offsets")
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], None
    off = (ctypes.c_longlong * 6)()
    fn(ctypes.cast(ints, ctypes.c_void_p), ctypes.cast(off, ctypes.c_void_p))
    m_pad, din, gs = ints[1], ints[7], ints[11]
    ngh = din // 2 // gs
    hp = ngh * quant.padded_group(gs)
    raw = ws.view(torch.uint8)
    digits = raw[off[0] * 4:off[0] * 4 + 4 * m_pad * hp].view(torch.int8)
    gsum = raw[off[2] * 4:off[2] * 4 + ngh * 2 * m_pad * 4].view(torch.int32)
    return digits.reshape(2, 2, m_pad, hp), gsum.reshape(ngh, 2, m_pad)


def launch_pair(x, h, gamma, bias, first, second, prologue, eps, h_out, out,
                stamps=None) -> None:
    """Launch K4 (prologue `quant.PRO_NONE`: x = attention rows) or K5
    (`quant.PRO_SILU`: x = gate | up rows) on the current stream: first =
    (slot, layer) of product 1 (o or down), second = (slot, layer) of
    product 2 (gate_up or qkv); h (m, D) bf16 residual, gamma (D,) the RMS
    scale of product 2's input, bias (dout2,) or None; h_out (m, D) and out
    (m, dout2) bf16. `stamps`, nine int64 on the card, receives CTA 0's
    %globaltimer at the start, after each grid barrier and at the end (for
    checks). Counts nothing."""
    dev = quant.require_cuda(x, h, gamma, h_out, out)
    m, d_model = h.shape
    if not 1 <= m <= 32 or x.shape[0] != m or h_out.shape != (m, d_model):
        raise ValueError(f"K4/K5 take 1..32 rows: x {tuple(x.shape)}, h {tuple(h.shape)}")
    for t in (x, h, gamma, h_out, out) + (() if bias is None else (bias,)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"K4/K5 take and return bf16, got {t.dtype}")
    if bias is not None:
        quant.require_cuda(x, bias)
    if any(t.data_ptr() % 16 for t in (x, h, gamma, h_out, out)):
        raise ValueError("K4/K5 take 16-byte aligned rows")
    n_sm, _ = quant._device_state(dev)
    dims, ptrs = [], []
    for p, (slot, li) in enumerate((first, second)):
        pk, sc = slot["packed"], slot["scales"]
        quant.require_cuda(x, pk, sc)
        quant._check_w4(pk, sc)
        half, bout, nj, ngh, gs, din, dout = quant._tiled_meta(pk, sc)
        quant.check_group(gs, "K4/K5")
        if bout % LAYER_TILE_N:
            raise ValueError(f"K4/K5 need bout % 128 == 0 ({bout})")
        s_rows = sc.shape[-2]
        _, _, l = quant._layer(pk, sc, li)
        dims += [din, dout, bout, s_rows, gs,
                 *quant.unit_plan(dout, ngh, n_sm, PAIR_SPLIT_CAPS[p])]
        ptrs += [pk.data_ptr() + l * nj * half * bout, sc.data_ptr() + l * nj * s_rows * bout * 2]
    din1, dout1, din2, dout2 = dims[0], dims[1], dims[8], dims[9]
    ldx = 2 * din1 if prologue == quant.PRO_SILU else din1
    if (x.shape != (m, ldx) or dout1 != d_model or din2 != d_model or out.shape != (m, dout2)
            or gamma.numel() != d_model or (bias is not None and bias.numel() != dout2)):
        raise ValueError(f"x {tuple(x.shape)}, h {tuple(h.shape)}, out {tuple(out.shape)} "
                         f"against products ({din1}, {dout1}) and ({din2}, {dout2})")
    ints = _PAIR_INTS(m, 8 * -(-m // 8), ldx, d_model, n_sm, prologue,
                      quant._device_index(dev), *dims)
    ws, bar = _pair_workspace(dev, ints)
    _pair_last[dev] = ints
    args = _PAIR_PTRS(x.data_ptr(), h.data_ptr(), gamma.data_ptr(), quant._ptr(bias),
                      h_out.data_ptr(), out.data_ptr(), ws.data_ptr(), bar.data_ptr(),
                      quant._ptr(stamps), *ptrs)
    fn = quant._fn("w4_pair_sm90.cu", "w4_pair",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    status = fn(ctypes.cast(args, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p),
                float(eps), quant._stream(dev))
    _build.check(status, "w4_pair")


# --------------------------------------------------------------------------
# K3: one persistent launch per layer (csrc/decode_layer_sm90.cu)
# --------------------------------------------------------------------------

LAYER_TILE_N, LAYER_MAX_CHUNK = 128, 64
# the most K splits of each product (o, gate_up, down, qkv): o's and down's
# partials are summed whole by every CTA (h32 and h32b feed an RMSNorm),
# gate_up's and qkv's by one pass spread over the grid
LAYER_SPLIT_CAPS = (4, 16, 4, 16)
_LAYER_PTRS = ctypes.c_void_p * 21
_LAYER_INTS = ctypes.c_int * 40


@functools.lru_cache(maxsize=None)
def layer_plan(dout: int, ngh: int, n_cta: int, cap: int) -> Tuple[int, int]:
    """(K splits, groups of input rows per split) of one product of the
    persistent layer: its (column tile of 128, split) units are dealt
    round-robin to the n_cta CTAs (one per SM); the split count that leaves
    the busiest CTA the fewest groups, at most `cap`, ties to fewer splits
    (fewer partials to sum)."""
    tiles = dout // LAYER_TILE_N
    best = None
    for ks in range(1, min(cap, ngh) + 1):
        gps = -(-ngh // ks)
        if -(-ngh // gps) != ks:
            continue
        load = -(-tiles * ks // n_cta) * gps
        if best is None or load < best[0]:
            best = (load, ks, gps)
    return best[1], best[2]


def attn_plan(n_rows: int, hkv: int, n_cta: int) -> Tuple[int, int]:
    """(cache rows per chunk, chunks) of the persistent layer's attention:
    the live rows of each kv head spread over the CTAs, at most 64 rows a
    chunk."""
    chunk = min(LAYER_MAX_CHUNK, -(-n_rows // max(1, n_cta // hkv)))
    return chunk, -(-n_rows // chunk)


def layer_work(dims, n_cta: int):
    """Every unit of the persistent layer's four products, (din, dout) or
    (din, dout, group) each in `dims` (o, gate_up, down, qkv; the group is
    the quantizer's, `quant.group_for`, when not given), as the kernel deals
    them: (product, CTA, column tile, split, columns range, groups range)."""
    for p, dim in enumerate(dims):
        din, dout = dim[:2]
        gs = dim[2] if len(dim) > 2 else quant.group_for(din // 2)
        ngh = din // 2 // gs
        ks, gps = layer_plan(dout, ngh, n_cta, LAYER_SPLIT_CAPS[p])
        tiles = dout // LAYER_TILE_N
        for u in range(tiles * ks):  # split-major
            split, tile = divmod(u, tiles)
            yield (p, u % n_cta, tile, split,
                   (tile * LAYER_TILE_N, (tile + 1) * LAYER_TILE_N),
                   (split * gps, min(ngh, (split + 1) * gps)))


def _layer_workspace(dev: torch.device, ints) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device's persistent-layer scratch (f32, grown to what the plan
    needs, else made once) and its grid barrier's 64-bit arrival count
    (zeroed once; every launch advances it, none resets it). Launches share
    them, so they run on one stream."""
    key = tuple(ints[1:-1])
    with _state_lock:
        floats = _layer_ws_floats.get(key)
        if floats is None:
            fn = getattr(_build.load("decode_layer_sm90.cu"), "decode_layer_ws_floats")
            fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_longlong
            floats = _layer_ws_floats[key] = int(fn(ctypes.cast(ints, ctypes.c_void_p)))
        ws, bar = _layer_ws.get(dev, (None, None))
        if bar is None:
            bar = torch.zeros(2, dtype=torch.int32, device=dev)
        if ws is None or ws.numel() < floats:
            ws = torch.empty(floats, dtype=torch.float32, device=dev)
        _layer_ws[dev] = (ws, bar)
        return ws, bar


def launch_layer(q32, k_cache, v_cache, mask, h_row, l, l_next, n_rows, hkv, hd, grp,
                 slots, rows, eps, out, stamps=None) -> None:
    """Launch the persistent layer kernel on the current stream: one bs=1
    layer (h_row (1, D) bf16; the caches' layer l, live rows n_rows) into
    `out` (D + dqkv bf16: h_new, then qkv of layer l_next). `stamps`, nine
    int64 on the card, receives the %globaltimer readings at the start,
    after each of the seven grid barriers and at the end (for checks).
    Counts nothing."""
    o_slot, gu_slot, down_slot, qkv_slot = slots
    gpost, gin, bias = rows
    dev = quant.require_cuda(q32, k_cache, v_cache, mask, h_row, out, gpost, gin)
    _check_attn_dtypes(q32, k_cache, v_cache, mask)
    L, b, s_len, kv_ld = k_cache.shape
    p_rows = q32.shape[0] // hkv
    d_model = h_row.shape[-1]
    if (b != 1 or hd not in HEAD_DIMS or kv_ld != hkv * hd or not 0 < n_rows <= s_len
            or not grp <= p_rows <= 8 or q32.shape != (hkv * p_rows, hd)
            or not 0 <= l < L or h_row.numel() != d_model or mask.shape[-1] != s_len):
        raise ValueError(f"q {tuple(q32.shape)}, cache {tuple(k_cache.shape)}, rows "
                         f"{n_rows}, hd {hd}, group {grp} of {p_rows}")
    if h_row.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError("the persistent layer carries h in bf16")
    if any(t.data_ptr() % 16 for t in (h_row, gpost, gin)) or d_model % 8:
        raise ValueError("h and the norm scales must be 16-byte aligned rows, D % 8 == 0")
    n_sm, _ = quant._device_state(dev)
    chunk, nsplit = attn_plan(n_rows, hkv, n_sm)
    dims, packed, scales = [], [], []
    for p, (slot, li) in enumerate(((o_slot, l), (gu_slot, l), (down_slot, l),
                                    (qkv_slot, l_next))):
        pk, sc = slot["packed"], slot["scales"]
        quant.require_cuda(q32, pk, sc)
        quant._check_w4(pk, sc)
        half, bout, nj, ngh, gs, din, dout = quant._tiled_meta(pk, sc)
        quant.check_group(gs, "the layer kernel")
        if bout % LAYER_TILE_N:
            raise ValueError(f"the layer kernel needs bout % 128 == 0 ({bout})")
        s_rows = sc.shape[-2]
        dims += [din, dout, bout, s_rows, gs,
                 *layer_plan(dout, ngh, n_sm, LAYER_SPLIT_CAPS[p])]
        packed.append(pk.data_ptr() + li * nj * half * bout)
        scales.append(sc.data_ptr() + li * nj * s_rows * bout * 2)
    inter = dims[8] // 2
    dq = dims[22]
    if out.numel() != d_model + dq:
        raise ValueError(f"out {tuple(out.shape)} does not hold h and qkv")
    for t, n in ((gpost, d_model), (gin, d_model), (bias, dq)):
        if t is not None and (t.dtype != torch.bfloat16 or t.numel() != n):
            raise ValueError(f"layer vector {tuple(t.shape)} {t.dtype}")
    ints = _LAYER_INTS(n_rows, kv_ld, hkv, p_rows, grp, chunk, nsplit, d_model, inter,
                       n_sm, hd, *dims, quant._device_index(dev))
    ws, bar = _layer_workspace(dev, ints)
    layer_off = l * s_len * kv_ld * 2
    ptrs = _LAYER_PTRS(
        q32.data_ptr(), k_cache.data_ptr() + layer_off, v_cache.data_ptr() + layer_off,
        mask.data_ptr(), h_row.data_ptr(), gpost.data_ptr(), gin.data_ptr(),
        quant._ptr(bias), ws.data_ptr(), bar.data_ptr(), out.data_ptr(),
        out.data_ptr() + d_model * 2, quant._ptr(stamps), *packed, *scales)
    fn = quant._fn("decode_layer_sm90.cu", "decode_layer",
                   [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p])
    status = fn(ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(ints, ctypes.c_void_p),
                float(eps), quant._stream(dev))
    _build.check(status, "decode_layer")


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
    """One decoder layer (bs=1, W4; K3): returns (h_new (8, D), qkv of
    layer l+1 (8, dqkv)), row 0 real. Attention reads only the live prefix
    [0, fill] of the cache. `num_q_heads` (an addition to the JAX
    signature) names the real heads so the pad heads' outputs are zero."""
    if q32.device.type == "cpu":
        return _fused_layer_ref(
            q32, mask, h, layer_index, k_cache, v_cache,
            o_slot, gu_slot, down_slot, qkv_slot, gamma_post, gamma_in,
            hkv=hkv, hd=hd, eps=eps, fill=fill, num_q_heads=num_q_heads,
        )
    l, l_next, rows = _layer_rows(o_slot, qkv_slot, gamma_post, gamma_in, layer_index)
    (n_rows,) = _live_rows(fill, 1, k_cache.shape[2])
    _, grp = _group(q32.shape[0], hkv, num_q_heads)
    d_model, dq = h.shape[1], _dout(qkv_slot)
    out = torch.empty(d_model + dq, dtype=torch.bfloat16, device=q32.device)
    launch_layer(q32, k_cache, v_cache, mask, h[0:1], l, l_next, n_rows, hkv, hd, grp,
                 (o_slot, gu_slot, down_slot, qkv_slot), rows, eps, out)
    _build.count("fused_layer")
    return (out[:d_model].view(1, d_model).expand(8, d_model),
            out[d_model:].view(1, dq).expand(8, dq))


def fused_layer_batched(
    q32: torch.Tensor,  # (B, Hkv*8, hd) bf16: rope'd, scaled, group-padded q
    mask: torch.Tensor,  # (B, S) f32 additive
    h: torch.Tensor,  # (B, D), all rows real
    layer_index: int,
    k_cache: torch.Tensor,  # (L, B, S, Hkv*hd) flat decode cache
    v_cache: torch.Tensor,
    o_slot, gu_slot, down_slot, qkv_slot,
    gamma_post: torch.Tensor,  # (L, D)
    gamma_in: torch.Tensor,  # (L, D)
    *,
    hkv: int, hd: int, eps: float = 1e-6,
    fill=None,  # last written slot: one int or (B,) host ints; None = all S
    num_q_heads: Optional[int] = None,  # real q heads (pad heads -> zeros)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer for batched W4 decode, 1 < B <= 16 (K6): returns
    (h_new (B, D), qkv of layer l+1 (B, dqkv)). Row b attends over its own
    live prefix [0, fill[b]] (clamped to the cache: an idle slot's cursor
    may run past it); the four products run with rows = batch rows, so no
    pad rows are added (the JAX wrapper pads to 8 or 16 only to fill MXU
    rows, and the per-row digit expansion makes them inert). `fill` holds
    host values: the caller knows every cursor, and the kernel gets them
    with one copy per decode step."""
    if q32.device.type == "cpu":
        return _fused_layer_batched_ref(
            q32, mask, h, layer_index, k_cache, v_cache,
            o_slot, gu_slot, down_slot, qkv_slot, gamma_post, gamma_in,
            hkv=hkv, hd=hd, eps=eps, fill=fill, num_q_heads=num_q_heads,
        )
    b = q32.shape[0]
    if not 1 <= b <= 16 or h.shape[0] != b:
        raise ValueError(f"batched layer takes 1..16 rows, got q {b}, h {h.shape[0]}")
    l, l_next, rows = _layer_rows(o_slot, qkv_slot, gamma_post, gamma_in, layer_index)
    n_rows = _live_rows(fill, b, k_cache.shape[2])
    p_rows, grp = _group(q32.shape[1], hkv, num_q_heads)
    x_att = torch.empty((b, hkv * p_rows * hd), dtype=torch.bfloat16, device=q32.device)
    _launch_attn_batched(q32, k_cache, v_cache, mask, l, n_rows, hkv, hd, grp, x_att)
    h_new, qkv = _launch_layer_tail(
        x_att, h, l, l_next, (o_slot, gu_slot, down_slot, qkv_slot), rows, eps)
    _build.count("fused_layer_batched")
    return h_new, qkv


def fused_o_gateup(
    attn_out: torch.Tensor,  # (m <= 32, o_din) bf16
    h: torch.Tensor,  # (m, D)
    layer_index: int,
    o_slot, gu_slot,  # stacked (L, ...) W4 slots
    gamma_post: torch.Tensor,  # (L, D)
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: h32 = h + attn_out @ W_o[l]; returns (h_new = h32 rounded to h's
    dtype, gate_up = rms(h32)*g_post[l] @ W_gu[l] in bf16). The norm reads
    the unrounded f32 sum, as the TPU kernel does."""
    if attn_out.device.type == "cpu":
        return _fused_o_gateup_ref(attn_out, h, layer_index, o_slot, gu_slot,
                                   gamma_post, eps)
    l = operator.index(layer_index)
    h_new = _bf16_like(h)
    gu = torch.empty((h.shape[0], _dout(gu_slot)), dtype=torch.bfloat16, device=h.device)
    launch_pair(attn_out, h, gamma_post[l].to(torch.bfloat16), None, (o_slot, l),
                (gu_slot, l), quant.PRO_NONE, eps, h_new, gu)
    _build.count("fused_o_gateup")
    return h_new, gu


def fused_down_qkv(
    gu: torch.Tensor,  # (m <= 32, 2I) bf16
    h: torch.Tensor,  # (m, D): K4's h_new
    layer_index: int,  # the current layer l
    down_slot, qkv_slot,  # stacked W4 slots; qkv with optional "bias" (L, dqkv)
    gamma_in: torch.Tensor,  # (L, D) input_layernorm scales
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: h32 = h + (silu(g)*u) @ W_d[l]; returns (h_new = h32 rounded to
    h's dtype, qkv of layer l+1 = rms(h32)*g_in[l+1] @ W_qkv[l+1] + b). The
    last layer streams its own qkv again (clamped l+1); the caller discards
    it."""
    if gu.device.type == "cpu":
        return _fused_down_qkv_ref(gu, h, layer_index, down_slot, qkv_slot,
                                   gamma_in, eps)
    l, l_next, (_, gin, bias) = _layer_rows(
        down_slot, qkv_slot, gamma_in, gamma_in, layer_index)
    h_new = _bf16_like(h)
    qkv = torch.empty((h.shape[0], _dout(qkv_slot)), dtype=torch.bfloat16, device=h.device)
    launch_pair(gu, h, gin, bias, (down_slot, l), (qkv_slot, l_next), quant.PRO_SILU, eps,
                h_new, qkv)
    _build.count("fused_down_qkv")
    return h_new, qkv
