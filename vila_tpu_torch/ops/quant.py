"""Weight-only W4A16 quantization with grouped scales, and the W4 matmul
kernels (CUDA: `csrc/w4_gemv.cu`, `csrc/w4_gemm.cu`), as
`vila_tpu/ops/quant.py`.

Storage is the JAX package's, byte for byte, and the kernels read it as it
is (no re-layout):

  * packed `(..., NJ, din/2, bout)` uint8: byte [i, o] of block j holds
    w[i, j*bout + o] (low nibble) and w[i + din/2, j*bout + o] (high
    nibble), symmetric int4 [-8, 7] stored +8;
  * scales `(..., NJ, scale_rows(ngh), bout)` bf16, one per (group of 128
    input rows, output): lo-half groups, then hi-half groups, then zero
    rows up to a multiple of 8.

Two kernels, dispatched by the number of rows M (as `w4_matmul`):

  * M <= 32, `w4_matmul_decode` (K1, `w4_gemv.cu`): the activations are
    expanded per row into two int8 digits and contracted with s8 x s8 ->
    s32 dot products, with the lo plane's zero point corrected by a group
    row sum, exactly the TPU kernel's arithmetic;
  * M > 32, `w4_matmul_prefill` (K2, `w4_gemm.cu`): the weight tile is
    dequantised to bf16 with the TPU kernel's roundings and contracted on
    the tensor cores with f32 accumulation (== dequantize-then-matmul).

Each wrapper takes its plain PyTorch version (`_w4_gemv_ref`,
`_w4_gemm_ref`) for CPU tensors only; a CUDA tensor launches the kernel or
raises. Stacked `(L, ...)` weights are indexed by `layer_index` (a Python
int) with a pointer offset: no per-layer copy.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Any, Dict, Optional

import torch

from vila_tpu_torch.ops import _build

DEFAULT_GROUP = 128
# pick_bout's block budget: the JAX package's, so quantize_w4 chooses the
# same bout and produces the same bytes.
_BLOCK_BUDGET = (26 << 20) // 10

PRO_NONE, PRO_RMS, PRO_SILU = 0, 1, 2
GEMV_TILE_N = 128
_COUNTER_SLOTS = 1 << 16


def pick_bout(din: int, dout: int, budget: int = _BLOCK_BUDGET) -> int:
    """Largest 128-multiple divisor of dout with half*bout <= budget, else
    dout itself (small/test models); as `vila_tpu.ops.quant.pick_bout`."""
    half = din // 2
    best = 0
    b = 128
    while b <= dout:
        if dout % b == 0 and half * b <= budget:
            best = b
        b += 128
    if best == 0:
        assert half * dout <= budget, (din, dout)
        best = dout
    return best


def scale_rows(ngh: int) -> int:
    """Scale rows per block: 2*ngh (lo + hi groups) padded to a multiple of 8."""
    return ((2 * ngh + 7) // 8) * 8


def quantize_w4(
    w: torch.Tensor, group_size: int = DEFAULT_GROUP, bout: Optional[int] = None
) -> Dict[str, Any]:
    """w (..., din, dout) -> tiled {packed (..., NJ, din/2, bout) uint8,
    scales (..., NJ, scale_rows(ngh), bout) bf16}: the same bytes as
    `vila_tpu.ops.quant.quantize_w4`."""
    *lead, din, dout = w.shape
    half = din // 2
    assert din % (2 * group_size) == 0, (din, group_size)
    bout = bout or pick_bout(din, dout)
    assert dout % bout == 0, (dout, bout)
    nj = dout // bout

    g = w.float().reshape(*lead, din // group_size, group_size, dout)
    amax = g.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(amax / 7.0, min=1e-8)
    q = torch.clamp(torch.round(g / scale), -8, 7).to(torch.int8)
    q = q.reshape(*lead, din, dout)
    lo = (q[..., :half, :] + 8).to(torch.uint8)
    hi = (q[..., half:, :] + 8).to(torch.uint8)
    packed = lo | (hi << 4)

    nl = len(lead)
    perm = tuple(range(nl)) + (nl + 1, nl, nl + 2)
    packed_t = packed.reshape(*lead, half, nj, bout).permute(perm).contiguous()
    scales = scale[..., 0, :].reshape(*lead, din // group_size, dout)
    scales_t = (
        scales.reshape(*lead, din // group_size, nj, bout)
        .permute(perm)
        .to(torch.bfloat16)
    )
    rows = din // group_size
    s_rows = scale_rows(rows // 2)
    if s_rows != rows:
        scales_t = torch.nn.functional.pad(scales_t, (0, 0, 0, s_rows - rows))
    return {
        "packed": packed_t,
        "scales": scales_t.contiguous(),
        "group_size": group_size,
        "bout": bout,
        "bits": 4,
    }


def pad_o_heads(
    w: torch.Tensor, num_q_heads: int, num_kv_heads: int, head_dim: int
) -> torch.Tensor:
    """Repack o_proj rows into GQA-group-padded order: query group g's G
    heads occupy rows [g*P*hd, g*P*hd + G*hd), P = ceil8(G), zero rows pad."""
    grp = num_q_heads // num_kv_heads
    p = ((grp + 7) // 8) * 8
    if p == grp:
        return w
    *lead, din, dout = w.shape
    assert din == num_q_heads * head_dim, (din, num_q_heads, head_dim)
    w4 = w.reshape(*lead, num_kv_heads, grp, head_dim, dout)
    pad = w.new_zeros(tuple(lead) + (num_kv_heads, p - grp, head_dim, dout))
    return torch.cat([w4, pad], dim=-3).reshape(
        *lead, num_kv_heads * p * head_dim, dout
    )


def _tiled_meta(packed: torch.Tensor, scales: torch.Tensor):
    """(half, bout, nj, ngh, group_size, din, dout) from the tiled shapes."""
    *_, nj, half, bout = packed.shape
    rows = scales.shape[-2]
    for gs in (DEFAULT_GROUP, 64, 256, 32, 16, 512):
        if half % gs:
            continue
        ngh = half // gs
        if rows in (2 * ngh, scale_rows(ngh)):
            return half, bout, nj, ngh, gs, 2 * half, nj * bout
    raise ValueError(
        f"cannot infer group size from packed {tuple(packed.shape)} / "
        f"scales {tuple(scales.shape)}"
    )


def _untile(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., nj, rows', bout) -> (..., rows, nj*bout), first `rows` rows."""
    *lead, nj, _, bout = t.shape
    nl = len(lead)
    perm = tuple(range(nl)) + (nl + 1, nl, nl + 2)
    return t[..., :rows, :].permute(perm).reshape(*lead, rows, nj * bout)


def dequantize(qdict: Dict[str, Any]) -> torch.Tensor:
    """Tiled W4 slot back to flat (..., din, dout) bf16."""
    if qdict.get("bits", 4) != 4:
        raise NotImplementedError("only W4 slots are ported")
    packed, scales = qdict["packed"], qdict["scales"]
    half, bout, nj, ngh, g, din, dout = _tiled_meta(packed, scales)
    lead = packed.shape[:-3]
    flat_p = _untile(packed, half)
    flat_s = _untile(scales, 2 * ngh).float()
    lo = (flat_p & 0xF).to(torch.int32) - 8
    hi = (flat_p >> 4).to(torch.int32) - 8
    q = torch.cat([lo, hi], dim=-2)
    qg = q.reshape(*lead, din // g, g, dout).float()
    w = qg * flat_s[..., :, None, :]
    return w.reshape(*lead, din, dout).to(torch.bfloat16)


def _layer(packed, scales, layer_index):
    if packed.ndim == 4:
        if layer_index is None:
            raise ValueError("stacked W4 weights need a layer_index")
        l = operator.index(layer_index)
        return packed[l], scales[l], l
    return packed, scales, 0


# --------------------------------------------------------------------------
# Plain versions (CPU path; the card's kernels are held against them)
# --------------------------------------------------------------------------


def _digits(x32: torch.Tensor):
    """Per-row two-digit int8 expansion x ~= q1*s1 + q2*s2 (values as f32)."""
    a = x32.abs().amax(dim=1, keepdim=True)
    s1 = torch.clamp(a / 127.0, min=1e-20)
    q1 = torch.clamp(torch.round(x32 / s1), -127, 127)
    r = x32 - q1 * s1
    s2 = s1 / 127.0
    q2 = torch.clamp(torch.round(r / s2), -127, 127)
    return [(q1, s1), (q2, s2)]


def _w4_gemv_ref(x, packed, scales, layer_index=None, out_f32=False):
    """Plain version of the K1 kernel: int8-digit activations against the
    lo / h16 nibble planes, exact integer dots, f32 scaling. `out_f32`
    returns the f32 sum unrounded, as the fused layer's epilogues use it."""
    packed, scales, _ = _layer(packed, scales, layer_index)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    m = x.shape[0]
    p = _untile(packed, half)
    # f32 is exact here: each group's integer dot stays below 2**24
    lo = (p & 0x0F).float()
    h16 = ((p & 0xF0) ^ 0x80).view(torch.int8).float()
    s = _untile(scales, 2 * ngh).float()
    s_lo, s_hi = s[:ngh], s[ngh:] / 16.0
    x32 = x.float()
    acc = torch.zeros((m, dout), dtype=torch.float32, device=x.device)
    planes = ((x32[:, :half], lo, s_lo, True), (x32[:, half:], h16, s_hi, False))
    for xp, w, sc, zero_fix in planes:
        wg = w.reshape(ngh, gs, dout)
        for q, sx in _digits(xp):
            qg = q.reshape(m, ngh, gs)
            d = torch.einsum("mgk,gkn->mgn", qg, wg)
            if zero_fix:
                d = d - 8.0 * qg.sum(-1, keepdim=True)
            acc = acc + (d * (sx[:, :, None] * sc[None])).sum(1)
    return acc if out_f32 else acc.to(x.dtype)


def _w4_gemm_ref(x, packed, scales, layer_index=None):
    """Plain version of the K2 kernel: dequantize (the prefill kernel's
    bf16 roundings) then an f32 matmul."""
    packed, scales, _ = _layer(packed, scales, layer_index)
    w = dequantize({"packed": packed, "scales": scales})
    return (x.float() @ w.float()).to(x.dtype)


# --------------------------------------------------------------------------
# CUDA launch plumbing
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMV_ARGTYPES = [
    _P, _I, _I, _I, _P, ctypes.c_float, _P, _P,
    _I, _I, _I, _I, _I, _I, _I, _I,
    _P, _P, _P, _P, _P, _P, _P, _P,
]
_GEMM_ARGTYPES = [_P] * 6 + [_I] * 9 + [_P]
_counters: Dict[int, torch.Tensor] = {}
_sm_count: Dict[int, int] = {}


def _fn(src: str, name: str, argtypes):
    fn = getattr(_build.load(src), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(*tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device (with CUDA present), contiguous."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA tensor given but CUDA is not available")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    return dev


def _check_w4(packed, scales):
    if packed.dtype != torch.uint8 or scales.dtype != torch.bfloat16:
        raise TypeError(f"W4 slot must be uint8/bf16, got {packed.dtype}/{scales.dtype}")


def launch_gemv(x, packed, scales, layer_index, *, m, prologue=PRO_NONE,
                gamma=None, eps=0.0, res_f32=None, res_bf16=None, bias=None,
                out_f32=None, out_bf16=None) -> None:
    """Launch the W4 GEMV kernel (any prologue/epilogue variant) on the
    current stream. `x` holds m rows: (m, din) or, for the SiLU prologue,
    (m, 2*din) gate|up. Counts nothing: the public wrappers count."""
    dev = require_cuda(x, packed, scales)
    _check_w4(packed, scales)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    s_rows = scales.shape[-2]
    ldx = 2 * din if prologue == PRO_SILU else din
    if x.numel() != m * ldx or not 1 <= m <= 32:
        raise ValueError(f"x {tuple(x.shape)} does not hold {m} rows of {ldx}")
    x_f32 = x.dtype == torch.float32
    if x.dtype not in (torch.bfloat16, torch.float32) or (
        x_f32 and prologue != PRO_RMS
    ):
        raise TypeError(f"unsupported input dtype {x.dtype} for prologue {prologue}")
    if gs % 32 or bout % 4:
        raise ValueError(f"kernel needs group % 32 == 0 and bout % 4 == 0 ({gs}, {bout})")
    for t, dt in ((gamma, torch.bfloat16), (bias, torch.bfloat16),
                  (res_f32, torch.float32), (res_bf16, torch.bfloat16),
                  (out_f32, torch.float32), (out_bf16, torch.bfloat16)):
        if t is not None:
            require_cuda(x, t)
            if t.dtype != dt:
                raise TypeError(f"expected {dt}, got {t.dtype}")
    if prologue == PRO_RMS and (gamma is None or gamma.numel() != din):
        raise ValueError("RMS prologue needs a (din,) gamma")
    _, _, l = _layer(packed, scales, layer_index)
    p_off = l * nj * half * bout
    s_off = l * nj * s_rows * bout * 2

    n_sm, counters = _device_state(dev)
    nr = 1 if m == 1 else 4
    tiles = -(-dout // GEMV_TILE_N) * -(-m // nr)
    target = max(1, -(-2 * n_sm // tiles))
    gps = min(32, -(-ngh // target))
    ksplit = -(-ngh // gps)
    if tiles > _COUNTER_SLOTS:
        raise ValueError(f"{tiles} column tiles exceed the counter buffer")
    ws = None
    if ksplit > 1:
        ws = torch.empty((ksplit, m, dout), dtype=torch.float32, device=dev)
    status = _fn("w4_gemv.cu", "w4_gemv", _GEMV_ARGTYPES)(
        x.data_ptr(), int(x_f32), ldx, prologue, _ptr(gamma), float(eps),
        packed.data_ptr() + p_off, scales.data_ptr() + s_off,
        m, din, dout, bout, s_rows, gs, ksplit, gps,
        _ptr(ws), counters.data_ptr(), _ptr(res_f32), _ptr(res_bf16),
        _ptr(bias), _ptr(out_f32), _ptr(out_bf16), _stream(dev),
    )
    _build.check(status, "w4_gemv")


def _device_state(dev: torch.device):
    """(SM count, zeroed arrival counters) of a device, made once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        _counters[idx] = torch.zeros(_COUNTER_SLOTS, dtype=torch.int32, device=dev)
    return _sm_count[idx], _counters[idx]


def gemm_plan(m: int, dout: int, half: int, n_sm: int):
    """(rows per tile, K splits, k tiles per split) for the GEMM kernel:
    128-row tiles where they give two tiles per SM, else 64-row tiles; K is
    split while the blocks are fewer than two per SM and each split keeps
    at least 8 k tiles of 32."""
    tiles_n, nk = dout // 128, half // 32
    bm = 128 if tiles_n * -(-m // 128) >= 2 * n_sm else 64
    tiles = tiles_n * -(-m // bm)
    ksplit = 1
    while tiles * ksplit < 2 * n_sm and nk // (2 * ksplit) >= 8:
        ksplit *= 2
    kps = -(-nk // ksplit)
    return bm, -(-nk // kps), kps


def launch_gemm(x, packed, scales, layer_index, out) -> None:
    """Launch the W4 GEMM kernel on the current stream (counts nothing)."""
    dev = require_cuda(x, packed, scales, out)
    _check_w4(packed, scales)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError("w4 GEMM takes and returns bf16")
    if x.shape != (m, din) or out.shape != (m, dout):
        raise ValueError(f"x {tuple(x.shape)} / out {tuple(out.shape)} vs ({din}, {dout})")
    if bout % 128 or half % 32 or gs % 32:
        raise ValueError(f"kernel needs bout % 128 == 0, group % 32 == 0 ({bout}, {gs})")
    _, _, l = _layer(packed, scales, layer_index)
    s_rows = scales.shape[-2]
    n_sm, counters = _device_state(dev)
    bm, ksplit, kps = gemm_plan(m, dout, half, n_sm)
    if (dout // 128) * -(-m // bm) > _COUNTER_SLOTS:
        raise ValueError(f"{m} x {dout} output exceeds the counter buffer")
    ws = None
    if ksplit > 1:
        ws = torch.empty((ksplit, m, dout), dtype=torch.float32, device=dev)
    status = _fn("w4_gemm.cu", "w4_gemm", _GEMM_ARGTYPES)(
        x.data_ptr(), packed.data_ptr() + l * nj * half * bout,
        scales.data_ptr() + l * nj * s_rows * bout * 2, out.data_ptr(),
        _ptr(ws), counters.data_ptr(), m, din, dout, bout, s_rows, gs,
        bm, ksplit, kps, _stream(dev),
    )
    _build.check(status, "w4_gemm")


# --------------------------------------------------------------------------
# Public matmuls
# --------------------------------------------------------------------------


def w4_matmul_decode(
    x: torch.Tensor,  # (M<=32, din) bf16
    packed: torch.Tensor,  # (nj, din/2, bout) uint8 or (L, nj, ...) stacked
    scales: torch.Tensor,  # (nj, s_rows, bout) bf16 or (L, nj, ...) stacked
    act_digits: int = 2,
    layer_index: Optional[int] = None,
) -> torch.Tensor:
    """Decode-shaped W4 matmul (K1). Only the two-digit activation
    expansion (the JAX default) is implemented."""
    if act_digits != 2:
        raise NotImplementedError("only act_digits=2 is ported")
    if x.device.type == "cpu":
        return _w4_gemv_ref(x, packed, scales, layer_index)
    _, _, _, _, _, _, dout = _tiled_meta(packed, scales)
    if x.dtype != torch.bfloat16:
        raise TypeError("w4_matmul_decode takes bf16 activations")
    out = torch.empty((x.shape[0], dout), dtype=torch.bfloat16, device=x.device)
    launch_gemv(x, packed, scales, layer_index, m=x.shape[0], out_bf16=out)
    _build.LAUNCHES["w4_gemv"] += 1
    return out


def w4_matmul_prefill(
    x: torch.Tensor,  # (M, din) bf16
    packed: torch.Tensor,
    scales: torch.Tensor,
    layer_index: Optional[int] = None,
) -> torch.Tensor:
    """Prefill-shaped W4 matmul (K2). The TPU-only tiling arguments of the
    JAX signature (`block_m`, `scale_planes`) have no counterpart here."""
    if x.device.type == "cpu":
        return _w4_gemm_ref(x, packed, scales, layer_index)
    _, _, _, _, _, _, dout = _tiled_meta(packed, scales)
    out = torch.empty((x.shape[0], dout), dtype=torch.bfloat16, device=x.device)
    launch_gemm(x, packed, scales, layer_index, out)
    _build.LAUNCHES["w4_gemm"] += 1
    return out


def w4_matmul(x, packed, scales, act_digits: int = 2, layer_index=None):
    """Dispatch by M: decode kernel for M <= 32, prefill kernel otherwise."""
    if x.shape[0] <= 32:
        return w4_matmul_decode(x, packed, scales, act_digits, layer_index)
    return w4_matmul_prefill(x, packed, scales, layer_index)


def quantized_linear(x, p: Dict[str, Any], dtype, act_digits: int = 2):
    """Linear layer over a W4 slot {packed, scales[, bias]} of one layer."""
    if p["packed"].dtype != torch.uint8:
        raise NotImplementedError("only W4 slots are ported")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = w4_matmul(x2.to(torch.bfloat16), p["packed"], p["scales"], act_digits).to(dtype)
    y = y.reshape(*lead, y.shape[-1])
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def quantize_llm_params(
    llm_params: Dict[str, Any],
    bits: int = 4,
    group_size: int = DEFAULT_GROUP,
    fuse: bool = True,
    cfg=None,  # optional qwen2.LLMConfig: enables the GQA-padded o layout
) -> Dict[str, Any]:
    """Quantize a qwen2 param tree to W4A16 slots, as
    `vila_tpu.ops.quant.quantize_llm_params` (same bytes). With `fuse`,
    q/k/v and gate/up merge into qkv_proj and gate_up_proj."""
    assert bits == 4, "W4 decode path"
    out = {"embed_tokens": llm_params["embed_tokens"], "norm": llm_params["norm"]}
    src = llm_params["layers"]
    layers: Dict[str, Any] = {
        "input_layernorm": src["input_layernorm"],
        "post_attention_layernorm": src["post_attention_layernorm"],
    }

    def group_for(din):
        half = din // 2
        g = group_size
        while half % g != 0:
            g -= 1
        return g

    def qslot(kernel, bias=None, bout_budget=None):
        bout = None
        if bout_budget is not None:
            bout = pick_bout(kernel.shape[-2], kernel.shape[-1], budget=bout_budget)
        q = quantize_w4(kernel, group_for(kernel.shape[-2]), bout=bout)
        slot = {"packed": q["packed"], "scales": q["scales"]}
        if bias is not None:
            slot["bias"] = bias
        return slot

    if fuse:
        qkv_k = torch.cat(
            [src[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")], dim=-1
        )
        qkv_b = None
        if "bias" in src["q_proj"]:
            qkv_b = torch.cat(
                [src[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")], dim=-1
            )
        layers["qkv_proj"] = qslot(qkv_k, qkv_b)
        gu_k = torch.cat(
            [src["gate_proj"]["kernel"], src["up_proj"]["kernel"]], dim=-1
        )
        layers["gate_up_proj"] = qslot(gu_k)
        o_kernel = src["o_proj"]["kernel"]
        if cfg is not None:
            o_kernel = pad_o_heads(
                o_kernel, cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim_,
            )
        layers["o_proj"] = qslot(o_kernel, src["o_proj"].get("bias"))
        layers["down_proj"] = qslot(
            src["down_proj"]["kernel"], src["down_proj"].get("bias"),
            bout_budget=5 << 20,
        )
    else:
        for name in ("q_proj", "k_proj", "v_proj", "o_proj",
                     "gate_proj", "up_proj", "down_proj"):
            slot = src[name]
            layers[name] = qslot(slot["kernel"], slot.get("bias"))

    for slot in layers.values():
        if isinstance(slot, dict) and slot.get("bias") is None:
            slot.pop("bias", None)

    out["layers"] = layers
    if "lm_head" in llm_params:
        kernel = llm_params["lm_head"]["kernel"]
        q = quantize_w4(kernel, group_for(kernel.shape[-2]))
        out["lm_head"] = {"packed": q["packed"], "scales": q["scales"]}
    return out
