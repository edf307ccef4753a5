"""Weight-only W4A16 quantization with grouped scales, and the W4 matmul
kernels (CUDA: `csrc/w4_gemv_sm90.cu`, `csrc/w4_gemm_sm90.cu`), as
`vila_tpu/ops/quant.py`.

Storage is the JAX package's, byte for byte, and the kernels read it as it
is (no re-layout):

  * packed `(..., NJ, din/2, bout)` uint8: byte [i, o] of block j holds
    w[i, j*bout + o] (low nibble) and w[i + din/2, j*bout + o] (high
    nibble), symmetric int4 [-8, 7] stored +8;
  * scales `(..., NJ, scale_rows(ngh), bout)` bf16, one per (group of input
    rows, output): lo-half groups, then hi-half groups, then zero rows up to
    a multiple of 8. A group is 128 rows, or the largest size below that
    divides din/2 (`group_for`: 112 at D = 896); the kernels take groups
    that are multiples of 16 up to 128.

Two kernels, dispatched by the number of rows M (as `w4_matmul`):

  * M <= 32, `w4_matmul_decode` (K1, `w4_gemv_sm90.cu`): the activations
    are expanded per row into two int8 digits and contracted with s8 x s8
    -> s32 dot products, with the lo plane's zero point corrected by a
    group row sum, exactly the TPU kernel's arithmetic (groups that are
    multiples of 16: 128, or 112 where the quantizer takes it,
    `group_for`). Two forms, picked by `k1_form`: M = 1 streams the weights
    through a ring of TMA boxes into dp4a on the CUDA cores; M >= 2 is one
    persistent launch that reads every weight byte once for all rows on
    the int8 tensor cores (wgmma), over digits written once into a
    workspace in `_w4_digits_ref`'s layout;
  * M > 32, `w4_matmul_prefill` (K2, `w4_gemm_sm90.cu`): the weight tile
    is dequantised to bf16 with the TPU kernel's roundings, by warps of its
    own while the previous tile's wgmma products run, and contracted on the
    tensor cores with f32 accumulation (== dequantize-then-matmul).

The batched decode layer (K6) runs its four products on a third kernel
pair, `csrc/w4_gemv_mma.cu` (`launch_gemv_rows`): `w4_digits` expands the M
rows once per product, `w4_gemv_rows` streams the weights once for all rows
through the int8 tensor cores (`mma.sync` m16n8k32), summing whole groups in
int32 before the f32 scale (plain versions `_w4_digits_ref`,
`_w4_gemv_rows_ref`, together `_w4_rows_ref`). The tensor-core kernels (K1's
wgmma form, K3, K4/K5, K6) keep each group's digits padded with zeros to a
multiple of 32 rows, the mma k step (`padded_group`).

Each wrapper takes its plain PyTorch version (`_w4_gemv_ref`,
`_w4_gemm_ref`) for CPU tensors only; a CUDA tensor launches the kernel or
raises. Stacked `(L, ...)` weights are indexed by `layer_index` (a Python
int) with a pointer offset: no per-layer copy.
"""

from __future__ import annotations

import ctypes
import functools
import operator
import threading
from typing import Any, Dict, Optional

import torch

from vila_tpu_torch.ops import _build

DEFAULT_GROUP = 128
# pick_bout's block budget: the JAX package's, so quantize_w4 chooses the
# same bout and produces the same bytes.
_BLOCK_BUDGET = (26 << 20) // 10

PRO_NONE, PRO_RMS, PRO_SILU = 0, 1, 2
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


def group_for(half: int, group_size: int = DEFAULT_GROUP) -> int:
    """The quantizer's group: the largest size <= group_size that divides
    the half-contraction (`quantize_llm_params`; 112 at D = 896)."""
    g = group_size
    while half % g != 0:
        g -= 1
    return g


def _tiled_meta(packed: torch.Tensor, scales: torch.Tensor):
    """(half, bout, nj, ngh, group_size, din, dout) from the tiled shapes:
    the JAX package's candidate sizes first, then the quantizer's own rule
    (`group_for`), which the candidates miss at D = 896 (group 112)."""
    *_, nj, half, bout = packed.shape
    rows = scales.shape[-2]
    for gs in (DEFAULT_GROUP, 64, 256, 32, 16, 512, group_for(half)):
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


def _mma_order(x: torch.Tensor) -> torch.Tensor:
    """(..., n) with n % 32 == 0 -> the same values in w4_gemv_rows' k
    order: inside each 32-block, position kappa holds element
    rho(kappa) = 8 (kappa % 4) + 2 ((kappa % 16) // 4) + kappa // 16."""
    return x.reshape(*x.shape[:-1], -1, 32)[..., _RHO].reshape(x.shape)


def _plain_order(x: torch.Tensor) -> torch.Tensor:
    """The inverse of `_mma_order`."""
    return x.reshape(*x.shape[:-1], -1, 32)[..., _KAPPA].reshape(x.shape)


_RHO = torch.tensor([8 * (k % 4) + 2 * ((k % 16) // 4) + k // 16 for k in range(32)])
_KAPPA = torch.argsort(_RHO)


def _prologue_ref(x, prologue, gamma=None, eps=0.0):
    """The W4 GEMV prologue value of each row as f32 (bf16-exact): x as it
    is, RMSNorm(x) * gamma, or SiLU(gate) * up of a (gate | up) row. The
    definition the kernels share (`csrc/w4_common.cuh`): the row's sum of
    squares, the square root, the reciprocal and exp in f64, rounded once
    to f32 (so the sum order does not show), the products in f32."""
    x32 = x.float()
    if prologue == PRO_RMS:
        ss = x32.double().square().sum(-1, keepdim=True)
        eps64 = float(torch.tensor(eps, dtype=torch.float32))  # the kernels' f32 eps
        rms = (1.0 / torch.sqrt(ss / x32.shape[-1] + eps64)).float()
        x32 = (x32 * rms) * gamma.float()
    elif prologue == PRO_SILU:
        inter = x32.shape[1] // 2
        g = x32[:, :inter]
        sig = (1.0 / (1.0 + torch.exp(-g.double()))).float()
        x32 = (g * sig) * x32[:, inter:]
    return x32.to(torch.bfloat16).float()


def padded_group(group: int) -> int:
    """A group's length in the int8-digit buffers of the tensor-core kernels
    (K3, K6, K4/K5): the next multiple of 32, the mma k step. The digits
    past the group's end are zeros, so the weight rows a padded step reads
    past the group (the next group's first rows, or zeros past the slab)
    add nothing, and the lo plane's group sums are unchanged."""
    return 32 * -(-group // 32)


def check_group(group: int, name: str) -> None:
    """The groups the tensor-core and GEMV kernels take: multiples of 16 up
    to 128 (128, 112 and 64 among them)."""
    if group % 16 or not 16 <= group <= 128:
        raise ValueError(f"{name} takes W4 groups that are multiples of 16 up to 128, "
                         f"got {group}")


def _w4_digits_ref(x, prologue=PRO_NONE, gamma=None, eps=0.0, m_pad=None, group=128):
    """Plain version of the `w4_digits` kernel: (digits (2 planes, 2
    digits, m_pad, ngh * gp) int8, each group padded with zeros to gp =
    `padded_group(group)` and in w4_gemv_rows' k order, dscale (m_pad, 2, 2)
    f32 = (s1, s2) per plane, gsum (ngh, 2 digits, m_pad) int32 = the lo
    plane's per-group digit sums); rows past x's are zeros. The digits and
    scales are `_digits`' per half-plane."""
    v = _prologue_ref(x, prologue, gamma, eps)
    m, din = v.shape
    half = din // 2
    ngh, gp = half // group, padded_group(group)
    m_pad = m_pad or 8 * -(-m // 8)
    digits = torch.zeros((2, 2, m_pad, ngh, gp), dtype=torch.int8, device=x.device)
    dscale = torch.zeros((m_pad, 2, 2), dtype=torch.float32, device=x.device)
    for p in range(2):
        for d, (q, sx) in enumerate(_digits(v[:, p * half:(p + 1) * half])):
            digits[p, d, :m, :, :group] = q.to(torch.int8).reshape(m, ngh, group)
            dscale[:m, p, d] = sx[:, 0]
    gsum = digits[0].int().sum(-1)  # (2, m_pad, ngh)
    digits = _mma_order(digits.reshape(2, 2, m_pad, ngh * gp))
    return digits, dscale, gsum.permute(2, 0, 1).contiguous()


def _unpad_digits(digits, group):
    """(..., ngh * gp) padded digits in the kernels' k order -> (..., ngh *
    group) in input order."""
    gp = padded_group(group)
    d = _plain_order(digits)
    return d.reshape(*d.shape[:-1], -1, gp)[..., :group].reshape(*d.shape[:-1], -1)


def _w4_gemv_rows_ref(digits, dscale, gsum, packed, scales, layer_index=None, m=None):
    """Plain version of the `w4_gemv_rows` kernel: (m, dout) f32. Each
    group's integer dot is summed whole (exact: below 2**21), the lo plane
    corrected by its digit sum, then scaled in f32 per (row, group,
    column)."""
    packed, scales, _ = _layer(packed, scales, layer_index)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    m = digits.shape[2] if m is None else m
    p = _untile(packed, half)
    lo = (p & 0x0F).double().reshape(ngh, gs, dout)
    h16 = ((p & 0xF0) ^ 0x80).view(torch.int8).double().reshape(ngh, gs, dout)
    s = _untile(scales, 2 * ngh).float()
    s_lo, s_hi = s[:ngh], s[ngh:] / 16.0
    q = _unpad_digits(digits[:, :, :m].double(), gs).reshape(2, 2, m, ngh, gs)
    acc = torch.zeros((m, dout), dtype=torch.float32, device=digits.device)
    # the terms in `_w4_gemv_ref`'s order (lo plane's digits, then the hi's),
    # so that the two plain versions agree bit for bit
    for p, (w, sc) in enumerate(((lo, s_lo), (h16, s_hi))):
        for d in range(2):
            dots = torch.einsum("mgk,gkn->mgn", q[p, d], w)
            if p == 0:
                dots = dots - 8.0 * gsum[:, d, :m].T[:, :, None]
            acc = acc + (dots.float() * (dscale[:m, p, d, None, None] * sc[None])).sum(1)
    return acc


def _w4_rows_ref(x, packed, scales, layer_index=None, prologue=PRO_NONE, gamma=None,
                 eps=0.0):
    """The digit pass and the rows GEMV in plain PyTorch: (m, dout) f32."""
    gs = _tiled_meta(packed, scales)[4]
    digits, dscale, gsum = _w4_digits_ref(x, prologue, gamma, eps, group=gs)
    return _w4_gemv_rows_ref(digits, dscale, gsum, packed, scales, layer_index,
                             m=x.shape[0])


ROWS_TILE_N = 128


@functools.lru_cache(maxsize=None)
def rows_plan(dout: int, ngh: int, n_sm: int):
    """(column tiles, K splits, groups per split) of `w4_gemv_rows`: 128
    output columns per CTA and the fewest splits of the ngh groups of input
    rows (of any size the kernel takes) that give the grid one CTA per SM. Fewer, longer CTAs win on the
    H100: each CTA's start (barriers, the first loads) and each split's
    partial cost more than a second resident CTA per SM gains."""
    tiles = dout // ROWS_TILE_N
    ksplit = min(ngh, -(-n_sm // tiles))
    while True:
        gps = -(-ngh // ksplit)  # balanced runs
        if tiles * -(-ngh // gps) >= n_sm or gps == 1:
            return tiles, -(-ngh // gps), gps
        ksplit += 1


def rows_work(dout: int, bout: int, ngh: int, n_sm: int):
    """Every CTA of `w4_gemv_rows`' grid with the work its indices give it,
    as the kernel computes them: (tile, split, columns range, bout block,
    groups range)."""
    tiles, ksplit, gps = rows_plan(dout, ngh, n_sm)
    for x in range(tiles):
        n0 = x * ROWS_TILE_N
        for y in range(ksplit):
            yield (x, y, (n0, n0 + ROWS_TILE_N), n0 // bout,
                   (y * gps, min(ngh, (y + 1) * gps)))


# --------------------------------------------------------------------------
# CUDA launch plumbing
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_GEMM_ARGTYPES = [_P] * 6 + [_I] * 13 + [_P]
_DIGITS_ARGTYPES = [_P, _I, _I, _I, _P, ctypes.c_float, _I, _I, _I, _I, _P, _P, _P, _P, _P]
_ROWS_ARGTYPES = [_P] * 5 + [_I] * 9 + [_P] * 8
_counters: Dict[int, torch.Tensor] = {}
_gemm_counters: Dict[int, torch.Tensor] = {}
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


def k1_form(m: int, din: int) -> str:
    """The form of K1 (`csrc/w4_gemv_sm90.cu`) for m rows of din inputs:
    "stream" (dp4a on the CUDA cores, a ring of TMA boxes; one row's work
    is bytes, and the tensor cores would waste 7 of every 8 columns of N)
    for m = 1 where its consumers can hold the row in registers (din <=
    K1_STREAM_MAX_DIN), "wgmma" (one persistent launch, every weight byte
    read once for all rows on the tensor cores) otherwise; at m = 2 the
    wgmma form read faster on the H100 (PERF.md). Decided here only: no
    form gives way to another at run time."""
    return "stream" if m == 1 and din <= K1_STREAM_MAX_DIN else "wgmma"


# the stream form's TMA box width in bytes: the probe (`launch_probe`) read
# the lm_head slab faster in 128-byte boxes than in 256-byte ones on the
# H100 (PERF.md)
K1_BOX = 128
K1_STREAM_MAX_DIN = 20480  # the stream form's consumers hold a row of 8 x 256 x 10 inputs
K1_SPLIT_CAP = 16


@functools.lru_cache(maxsize=None)
def unit_plan(dout: int, ngh: int, n_cta: int, cap: int = K1_SPLIT_CAP):
    """(whole tiles, K splits, groups per split) of one product of a
    persistent W4 launch (K1's wgmma form, K4/K5): column tiles of 128 [0,
    whole) are units of their own; each of the other tiles is cut into
    `splits` runs of `groups per split` groups, dealt split-major after
    them; the units go round-robin to the n_cta CTAs (one per SM). `whole`
    is 0 or the tiles of every full wave of CTAs. The plan leaves the
    busiest CTA the fewest groups; ties go to fewer partial sums, then
    fewer splits (each split is a partial to write and sum)."""
    tiles = dout // ROWS_TILE_N
    best = None
    for whole in sorted({0, tiles // n_cta * n_cta}):
        rest = tiles - whole
        for ks in (range(1, min(cap, ngh) + 1) if rest else (1,)):
            gps = -(-ngh // ks)
            ks = -(-ngh // gps)
            load = [0] * n_cta
            for u in range(whole):
                load[u % n_cta] += ngh
            for v in range(rest * ks):
                z = v // rest
                load[(whole + v) % n_cta] += min(ngh, (z + 1) * gps) - z * gps
            key = (max(load), rest * ks if ks > 1 else 0, ks)
            if best is None or key < best[0]:
                best = (key, (whole, ks, gps))
    return best[1]


def _spans(dout: int, bout: int, box: int):
    """The stream form's column spans, as the kernel numbers them: (bout
    block, first column in it, columns) of every whole `box`-wide span,
    block by block, then the narrower last span of each block where box
    does not divide bout (dealt last, so that round-robin evens the CTAs'
    loads)."""
    nfs, nj = bout // box, dout // bout
    whole = [(jb, k * box, box) for jb in range(nj) for k in range(nfs)]
    return whole + ([(jb, nfs * box, bout - nfs * box) for jb in range(nj)]
                    if bout % box else [])


# what a unit of the stream form costs besides its boxes (its K range's
# digits, a split's partial and its last CTA's sum), in bytes of the weight
# stream (~3 us at one SM's share of the HBM rate): on the H100, gate_up and
# qkv at M = 1 read faster in 1 and 3 splits than in the 2 and 7 a smaller
# cost picks
K1_UNIT_BYTES = 64 << 10


@functools.lru_cache(maxsize=None)
def stream_plan(dout: int, bout: int, ngh: int, n_sm: int, group: int = 128,
                box: int = K1_BOX):
    """(K splits, groups per split, CTAs) of K1's stream form: each column
    span (`_spans`) is cut into `splits` runs of `groups per split` groups;
    the (span, split) units, split-major, go round-robin to min(units, n_sm)
    persistent CTAs. The plan leaves the busiest CTA the fewest bytes: its
    weight boxes' columns, a unit's fixed cost (`K1_UNIT_BYTES`) and, when
    split, its partial written and read (8 bytes a column); ties go to fewer
    splits."""
    widths = [w for _, _, w in _spans(dout, bout, box)]
    best = None
    for ks in range(1, min(K1_SPLIT_CAP, ngh) + 1):
        gps = -(-ngh // ks)
        ks = -(-ngh // gps)
        n_units = len(widths) * ks
        n_cta = min(n_units, n_sm)
        load = [0] * n_cta
        for u in range(n_units):
            z, sp = divmod(u, len(widths))
            groups = min(ngh, (z + 1) * gps) - z * gps
            load[u % n_cta] += (widths[sp] * (groups * group + (8 if ks > 1 else 0))
                                + K1_UNIT_BYTES)
        key = (max(load), ks)
        if best is None or key < best[0]:
            best = (key, (ks, gps, n_cta))
    return best[1]


def wgmma_plan(dout: int, ngh: int, n_sm: int):
    """(whole tiles, K splits, groups per split) of K1's wgmma form:
    `unit_plan`, with every tile whole when it takes no split."""
    whole, ks, gps = unit_plan(dout, ngh, n_sm)
    return (dout // ROWS_TILE_N, 1, ngh) if ks == 1 else (whole, ks, gps)


def k1_work(m: int, dout: int, bout: int, ngh: int, n_sm: int, group: int = 128):
    """Every unit of K1's launch for m rows, in the form `k1_form` picks, as
    the kernel deals them: (CTA, columns range, groups range)."""
    if k1_form(m, 2 * ngh * group) == "stream":
        spans = _spans(dout, bout, K1_BOX)
        ks, gps, n_cta = stream_plan(dout, bout, ngh, n_sm, group)
        for u in range(len(spans) * ks):
            z, sp = divmod(u, len(spans))
            jb, o0, w = spans[sp]
            yield (u % n_cta, (jb * bout + o0, jb * bout + o0 + w),
                   (z * gps, min(ngh, (z + 1) * gps)))
        return
    whole, ks, gps = wgmma_plan(dout, ngh, n_sm)
    tiles = dout // ROWS_TILE_N
    rest = tiles - whole
    for u in range(whole + rest * ks):
        if u < whole:
            tile, g = u, (0, ngh)
        else:
            z, t = divmod(u - whole, rest)
            tile, g = whole + t, (z * gps, min(ngh, (z + 1) * gps))
        yield (u % n_sm, (tile * ROWS_TILE_N, (tile + 1) * ROWS_TILE_N), g)


_K1_PTRS = ctypes.c_void_p * 5
_K1_INTS = ctypes.c_int * 11
_K1_MAP = ctypes.c_ubyte * 128  # a CUtensorMap
_K1_BAR_WORDS = 2 + 2 * 32  # the grid barrier's u64 count, then (row, plane) amax
_k1_maps: Dict[tuple, ctypes.Array] = {}
_k1_plans: Dict[tuple, tuple] = {}
_k1_ws: Dict[int, tuple] = {}
_k1_last: Dict[int, tuple] = {}
_k1_lock = threading.Lock()


def _k1_workspace(dev: torch.device, floats: int):
    """K1's scratch on a device (f32, grown to what a plan needs, else made
    once) and the wgmma form's barrier words (zeroed once: the grid
    barrier's 64-bit arrival count, which every launch advances and none
    resets, then the rows' amax, stored by each launch before its barrier).
    K1's own: a persistent kernel's barrier count relies on every launch of
    that kernel having the same grid. Launches share them, so they run on
    one stream. Growing the scratch drops the plans that point into it."""
    idx = _device_index(dev)
    with _k1_lock:
        ws, bar = _k1_ws.get(idx, (None, None))
        if bar is None:
            bar = torch.zeros(_K1_BAR_WORDS, dtype=torch.int32, device=dev)
        if ws is None or ws.numel() < floats:
            ws = torch.empty(max(floats, 1 << 18), dtype=torch.float32, device=dev)
            for key in [k for k in _k1_plans if k[-1] == idx]:
                del _k1_plans[key]
        _k1_ws[idx] = (ws, bar)
        return ws, bar


def _k1_map(lib, kind: str, ptr: int, *dims) -> ctypes.Array:
    """A TMA map of K1, encoded once per (kind, pointer, shape) and kept."""
    key = (kind, ptr) + dims
    tm = _k1_maps.get(key)
    if tm is None:
        tm = _K1_MAP()
        if kind == "digits":
            status = lib.w4_gemv_encode_digits(tm, ctypes.c_void_p(ptr), *dims)
        else:
            status = lib.w4_gemv_encode_weights(tm, ctypes.c_void_p(ptr), *dims)
        _build.check(status, f"w4_gemv_encode_{kind}")
        _k1_maps[key] = tm
    return tm


def _k1_lib():
    lib = _build.load("w4_gemv_sm90.cu")
    if lib.w4_gemv_stream.argtypes is None:
        for name in ("w4_gemv_encode_weights", "w4_gemv_encode_digits"):
            getattr(lib, name).restype = ctypes.c_int
        lib.w4_gemv_stream.argtypes = [_P] * 6
        lib.w4_gemv_wgmma.argtypes = [_P] * 7
        lib.w4_gemv_probe_v4.argtypes = [_P, ctypes.c_longlong, _P, _I, _P]
        for name in ("w4_gemv_stream", "w4_gemv_wgmma", "w4_gemv_probe_v4"):
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _k1_plan(dev, packed, scales, l, m):
    """What a K1 launch of m rows on this slot and layer needs besides x
    and out, made once: (entry point, its maps, pointers, ints, din, dout)."""
    _check_w4(packed, scales)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    check_group(gs, "w4_gemv")
    idx = _device_index(dev)
    n_sm, counters = _device_state(dev)
    form = k1_form(m, din)
    s_rows = scales.shape[-2]
    p_ptr = packed.data_ptr() + l * nj * half * bout
    s_ptr = scales.data_ptr() + l * nj * s_rows * bout * 2
    lib = _k1_lib()
    if form == "stream":
        if bout % 16:
            raise ValueError(f"K1's stream form needs bout % 16 == 0 ({bout})")
        ks, gps, n_cta = stream_plan(dout, bout, ngh, n_sm, gs)
        if len(_spans(dout, bout, K1_BOX)) > _COUNTER_SLOTS:
            raise ValueError(f"{dout} columns exceed the counter buffer")
        ws, _ = _k1_workspace(dev, ks * dout if ks > 1 else 0)
        maps = (_k1_map(lib, "weights", p_ptr, din, dout, bout, gs, K1_BOX, 0, idx),)
        ptrs = _K1_PTRS(s_ptr, ws.data_ptr() if ks > 1 else None, counters.data_ptr(), None,
                        None)
        ints = _K1_INTS(m, din, dout, bout, s_rows, gs, K1_BOX, ks, gps, n_cta, 0)
        return lib.w4_gemv_stream, maps, ptrs, ints, din, dout
    if bout % ROWS_TILE_N:
        raise ValueError(f"K1's wgmma form needs bout % 128 == 0 ({bout})")
    whole, ks, gps = wgmma_plan(dout, ngh, n_sm)
    m_pad, gp = 8 * -(-m // 8), padded_group(gs)
    hp = ngh * gp
    dig_f = 64 * -(-(4 * m_pad * hp // 4) // 64)  # (floats, 256-byte aligned regions)
    gsum_f = 64 * -(-(ngh * 2 * m_pad) // 64)
    split = whole < dout // ROWS_TILE_N
    ws, bar = _k1_workspace(dev, dig_f + gsum_f + (ks * m * dout if split else 0))
    base = ws.data_ptr()
    maps = (_k1_map(lib, "weights", p_ptr, din, dout, bout, gp, 128, 1, idx),
            _k1_map(lib, "digits", base, hp, m_pad, idx))
    ptrs = _K1_PTRS(s_ptr, base, base + 4 * dig_f,
                    base + 4 * (dig_f + gsum_f) if split else None, bar.data_ptr())
    ints = _K1_INTS(m, din, dout, bout, s_rows, gs, whole, ks, gps, n_sm, 0)
    return lib.w4_gemv_wgmma, maps, ptrs, ints, din, dout


def launch_gemv(x, packed, scales, layer_index, out) -> None:
    """Launch K1 on the current stream: out (m, dout) bf16 = x (m <= 32,
    din) bf16 @ the W4 slot, in the form `k1_form` picks. Counts nothing:
    the public wrapper counts."""
    dev = require_cuda(x, packed, scales, out)
    m = x.shape[0]
    _, _, l = _layer(packed, scales, layer_index)
    key = (packed.data_ptr(), tuple(packed.shape), scales.data_ptr(), tuple(scales.shape), l,
           m, _device_index(dev))
    plan = _k1_plans.get(key)
    if plan is None:
        if not 1 <= m <= 32:
            raise ValueError(f"w4_gemv takes 1..32 rows, got {m}")
        plan = _k1_plans[key] = _k1_plan(dev, packed, scales, l, m)
    fn, maps, ptrs, ints, din, dout = plan
    if x.shape != (m, din) or out.shape != (m, dout):
        raise ValueError(f"x {tuple(x.shape)} / out {tuple(out.shape)} against ({din}, {dout})")
    if x.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError(f"w4_gemv takes and returns bf16, got {x.dtype} / {out.dtype}")
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("w4_gemv takes 16-byte aligned rows")
    if fn.__name__ == "w4_gemv_wgmma":
        _k1_last[_device_index(dev)] = (ptrs, ints)
    status = fn(*maps, ptrs, ints, x.data_ptr(), out.data_ptr(), _stream(dev))
    _build.check(status, "w4_gemv")


def k1_digits(dev: torch.device):
    """The digits (2, 2, m_pad, ngh * gp) int8 and lo-plane group sums (ngh,
    2, m_pad) int32 of the device's last launch of K1's wgmma form, as it
    left them in its workspace (for checks: `_w4_digits_ref`'s layout)."""
    ptrs, ints = _k1_last[_device_index(dev)]
    m, din, gs = ints[0], ints[1], ints[5]
    m_pad, ngh = 8 * -(-m // 8), din // 2 // gs
    hp = ngh * padded_group(gs)
    ws, _ = _k1_ws[_device_index(dev)]
    raw = ws.view(torch.uint8)
    base = ws.data_ptr()
    d0, g0 = ptrs[1] - base, ptrs[2] - base
    digits = raw[d0:d0 + 4 * m_pad * hp].view(torch.int8)
    gsum = raw[g0:g0 + ngh * 2 * m_pad * 4].view(torch.int32)
    return digits.reshape(2, 2, m_pad, hp), gsum.reshape(ngh, 2, m_pad)


def launch_probe(packed: torch.Tensor, mode) -> torch.Tensor:
    """K1's stream yardstick, on no path: the byte sum (one int32 a CTA,
    as unsigned) of a flat (nj, din/2, bout) slab, read by the stream form's
    ring with `mode`-byte boxes (128 or 256) or, with mode "v4", by plain
    16-byte loads. Counts nothing."""
    dev = require_cuda(packed)
    nj, half, bout = packed.shape
    n_sm, _ = _device_state(dev)
    lib = _k1_lib()
    if mode == "v4":
        sums = torch.zeros(8 * n_sm, dtype=torch.int32, device=dev)
        status = lib.w4_gemv_probe_v4(packed.data_ptr(), packed.numel(), sums.data_ptr(),
                                      8 * n_sm, _stream(dev))
    else:
        n_cta = min(n_sm, nj * -(-bout // mode))
        sums = torch.zeros(n_cta, dtype=torch.int32, device=dev)
        idx = _device_index(dev)
        tm = _k1_map(lib, "weights", packed.data_ptr(), 2 * half, nj * bout, bout, 128, mode,
                     0, idx)
        ptrs = _K1_PTRS(None, None, None, sums.data_ptr(), None)
        ints = _K1_INTS(1, 2 * half, nj * bout, bout, 0, 128, mode, 1, half // 128, n_cta, 1)
        status = lib.w4_gemv_stream(tm, ptrs, ints, None, None, _stream(dev))
    _build.check(status, "w4_gemv_probe")
    return sums


def launch_digits(x, *, m, prologue=PRO_NONE, gamma=None, eps=0.0, value_out=None,
                  group=DEFAULT_GROUP):
    """Launch the `w4_digits` kernel on the current stream: (digits,
    dscale, gsum) of `_w4_digits_ref`'s shapes (groups of `group` padded to
    `padded_group`) for x's m rows ((m, din) rows, f32 or bf16 for the RMS
    prologue, bf16 otherwise; (m, 2 din) gate | up for SiLU); `value_out`, an
    (m, din) bf16 tensor, also receives the prologue values the digits
    expand (for checks). Counts nothing."""
    dev = require_cuda(x)
    check_group(group, "w4_digits")
    din = x.numel() // m // (2 if prologue == PRO_SILU else 1)
    ldx = 2 * din if prologue == PRO_SILU else din
    if x.numel() != m * ldx or not 1 <= m <= 32 or din % (2 * group):
        raise ValueError(f"x {tuple(x.shape)} does not hold {m} rows of {ldx} "
                         f"(din % {2 * group})")
    x_f32 = x.dtype == torch.float32
    if x.dtype not in (torch.bfloat16, torch.float32) or (x_f32 and prologue != PRO_RMS):
        raise TypeError(f"unsupported input dtype {x.dtype} for prologue {prologue}")
    if prologue == PRO_RMS:
        if gamma is None or gamma.numel() != din or gamma.dtype != torch.bfloat16:
            raise ValueError("RMS prologue needs a (din,) bf16 gamma")
        require_cuda(x, gamma)
    if value_out is not None:
        require_cuda(x, value_out)
        if value_out.dtype != torch.bfloat16 or value_out.numel() != m * din:
            raise ValueError(f"value_out {tuple(value_out.shape)} {value_out.dtype}")
    m_pad = 8 * -(-m // 8)
    ngh = din // 2 // group
    digits = torch.empty((2, 2, m_pad, ngh * padded_group(group)), dtype=torch.int8,
                         device=dev)
    dscale = torch.empty((m_pad, 2, 2), dtype=torch.float32, device=dev)
    gsum = torch.empty((ngh, 2, m_pad), dtype=torch.int32, device=dev)
    status = _fn("w4_gemv_mma.cu", "w4_digits", _DIGITS_ARGTYPES)(
        x.data_ptr(), int(x_f32), ldx, prologue, _ptr(gamma), float(eps), m, m_pad, din,
        group, digits.data_ptr(), dscale.data_ptr(), gsum.data_ptr(), _ptr(value_out),
        _stream(dev))
    _build.check(status, "w4_digits")
    return digits, dscale, gsum


def launch_gemv_rows(x, packed, scales, layer_index, *, m, prologue=PRO_NONE,
                     gamma=None, eps=0.0, **epilogue) -> None:
    """The tensor-core W4 GEMV for m <= 32 rows with a prologue (x as in
    `launch_digits`) and an epilogue (res_f32, res_bf16, bias, out_f32,
    out_bf16; `launch_rows`): two launches,
    `w4_digits` (the prologue, once) and `w4_gemv_rows` (one weight pass for
    all rows). Counts nothing: the public wrappers count."""
    require_cuda(x, packed, scales)
    gs = _tiled_meta(packed, scales)[4]
    expansion = launch_digits(x, m=m, prologue=prologue, gamma=gamma, eps=eps, group=gs)
    launch_rows(expansion, packed, scales, layer_index, m=m, **epilogue)


def launch_rows(expansion, packed, scales, layer_index, *, m, res_f32=None,
                res_bf16=None, bias=None, out_f32=None, out_bf16=None) -> None:
    """Launch `w4_gemv_rows` over `launch_digits`' expansion (digits,
    dscale, gsum) of m rows. Needs groups that are multiples of 16 up to
    128 and bout % 128 == 0. Counts nothing."""
    digits, dscale, gsum = expansion
    dev = require_cuda(digits, dscale, gsum, packed, scales)
    _check_w4(packed, scales)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    check_group(gs, "w4_gemv_rows")
    if bout % ROWS_TILE_N:
        raise ValueError(f"w4_gemv_rows needs bout % 128 == 0 ({bout})")
    if digits.shape[-1] != ngh * padded_group(gs) or digits.shape[2] != 8 * -(-m // 8):
        raise ValueError(f"digits {tuple(digits.shape)} against {m} rows of {din}")
    for t, dt in ((bias, torch.bfloat16), (res_f32, torch.float32),
                  (res_bf16, torch.bfloat16), (out_f32, torch.float32),
                  (out_bf16, torch.bfloat16)):
        if t is not None:
            require_cuda(digits, t)
            if t.dtype != dt or t.numel() != (dout if t is bias else m * dout):
                raise ValueError(f"epilogue tensor {tuple(t.shape)} {t.dtype}")
    _, _, l = _layer(packed, scales, layer_index)
    s_rows = scales.shape[-2]
    n_sm, counters = _device_state(dev)
    tiles, ksplit, gps = rows_plan(dout, ngh, n_sm)
    ws = None
    if ksplit > 1:
        ws = torch.empty((ksplit, m, dout), dtype=torch.float32, device=dev)
    status = _fn("w4_gemv_mma.cu", "w4_gemv_rows", _ROWS_ARGTYPES)(
        digits.data_ptr(), dscale.data_ptr(), gsum.data_ptr(),
        packed.data_ptr() + l * nj * half * bout,
        scales.data_ptr() + l * nj * s_rows * bout * 2,
        m, digits.shape[2], din, dout, bout, s_rows, gs, ksplit, gps,
        _ptr(ws), counters.data_ptr(), _ptr(res_f32), _ptr(res_bf16), _ptr(bias),
        _ptr(out_f32), _ptr(out_bf16), _stream(dev))
    _build.check(status, "w4_gemv_rows")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _gemm_counters_of(dev: torch.device) -> torch.Tensor:
    """The GEMM kernel's split-K words of a device (an arrival count, left
    0, and a generation per tile), zeroed once."""
    idx = _device_index(dev)
    if idx not in _gemm_counters:
        _gemm_counters[idx] = torch.zeros(2 * _COUNTER_SLOTS, dtype=torch.int32, device=dev)
    return _gemm_counters[idx]


def _device_state(dev: torch.device):
    """(SM count, zeroed arrival counters) of a device, made once."""
    idx = _device_index(dev)
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        _counters[idx] = torch.zeros(_COUNTER_SLOTS, dtype=torch.int32, device=dev)
    return _sm_count[idx], _counters[idx]


GEMM_TILE_N, GEMM_SLICE, GEMM_MAX_SLICES, GEMM_BK = 128, 64, 6, 32


@functools.lru_cache(maxsize=None)
def gemm_plan(m: int, dout: int, half: int, n_sm: int):
    """(slices of 64 rows per M tile, M tiles, K splits, k tiles of 32 per
    split, tail parts) of `w4_gemm_sm90`: 128 output columns per CTA; M
    tiles of at most six slices (384 rows), balanced, so that every weight
    element is dequantised once per M tile and a prompt of up to 384 tokens
    is one M tile. K is split (at most 8 ways) while the CTAs are fewer than
    the SMs and each split keeps at least 8 k tiles: a split grid is one
    cooperative wave, one CTA per SM. When one M tile's column tiles fill
    more than a whole number of waves, the tiles past the last whole wave
    are each shared by `tail parts` CTAs that take a part of the slices
    (their dequant repeats; the short last wave needs no partial sums)."""
    ns = -(-m // GEMM_SLICE)
    m_tiles = -(-ns // GEMM_MAX_SLICES)
    spt = -(-ns // m_tiles)
    tiles = dout // GEMM_TILE_N * m_tiles
    nk = half // GEMM_BK
    ksplit = max(1, min(n_sm // tiles, nk // 8, 8))
    kps = -(-nk // ksplit)
    parts = 0
    tail = tiles % n_sm
    if m_tiles == 1 and tiles > n_sm and tail:
        parts = min(ns, n_sm // tail)
        parts = parts if parts > 1 else 0
    return spt, m_tiles, -(-nk // kps), kps, parts


def gemm_work(m: int, dout: int, half: int, n_sm: int):
    """Every CTA of `w4_gemm_sm90`'s grid with the work its indices give it,
    as the kernel computes them: (CTA x, M tile, split, columns range, rows
    range, k tiles range)."""
    spt, m_tiles, ksplit, kps, parts = gemm_plan(m, dout, half, n_sm)
    nk = half // GEMM_BK
    tiles = dout // GEMM_TILE_N
    n_main = tiles // n_sm * n_sm
    nst = -(-m // GEMM_SLICE)
    for x in range(n_main + (tiles - n_main) * parts if parts else tiles):
        for y in range(m_tiles):
            tile, r0 = x, y * spt * GEMM_SLICE
            ns = min(spt, -(-(m - r0) // GEMM_SLICE))
            if parts and x >= n_main:
                part = (x - n_main) % parts
                tile = n_main + (x - n_main) // parts
                r0 = part * nst // parts * GEMM_SLICE
                ns = (part + 1) * nst // parts - part * nst // parts
            for z in range(ksplit):
                yield (x, y, z, (tile * GEMM_TILE_N, (tile + 1) * GEMM_TILE_N),
                       (r0, min(m, r0 + ns * GEMM_SLICE)),
                       (z * kps, min(nk, (z + 1) * kps)))


def _launch_gemm_sm90(x, w, scales, out, *, m, din, dout, bout, s_rows, gs, dots):
    dev = x.device
    n_sm, _ = _device_state(dev)
    spt, m_tiles, ksplit, kps, parts = gemm_plan(m, dout, din // 2, n_sm)
    if dout // GEMM_TILE_N * m_tiles > _COUNTER_SLOTS:
        raise ValueError(f"{m} x {dout} output exceeds the counter buffer")
    counters = _gemm_counters_of(dev)
    ws = None
    if ksplit > 1:
        ws = torch.empty((ksplit, m, dout), dtype=torch.float32, device=dev)
    status = _fn("w4_gemm_sm90.cu", "w4_gemm_sm90", _GEMM_ARGTYPES)(
        x.data_ptr(), w, scales, out.data_ptr(), _ptr(ws), counters.data_ptr(),
        m, din, dout, bout, s_rows, gs, spt, ksplit, kps, parts, n_sm, int(dots),
        _device_index(dev), _stream(dev))
    _build.check(status, "w4_gemm_sm90")


def launch_gemm(x, packed, scales, layer_index, out) -> None:
    """Launch the W4 GEMM kernel on the current stream (counts nothing)."""
    require_cuda(x, packed, scales, out)
    _check_w4(packed, scales)
    half, bout, nj, ngh, gs, din, dout = _tiled_meta(packed, scales)
    m = x.shape[0]
    if x.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError("w4 GEMM takes and returns bf16")
    if x.shape != (m, din) or out.shape != (m, dout):
        raise ValueError(f"x {tuple(x.shape)} / out {tuple(out.shape)} vs ({din}, {dout})")
    if bout % 128 or half % 32 or gs % 16:
        raise ValueError(f"w4_gemm needs bout % 128 == 0, din/2 % 32 == 0 and group % 16 "
                         f"== 0 ({bout}, {half}, {gs})")
    _, _, l = _layer(packed, scales, layer_index)
    s_rows = scales.shape[-2]
    _launch_gemm_sm90(x, packed.data_ptr() + l * nj * half * bout,
                      scales.data_ptr() + l * nj * s_rows * bout * 2, out,
                      m=m, din=din, dout=dout, bout=bout, s_rows=s_rows, gs=gs, dots=False)


def launch_gemm_dots(x, w, out) -> None:
    """Launch the GEMM kernel's products alone (the DOTS variant) over a
    pre-dequantised bf16 (din, dout) weight (counts nothing)."""
    require_cuda(x, w, out)
    m, din = x.shape
    dout = w.shape[1]
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 or out.dtype != torch.bfloat16:
        raise TypeError("the products take and return bf16")
    if w.shape != (din, dout) or out.shape != (m, dout) or din % 64 or dout % 128:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, out {tuple(out.shape)}")
    _launch_gemm_sm90(x, w.data_ptr(), None, out, m=m, din=din, dout=dout, bout=dout,
                      s_rows=0, gs=din // 2, dots=True)


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
    launch_gemv(x, packed, scales, layer_index, out)
    _build.count("w4_gemv")
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
    _build.count("w4_gemm")
    return out


def bf16_matmul_dots(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, din) @ w (din, dout), both bf16, through the W4 GEMM kernel's
    ring and products with no dequant (`w4_gemm_sm90.cu`'s DOTS variant, the
    counterpart of the TPU prototype `dots_only_kernel`): it measures what
    the dequant costs K2. On no path of the port."""
    if x.device.type == "cpu":
        return (x.float() @ w.float()).to(x.dtype)
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.bfloat16, device=x.device)
    launch_gemm_dots(x, w, out)
    _build.count("w4_gemm_dots")
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

    def qslot(kernel, bias=None, bout_budget=None):
        bout = None
        if bout_budget is not None:
            bout = pick_bout(kernel.shape[-2], kernel.shape[-1], budget=bout_budget)
        q = quantize_w4(kernel, group_for(kernel.shape[-2] // 2, group_size), bout=bout)
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
        q = quantize_w4(kernel, group_for(kernel.shape[-2] // 2, group_size))
        out["lm_head"] = {"packed": q["packed"], "scales": q["scales"]}
    return out
