"""The bs=1 main path's Hopper kernels on the CPU: the tile plan of the W4
prefill GEMM (K2, `csrc/w4_gemm_sm90.cu`), the unit plan of the persistent
decode layer (K3, `csrc/decode_layer_sm90.cu`), the shared W4 prologue's
independence of summation order, and the launchers' refusal of CPU tensors.
The kernels' arithmetic is held against the JAX package by
`tests/test_torch_quant.py` (K2's plain version), `tests/test_torch_w4_rows.py`
(the prologue and digits) and `tests/test_torch_fused_decode.py` (K3's plain
version); here only what the host decides is checked.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.ops import quant as tquant

N_SM = 132  # the H100's SMs

# (din, dout) of one layer's four W4 products: NVILA-8B (Qwen2-7B, o GQA-padded
# to 8 heads a group) and NVILA-Lite-2B (Qwen2-1.5B)
SHAPES_8B = {"qkv": (3584, 4608), "o": (4096, 3584), "gate_up": (3584, 37888),
             "down": (18944, 3584)}
SHAPES_2B = {"qkv": (1536, 2048), "o": (2048, 1536), "gate_up": (1536, 17920),
             "down": (8960, 1536)}
GEMM_CASES = [(tag, name, m) for tag, shapes in (("8b", SHAPES_8B), ("2b", SHAPES_2B))
              for name in shapes for m in (33, 295, 305, 320, 1024)]


@pytest.mark.parametrize("tag,name,m", GEMM_CASES,
                         ids=[f"{t}-{n}-M{m}" for t, n, m in GEMM_CASES])
def test_gemm_plan_covers_every_tile_once(tag, name, m):
    """K2's grid covers every (64-row slice of M, output column tile, k tile
    of 32) exactly once; a CTA holds at most 384 rows; prompts of the main
    path (295-320 tokens) are one M tile, so no weight element is
    dequantised twice outside the last wave's shared tiles; a split-K grid
    is one wave (the kernel's cooperative launch needs it co-resident) and
    so is the shared last wave."""
    din, dout = (SHAPES_8B if tag == "8b" else SHAPES_2B)[name]
    half = din // 2
    nk, tiles, ns = half // 32, dout // 128, -(-m // 64)
    spt, m_tiles, ksplit, kps, parts = tquant.gemm_plan(m, dout, half, N_SM)
    seen = np.zeros((ns, tiles, nk), np.int8)
    ctas = 0
    for x, y, z, (c0, c1), (r0, r1), (k0, k1) in tquant.gemm_work(m, dout, half, N_SM):
        assert c1 - c0 == 128 and 0 < r1 - r0 <= 384 and k0 < k1
        assert r0 % 64 == 0 and (r1 % 64 == 0 or r1 == m)
        seen[r0 // 64:-(-r1 // 64), c0 // 128, k0:k1] += 1
        ctas += 1
    assert (seen == 1).all()
    if 295 <= m <= 320:
        assert m_tiles == 1
    if ksplit > 1:
        assert ctas <= N_SM and parts == 0
    if parts:
        assert (tiles % N_SM) * parts <= N_SM and ksplit == 1


@pytest.mark.parametrize("tag", ["8b", "2b"])
def test_layer_plan_covers_every_column_and_group_once(tag):
    """K3's four products (o, gate_up, down, qkv) deal (column tile, K
    split) units round-robin to one CTA per SM: every (output column, group
    of 128 input rows) exactly once, no CTA index past the SMs, at most 4
    splits for o and down (every CTA sums their partials) and at most 16
    for the others."""
    shapes = SHAPES_8B if tag == "8b" else SHAPES_2B
    dims = [shapes[n] for n in ("o", "gate_up", "down", "qkv")]
    seen = [np.zeros((dout, din // 256), np.int8) for din, dout in dims]
    splits = [set() for _ in dims]
    for p, cta, tile, split, (c0, c1), (g0, g1) in tfused.layer_work(dims, N_SM):
        assert 0 <= cta < N_SM and g0 < g1 and c0 == tile * 128
        seen[p][c0:c1, g0:g1] += 1
        splits[p].add(split)
    assert all((s == 1).all() for s in seen)
    for p, cap in enumerate(tfused.LAYER_SPLIT_CAPS):
        assert len(splits[p]) <= cap
    assert len(splits[0]) <= 4 and len(splits[2]) <= 4


def test_layer_plan_balances_the_main_shape():
    """At the NVILA-8B shape the busiest CTA streams at most one group more
    than the average of each product (o: 4 of 3.4, gate_up: 32 of 31.4,
    down: 19 of 15.7 with 112 CTAs busy, qkv: 4 of 3.8)."""
    dims = [SHAPES_8B[n] for n in ("o", "gate_up", "down", "qkv")]
    load = np.zeros((4, N_SM), np.int64)
    for p, cta, _, _, _, (g0, g1) in tfused.layer_work(dims, N_SM):
        load[p, cta] += g1 - g0
    assert load.max(1).tolist() == [4, 32, 19, 4]


@pytest.mark.parametrize("n_rows", [1, 33, 1301, 2048, 8192])
def test_attn_plan_covers_the_live_rows(n_rows):
    """K3's attention chunks: at most 64 rows each, together exactly the
    live rows, one chunk of each kv head per CTA while they fit."""
    hkv = 4
    chunk, nsplit = tfused.attn_plan(n_rows, hkv, N_SM)
    assert 1 <= chunk <= 64 and (nsplit - 1) * chunk < n_rows <= nsplit * chunk
    if n_rows <= 64 * (N_SM // hkv):
        assert hkv * nsplit <= N_SM


def _bf16(x):
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("prologue,dtype", [
    (tquant.PRO_RMS, torch.float32), (tquant.PRO_RMS, torch.bfloat16),
    (tquant.PRO_SILU, torch.bfloat16)], ids=["rms-f32", "rms-bf16", "silu-bf16"])
def test_prologue_values_do_not_depend_on_order(prologue, dtype):
    """The prologue value (`quant._prologue_ref`, the definition the kernels
    share) of a row and of the same row permuted, gamma permuted alike, are
    equal bit for bit: the RMS statistic is an f64 sum of exact squares,
    rounded once. Rows of the NVILA-8B width with values spread over six
    binades, where f32 sums in two orders would differ."""
    rng = np.random.default_rng(60 + prologue)
    d = 3584
    m = 8
    width = 2 * d if prologue == tquant.PRO_SILU else d
    x = rng.standard_normal((m, width)) * np.exp2(rng.integers(-3, 3, (m, width)))
    x = x.astype(np.float32)
    gamma = _bf16(1.0 + 0.1 * rng.standard_normal(d).astype(np.float32))
    perm = rng.permutation(d)
    xp = x.copy()
    if prologue == tquant.PRO_SILU:
        xp[:, :d], xp[:, d:] = x[:, :d][:, perm], x[:, d:][:, perm]
    else:
        xp = x[:, perm]
    tg = torch.from_numpy(gamma).to(torch.bfloat16)
    tgp = torch.from_numpy(gamma[perm]).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(dtype)
    txp = torch.from_numpy(xp).to(dtype)
    v = tquant._prologue_ref(tx, prologue, tg, 1e-6)
    vp = tquant._prologue_ref(txp, prologue, tgp, 1e-6)
    assert torch.equal(v[:, perm], vp)
    if prologue == tquant.PRO_RMS:  # the f32 sum does depend on the order here
        x32 = tx.float()
        s1 = x32.square().sum(-1)
        s2 = x32[:, perm].square().flip(-1).cumsum(-1)[:, -1]
        assert not torch.equal(s1, s2)


def test_new_launchers_raise_off_the_card():
    """A CPU tensor never reaches K2's or K3's launch functions: they raise
    (the public wrappers take the plain versions first)."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy((0.05 * rng.standard_normal((512, 384))).astype(np.float32))
    q = tquant.quantize_w4(w)
    x = torch.zeros((40, 512), dtype=torch.bfloat16)
    out = torch.empty((40, 384), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.launch_gemm(x, q["packed"], q["scales"], None, out)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.launch_gemm_dots(x, w.to(torch.bfloat16), out)
    kc = torch.zeros((1, 1, 64, 256), dtype=torch.bfloat16)
    slot = {"packed": q["packed"][None], "scales": q["scales"][None]}
    with pytest.raises(ValueError, match="CUDA"):
        tfused.launch_layer(torch.zeros((16, 128), dtype=torch.bfloat16), kc, kc,
                            torch.zeros((1, 64)), torch.zeros((1, 256), dtype=torch.bfloat16),
                            0, 0, 10, 2, 128, 7, (slot,) * 4,
                            (torch.ones(256, dtype=torch.bfloat16),) * 2 + (None,), 1e-6,
                            torch.empty(512 + 384, dtype=torch.bfloat16))


def test_bf16_matmul_dots_plain_version():
    """X1's counterpart on the CPU: x @ w in f32, rounded to bf16 once; on
    the dequantised W4 weights it is K2's plain version."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy((0.05 * rng.standard_normal((512, 384))).astype(np.float32))
    q = tquant.quantize_w4(w)
    x = torch.from_numpy(_bf16(rng.standard_normal((40, 512)).astype(np.float32))).to(
        torch.bfloat16)
    got = tquant.bf16_matmul_dots(x, tquant.dequantize(q))
    assert torch.equal(got, tquant._w4_gemm_ref(x, q["packed"], q["scales"]))
