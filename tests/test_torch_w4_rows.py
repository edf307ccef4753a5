"""The batched decode layer's (K6) tensor-core route on the CPU: the digit
pass `w4_digits` and the rows GEMV `w4_gemv_rows` (`csrc/w4_gemv_mma.cu`)
through their plain versions, the rows kernel's launch plan, and a Python
twin of the batched decode attention's walk.

The JAX side runs the decode kernel in interpret mode, as
`tests/test_torch_quant.py` does. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vila_tpu.ops import fused_decode as jfused
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.ops import quant as tquant
from vila_tpu_torch.utils import weights

DIN, DOUT = 512, 384
EPS = 1e-6


def _bf16_np(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _jax_slot(seed, shape=(DIN, DOUT)):
    w = (0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    q = jquant.quantize_w4(jnp.asarray(w))
    jp, js = np.asarray(q["packed"]), np.asarray(q["scales"])
    t = weights.from_jax_params({"packed": jp, "scales": js}, device="cpu")
    return jp, js, t["packed"], t["scales"]


def _jax_prologue(x, prologue, gamma):
    """The JAX package's prologue values (its fused kernels' expressions),
    rounded to bf16, as f32."""
    x32 = jnp.asarray(x, jnp.float32)
    if prologue == tquant.PRO_RMS:
        x32 = jfused._rms_scale(x32, jnp.asarray(gamma), EPS)
    elif prologue == tquant.PRO_SILU:
        inter = x32.shape[1] // 2
        x32 = x32[:, :inter] * jax.nn.sigmoid(x32[:, :inter]) * x32[:, inter:]
    return np.asarray(x32.astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("prologue", [tquant.PRO_NONE, tquant.PRO_RMS, tquant.PRO_SILU],
                         ids=["none", "rms", "silu"])
def test_digit_pass_matches_jax_bit_for_bit(prologue):
    """`_w4_digits_ref` (the w4_digits kernel's plain version): its digits
    (in the rows kernel's k order, un-permuted here), s1 / s2 per half-plane
    and lo-plane group sums equal the JAX package's `_int8_digits` and
    `_prequantize_plane` bit for bit on the same prologue values; the
    prologue values themselves agree with the JAX fused kernels' within one
    bf16 ulp (different f32 reduction orders before the rounding)."""
    m = 5
    rng = np.random.default_rng(40 + prologue)
    width = 2 * DIN if prologue == tquant.PRO_SILU else DIN
    x = _bf16_np(rng, (m, width))
    gamma = _bf16_np(rng, (DIN,), 0.1) + 1.0
    tx, tg = torch.from_numpy(x), torch.from_numpy(gamma).to(torch.bfloat16)
    values = tquant._prologue_ref(tx, prologue, tg, EPS)
    np.testing.assert_allclose(values.numpy(), _jax_prologue(x, prologue, gamma),
                               rtol=2.0 ** -7, atol=1e-30)

    digits, dscale, gsum = tquant._w4_digits_ref(tx, prologue, tg, EPS)
    assert digits.shape == (2, 2, 8, DIN // 2) and digits.dtype == torch.int8
    assert gsum.shape == (DIN // 256, 2, 8)
    assert not digits[:, :, m:].any() and not dscale[m:].any() and not gsum[:, :, m:].any()
    half, ngh = DIN // 2, DIN // 2 // 128
    for p in range(2):
        plane = values[:, p * half:(p + 1) * half].numpy()
        jd = jquant._int8_digits(jnp.asarray(plane), 2)
        jpre = jquant._prequantize_plane(jnp.asarray(plane), 2, 128, ngh)
        for d in range(2):
            got = tquant._plain_order(digits[p, d, :m]).numpy()
            np.testing.assert_array_equal(got, np.asarray(jd[d][0]))
            np.testing.assert_array_equal(got, np.asarray(jpre[d][0]))
            np.testing.assert_array_equal(dscale[:m, p, d].numpy(), np.asarray(jd[d][1])[:, 0])
            if p == 0:
                np.testing.assert_array_equal(gsum[:, d, :m].T.numpy(),
                                              np.asarray(jpre[d][2]).astype(np.int32))


def test_mma_order_is_the_kernels_permutation():
    """Position kappa of each 32-block holds row 8 (kappa % 4) + 2 ((kappa %
    16) // 4) + kappa // 16, the rows a thread reads (4t + j <- 8j + 2t,
    16 + 4t + j <- 8j + 2t + 1), and `_plain_order` undoes it."""
    x = torch.arange(64)
    got = tquant._mma_order(x)
    for blk in range(2):
        for t in range(4):
            for j in range(4):
                assert got[32 * blk + 4 * t + j] == 32 * blk + 8 * j + 2 * t
                assert got[32 * blk + 16 + 4 * t + j] == 32 * blk + 8 * j + 2 * t + 1
    assert torch.equal(tquant._plain_order(got), x)


@pytest.mark.parametrize("m", [2, 9, 16, 24])
def test_rows_plain_matches_jax_decode_kernel_and_ref(m):
    """The rows GEMV's arithmetic (whole-group int32 sums, then the f32
    scale) against the JAX decode kernel (interpret mode) and K1's plain
    version, f32 in and out on bf16-exact inputs; 1e-4 covers the f32
    summation order over groups and digits."""
    rng = np.random.default_rng(60 + m)
    jp, js, tp, ts = _jax_slot(7)
    x = _bf16_np(rng, (m, DIN))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jp, js))
    got = tquant._w4_rows_ref(torch.from_numpy(x), tp, ts)
    assert got.shape == (m, DOUT) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    k1 = tquant._w4_gemv_ref(torch.from_numpy(x), tp, ts, out_f32=True)
    np.testing.assert_allclose(got.numpy(), k1.numpy(), rtol=1e-4, atol=1e-4)


def test_rows_plain_stacked_layer_with_prologue():
    """A stacked slot's layer 1 with the RMS prologue: the digit pass and
    the rows GEMV give the JAX decode kernel's product of the prologue
    values."""
    rng = np.random.default_rng(70)
    jp, js, tp, ts = _jax_slot(8, (2, DIN, DOUT))
    h = rng.standard_normal((6, DIN)).astype(np.float32)
    gamma = _bf16_np(rng, (DIN,), 0.1) + 1.0
    tg = torch.from_numpy(gamma).to(torch.bfloat16)
    x1 = tquant._prologue_ref(torch.from_numpy(h), tquant.PRO_RMS, tg, EPS)
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x1.numpy()), jp, js,
                                              layer_index=jnp.asarray(1, jnp.int32)))
    got = tquant._w4_rows_ref(torch.from_numpy(h), tp, ts, 1, tquant.PRO_RMS, tg, EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name,din,dout,budget", [
    ("o", 4 * 8 * 128, 3584, None), ("gate_up", 3584, 2 * 18944, None),
    ("down", 18944, 3584, 5 << 20), ("qkv", 3584, (28 + 8) * 128, None)])
def test_rows_launch_plan_covers_each_column_and_group_once(name, din, dout, budget):
    """At the NVILA-8B shapes of K6's four products on a 132-SM card, the
    rows kernel's grid covers every (output column, group of 128 input
    rows) exactly once, each CTA inside one bout block of the tiled layout
    and with at least one group, and holds at least one CTA per SM."""
    bout = tquant.pick_bout(din, dout, budget or tquant._BLOCK_BUDGET)
    ngh = din // 2 // 128
    seen = np.zeros((dout, ngh), np.int32)
    ctas = 0
    for _, _, (c0, c1), jb, (g0, g1) in tquant.rows_work(dout, bout, ngh, 132):
        assert jb * bout <= c0 and c1 <= (jb + 1) * bout
        assert g0 < g1
        seen[c0:c1, g0:g1] += 1
        ctas += 1
    assert (seen == 1).all()
    assert ctas >= 132


def test_rows_launches_raise_off_the_card():
    """A CPU tensor never reaches the kernels' launch functions: they raise
    (the public wrappers take the plain versions first)."""
    _, _, tp, ts = _jax_slot(9)
    x = torch.zeros((4, DIN), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.launch_digits(x, m=4)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.launch_gemv_rows(x, tp, ts, None, m=4, out_bf16=torch.empty((4, DOUT)))


def _attn_twin(q32, k_rows, v_rows, mask_row, n_rows, hkv, hd, grp, chunk=128, half=64,
               warps=4):
    """Python twin of `decode_attn_b_kernel`'s walk for one batch row: per
    kv head, 128-row chunks in two halves, each warp's 16 rows of a half in
    an online softmax (f32, P rounded to bf16 for P V), the warps merged in
    order into the chunk's partial, the chunks merged in split order."""
    p_rows = q32.shape[0] // hkv
    out = torch.zeros((hkv * p_rows, hd))
    neg = -3.0e38
    for g in range(hkv):
        q = q32[g * p_rows:(g + 1) * p_rows].float()
        parts = []
        for t0 in range(0, n_rows, chunk):
            wm, wl, wo = [], [], []
            for w in range(warps):
                m_run = torch.full((p_rows,), neg)
                l_run = torch.zeros(p_rows)
                o = torch.zeros((p_rows, hd))
                for hf in range(chunk // half):
                    rows = torch.arange(t0 + hf * half + w * 16, t0 + hf * half + w * 16 + 16)
                    ok = rows < n_rows
                    r = rows.clamp(max=n_rows - 1)
                    kk = k_rows[r, g * hd:(g + 1) * hd].float()
                    vv = v_rows[r, g * hd:(g + 1) * hd].float()
                    s = torch.where(ok, q @ kk.T + mask_row[r].float(), torch.tensor(neg))
                    m_new = torch.maximum(m_run, s.amax(-1))
                    corr = torch.exp(m_run - m_new)
                    p = torch.where(ok, torch.exp(s - m_new[:, None]), 0.0)
                    l_run = l_run * corr + p.sum(-1)
                    o = o * corr[:, None] + p.to(torch.bfloat16).float() @ vv
                    m_run = m_new
                wm.append(m_run)
                wl.append(l_run)
                wo.append(o)
            mb = torch.stack(wm).amax(0)
            e = [torch.exp(m - mb) for m in wm]
            parts.append((mb, sum(l * x for l, x in zip(wl, e)),
                          sum(o * x[:, None] for o, x in zip(wo, e))))
        mx = torch.stack([p[0] for p in parts]).amax(0)
        lsum = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
        acc = sum(p[2] * torch.exp(p[0] - mx)[:, None] for p in parts)
        res = acc / lsum[:, None]
        res[grp:] = 0.0
        out[g * p_rows:(g + 1) * p_rows] = res
    return out.reshape(1, -1)


@pytest.mark.parametrize("n_rows", [1, 64, 200, 300])
def test_batched_attention_walk_matches_plain(n_rows):
    """The batched attention kernel's walk (chunks, halves, warps, merges,
    bf16 P) against the plain `_decode_attn_ref` for one row; P's bf16
    rounding bounds the error at a few bf16 ulps of the output."""
    rng = np.random.default_rng(80 + n_rows)
    hkv, hd, grp, s_len = 2, 128, 7, 320
    q = (hd ** -0.5 * rng.standard_normal((hkv, 8, hd))).astype(np.float32)
    q[:, grp:] = 0.0
    q32 = torch.from_numpy(q.reshape(hkv * 8, hd)).to(torch.bfloat16)
    k = torch.from_numpy(rng.standard_normal((s_len, hkv * hd)).astype(np.float32)).bfloat16()
    v = torch.from_numpy(rng.standard_normal((s_len, hkv * hd)).astype(np.float32)).bfloat16()
    mask = torch.from_numpy(np.where(rng.random(s_len) < 0.1, -1e30, 0.0).astype(np.float32))
    mask[0] = 0.0
    want = tfused._decode_attn_ref(q32, k[:n_rows], v[:n_rows], mask[:n_rows], hkv, hd, grp)
    got = _attn_twin(q32, k, v, mask, n_rows, hkv, hd, grp)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), atol=2e-2, rtol=2e-2)
    assert not got.reshape(hkv, 8, hd)[:, grp:].any()
