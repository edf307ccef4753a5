"""The decode layer's halves K4 and K5 on the persistent tensor-core kernel
(`csrc/w4_pair_sm90.cu`) and the W4 groups of 112 (Qwen2-0.5B's D = 896) on
every W4 route, on the CPU.

What the host decides is checked here: the pair kernel's unit plan
(`quant.unit_plan` / `fused_decode.pair_work`) and the kernel's row stages, the
plans of K2, K3 and K6 at group 112, and the padded digit layout of the
tensor-core kernels (`quant.padded_group`). The plain versions of K3-K6 are
held against the JAX package's kernels in interpret mode at a width where
the quantizer takes groups of 112 and the heads are 64 wide. The JAX
package's `_tiled_meta` tries a fixed list of group sizes that lacks 112
(its own quantizer's choice at D = 448 or 896), so those tests give it the
quantizer's rule for the one shape it cannot infer; nothing in the package
changes. Inputs are drawn with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.ops import fused_decode as jfused
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.ops import quant as tquant
from vila_tpu_torch.utils import weights

N_SM = 132  # the H100's SMs
TOL = 1e-2  # as tests/test_torch_fused_batched.py


def _widths(d, inter, hq, hkv, hd=128):
    """(din, dout) of the four products, o GQA-padded to 8 heads a group."""
    return {"qkv": (d, (hq + 2 * hkv) * hd), "o": (hkv * 8 * hd, d),
            "gate_up": (d, 2 * inter), "down": (inter, d)}


WIDTHS = {
    "nvila-8b": _widths(3584, 18944, 28, 4),  # Qwen2-7B
    "qwen2-1.5b": _widths(1536, 8960, 12, 2),
    "qwen2-0.5b": _widths(896, 4864, 14, 2, hd=64),
}
PAIRS = {"k4": ("o", "gate_up"), "k5": ("down", "qkv")}
PLAN_CASES = [(w, k, m) for w in WIDTHS for k in PAIRS for m in (1, 17, 24, 32)]


@pytest.mark.parametrize("width,kernel,m", PLAN_CASES,
                         ids=[f"{w}-{k}-M{m}" for w, k, m in PLAN_CASES])
def test_pair_plan_covers_every_column_and_group_once(width, kernel, m):
    """K4's (o, gate_up) and K5's (down, qkv) units on one CTA per SM: every
    (output column, group) of both products exactly once, in the quantizer's
    groups (112 at Qwen2-0.5B's D-input products), at most 4 splits for
    product 1 (the row stages sum its partials) and 16 for product 2. The
    row stages: m_pad = 8 ceil(m / 8) rows, each taken by N // m_pad CTAs
    whose digit blocks (runs of eight, every parts-th run) cover each
    (plane, group) block of the row once; K5's SiLU pieces (row, plane,
    group) stay within the kernel's 128 a CTA."""
    dims = [WIDTHS[width][n] for n in PAIRS[kernel]]
    seen = []
    for din, dout in dims:
        gs = tquant.group_for(din // 2)
        seen.append(np.zeros((dout, din // 2 // gs), np.int8))
    splits = [set(), set()]
    for p, cta, tile, split, (c0, c1), (g0, g1) in tfused.pair_work(dims, N_SM):
        assert 0 <= cta < N_SM and g0 < g1 and c0 == tile * 128 and c1 - c0 == 128
        seen[p][c0:c1, g0:g1] += 1
        splits[p].add(split)
    assert all((s == 1).all() for s in seen)
    assert len(splits[0]) <= tfused.PAIR_SPLIT_CAPS[0]
    assert len(splits[1]) <= tfused.PAIR_SPLIT_CAPS[1]

    m_pad = 8 * -(-m // 8)
    parts = max(1, N_SM // m_pad)
    assert m_pad <= 32 and m_pad * parts <= N_SM
    for din, _ in (dims[0], (dims[1][0], None)):  # the row stages' inputs
        nblk = 2 * (din // 2 // tquant.group_for(din // 2))
        got = np.zeros((m_pad, nblk), np.int8)
        for c in range(m_pad * parts):
            r, part = c % m_pad, c // m_pad
            for warp in range(8):
                for b in range(part * 8 + warp, nblk, 8 * parts):
                    got[r, b] += 1
        assert (got == 1).all()
    if kernel == "k5":
        din = dims[0][0]
        pieces = m_pad * 2 * (din // 2 // tquant.group_for(din // 2))
        assert -(-pieces // N_SM) <= 128


def test_pair_plan_balances_the_main_shape():
    """At NVILA-8B the busiest CTA streams at most the mean plus one group
    of each product, but K5's down (capped at 4 splits: 19 of 15.7)."""
    want = {"k4": [4, 32], "k5": [19, 4]}
    for kernel, names in PAIRS.items():
        dims = [WIDTHS["nvila-8b"][n] for n in names]
        load = np.zeros((2, N_SM), np.int64)
        for p, cta, _, _, _, (g0, g1) in tfused.pair_work(dims, N_SM):
            load[p, cta] += g1 - g0
        assert load.max(1).tolist() == want[kernel]


def test_pair_launcher_raises_off_the_card():
    """A CPU tensor never reaches K4/K5's launch function: it raises (the
    public wrappers take the plain versions first)."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy((0.05 * rng.standard_normal((2, 256, 256))).astype(np.float32))
    q = tquant.quantize_w4(w)
    slot = {"packed": q["packed"], "scales": q["scales"]}
    x = torch.zeros((20, 256), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tfused.launch_pair(x, x, torch.ones(256, dtype=torch.bfloat16), None, (slot, 0),
                           (slot, 0), tquant.PRO_NONE, 1e-6, torch.empty_like(x),
                           torch.empty_like(x))


# --------------------------------------------------------------------------
# Groups of 112 on the host plans of K2, K3 and K6
# --------------------------------------------------------------------------

SMALL = WIDTHS["qwen2-0.5b"]


def test_quantizer_takes_group_112_and_tiled_meta_infers_it():
    """At D = 896 the quantizer takes groups of 112 (the largest size <= 128
    dividing D / 2 = 448), and the port's `_tiled_meta` infers it from the
    tiled shapes; the packed bytes and scales equal the JAX package's."""
    rng = np.random.default_rng(5)
    w = (0.05 * rng.standard_normal((896, 1152))).astype(np.float32)
    jq = jquant.quantize_w4(jnp.asarray(w), 112)
    tq = tquant.quantize_w4(torch.from_numpy(w), tquant.group_for(448))
    assert tquant.group_for(448) == 112 and tquant.group_for(14784) == 112
    np.testing.assert_array_equal(tq["packed"].numpy(), np.asarray(jq["packed"]))
    np.testing.assert_array_equal(tq["scales"].float().numpy(),
                                  np.asarray(jq["scales"], np.float32))
    assert tquant._tiled_meta(tq["packed"], tq["scales"])[4] == 112


def test_layer_plan_covers_group_112():
    """K3's four products at Qwen2-0.5B: every (column, group) once, with the
    D-input products in groups of 112."""
    dims = [SMALL[n] for n in ("o", "gate_up", "down", "qkv")]
    seen = [np.zeros((dout, din // 2 // tquant.group_for(din // 2)), np.int8)
            for din, dout in dims]
    for p, cta, tile, split, (c0, c1), (g0, g1) in tfused.layer_work(dims, N_SM):
        assert 0 <= cta < N_SM and g0 < g1
        seen[p][c0:c1, g0:g1] += 1
    assert all((s == 1).all() for s in seen)
    assert [s.shape[1] for s in seen] == [4, 4, 19, 4]  # 112, 112, 128, 112 rows


@pytest.mark.parametrize("name", list(SMALL))
def test_rows_plan_covers_group_112(name):
    """K6's rows GEMV at Qwen2-0.5B: every (column, group) once."""
    din, dout = SMALL[name]
    gs = tquant.group_for(din // 2)
    bout = tquant.pick_bout(din, dout)
    ngh = din // 2 // gs
    seen = np.zeros((dout, ngh), np.int32)
    for _, _, (c0, c1), jb, (g0, g1) in tquant.rows_work(dout, bout, ngh, N_SM):
        assert jb * bout <= c0 and c1 <= (jb + 1) * bout and g0 < g1
        seen[c0:c1, g0:g1] += 1
    assert (seen == 1).all()


GEMM_SMALL = [(n, m) for n in SMALL for m in (33, 300, 320)]


@pytest.mark.parametrize("name,m", GEMM_SMALL, ids=[f"{n}-M{m}" for n, m in GEMM_SMALL])
def test_gemm_plan_covers_group_112_shapes(name, m):
    """K2 at Qwen2-0.5B: every (64-row slice, column tile, k tile of 32)
    once; a 32-deep k tile of a group of 112 may hold two groups, whose
    scale rows the kernel takes by k row."""
    din, dout = SMALL[name]
    half = din // 2
    nk, tiles, ns = half // 32, dout // 128, -(-m // 64)
    seen = np.zeros((ns, tiles, nk), np.int8)
    for x, y, z, (c0, c1), (r0, r1), (k0, k1) in tquant.gemm_work(m, dout, half, N_SM):
        seen[r0 // 64:-(-r1 // 64), c0 // 128, k0:k1] += 1
    assert (seen == 1).all()
    gs = tquant.group_for(half)
    two = [k for k in range(nk) if (32 * k) // gs != (32 * k + 31) // gs]
    assert (gs % 32 == 0) == (not two)


# --------------------------------------------------------------------------
# The padded digit layout against the JAX package, group 112
# --------------------------------------------------------------------------


def _bf16_np(rng, shape, scale=1.0):
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


@pytest.mark.parametrize("m", [3, 20])
def test_padded_digits_match_jax_quant_planes_at_group_112(m):
    """`_w4_digits_ref` at group 112: each group padded with zero digits to
    128 (`padded_group`), in the kernels' k order; un-padded and un-permuted
    they equal the JAX package's `_quant_planes` (the fused kernels' digit
    expansion) bit for bit, and so do the digit scales and the lo plane's
    group sums."""
    din, gs = 448, 112
    rng = np.random.default_rng(90 + m)
    x = _bf16_np(rng, (m, din))
    digits, dscale, gsum = tquant._w4_digits_ref(torch.from_numpy(x), group=gs)
    m_pad, ngh, gp = 8 * -(-m // 8), din // 2 // gs, tquant.padded_group(gs)
    assert gp == 128 and digits.shape == (2, 2, m_pad, ngh * gp)
    pad = tquant._plain_order(digits).reshape(2, 2, m_pad, ngh, gp)[..., gs:]
    assert not pad.any() and not digits[:, :, m:].any()
    jlo, jhi = jfused._quant_planes(jnp.asarray(x), gs, ngh)
    for p, planes in enumerate((jlo, jhi)):
        for d, (q, s, csum) in enumerate(planes):
            got = tquant._unpad_digits(digits[p, d, :m], gs).numpy()
            np.testing.assert_array_equal(got, np.asarray(q))
            np.testing.assert_array_equal(dscale[:m, p, d].numpy(), np.asarray(s)[:, 0])
            if p == 0:
                np.testing.assert_array_equal(gsum[:, d, :m].T.numpy(),
                                              np.asarray(csum).astype(np.int32))


def test_rows_plain_matches_jax_decode_kernel_at_group_112(jax_infers_group_112):
    """The rows GEMV's arithmetic over the padded digits equals the JAX
    decode kernel (interpret mode) at group 112, f32 within 1e-4 (the order
    of f32 sums over groups and digits)."""
    rng = np.random.default_rng(95)
    w = (0.05 * rng.standard_normal((448, 384))).astype(np.float32)
    q = jquant.quantize_w4(jnp.asarray(w), 112)
    jp, js = np.asarray(q["packed"]), np.asarray(q["scales"])
    t = weights.from_jax_params({"packed": jp, "scales": js}, device="cpu")
    x = _bf16_np(rng, (9, 448))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jp, js))
    got = tquant._w4_rows_ref(torch.from_numpy(x), t["packed"], t["scales"])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [1, 2, 8, 17, 24])
def test_k1_plain_matches_jax_decode_kernel_at_group_112(jax_infers_group_112, m):
    """K1's plain version (`_w4_gemv_ref`, what both of K1's forms are held
    to on the card) equals the JAX decode kernel (interpret mode) at group
    112, flat and stacked (layer 1), f32 within 1e-4 (the order of f32 sums
    over groups)."""
    rng = np.random.default_rng(97 + m)
    w = (0.05 * rng.standard_normal((2, 448, 384))).astype(np.float32)
    q = jquant.quantize_w4(jnp.asarray(w), 112)
    jp, js = np.asarray(q["packed"]), np.asarray(q["scales"])
    t = weights.from_jax_params({"packed": jp, "scales": js}, device="cpu")
    x = _bf16_np(rng, (m, 448))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jp, js,
                                              layer_index=jnp.asarray(1, jnp.int32)))
    got = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"], t["scales"], layer_index=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    flat_want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jp[0], js[0]))
    flat = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"][0], t["scales"][0])
    np.testing.assert_allclose(flat.numpy(), flat_want, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# The plain K3-K6 against the JAX package: groups of 112, heads of 64
# --------------------------------------------------------------------------

D, INTER, HQ, HKV, L = 448, 448, 7, 1, 2
HD = 64


@pytest.fixture
def jax_infers_group_112(monkeypatch):
    """The JAX package's `_tiled_meta` with the quantizer's rule for the
    shapes its fixed candidates miss (group 112 here)."""
    orig = jquant._tiled_meta

    def tiled_meta(packed, scales):
        try:
            return orig(packed, scales)
        except ValueError:
            *_, nj, half, bout = packed.shape
            gs = tquant.group_for(half)
            ngh = half // gs
            assert scales.shape[-2] in (2 * ngh, jquant.scale_rows(ngh))
            return half, bout, nj, ngh, gs, 2 * half, nj * bout

    monkeypatch.setattr(jquant, "_tiled_meta", tiled_meta)
    monkeypatch.setattr(jfused, "_tiled_meta", tiled_meta)


def _slots(seed):
    cfg = jqwen2.LLMConfig(vocab_size=64, hidden_size=D, intermediate_size=INTER,
                           num_hidden_layers=L, num_attention_heads=HQ,
                           num_key_value_heads=HKV, head_dim=HD, dtype="float32")
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), cfg))
    p = jax.tree.map(
        lambda s: (0.02 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    layers = p["layers"]
    for n in ("input_layernorm", "post_attention_layernorm"):
        layers[n]["scale"] = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
    layers["q_proj"]["bias"] = (0.02 * rng.standard_normal((L, HQ * HD))).astype(np.float32)
    q = jax.tree.map(np.asarray, jquant.quantize_llm_params(p, fuse=True, cfg=cfg))
    lay = q["layers"]
    slots = [lay[n] for n in ("o_proj", "gate_up_proj", "down_proj", "qkv_proj")]
    groups = [jquant._tiled_meta(s["packed"], s["scales"])[4] for s in slots]
    return (slots, lay["post_attention_layernorm"]["scale"], lay["input_layernorm"]["scale"],
            rng, groups)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


def test_width_takes_group_112_and_heads_of_64(jax_infers_group_112):
    """The width of these tests: D = 448 and I = 448 take groups of 112 (o,
    from 8 padded heads of 64, takes 128)."""
    assert _slots(1)[4] == [128, 112, 112, 112]


@pytest.mark.parametrize("s_len,fill,layer", [(64, 40, 0), (256, 200, 1)])
def test_fused_layer_plain_matches_jax_at_group_112(jax_infers_group_112, s_len, fill, layer):
    """K3's plain version (h_new, qkv_{l+1}) within TOL of JAX's fused_layer
    at groups of 112 and heads of 64."""
    slots, gpost, gin, rng, _ = _slots(20 + s_len)
    q32 = (HD ** -0.5 * rng.standard_normal((HKV, 8, HD))).astype(np.float32)
    q32[:, HQ // HKV:] = 0.0
    q32 = q32.reshape(HKV * 8, HD).astype(jnp.bfloat16)
    kc = rng.standard_normal((L, 1, s_len, HKV * HD)).astype(np.float32)
    vc = rng.standard_normal((L, 1, s_len, HKV * HD)).astype(np.float32)
    mask = np.where(np.arange(s_len) <= fill, 0.0, -1e30).astype(np.float32)[None]
    h = np.ascontiguousarray(
        np.broadcast_to(rng.standard_normal((1, D)).astype(np.float32), (8, D)))
    jh, jqkv = jfused.fused_layer(
        jnp.asarray(q32), jnp.asarray(mask), jnp.asarray(h), jnp.asarray(layer, jnp.int32),
        jnp.asarray(kc), jnp.asarray(vc), *slots, jnp.asarray(gpost), jnp.asarray(gin),
        hkv=HKV, hd=HD, fill=jnp.asarray(fill, jnp.int32))
    t = weights.from_jax_params(dict(q32=q32, mask=mask, h=h, kc=kc, vc=vc, slots=slots,
                                     gpost=gpost, gin=gin), device="cpu")
    th, tqkv = tfused.fused_layer(
        t["q32"], t["mask"], t["h"], layer, t["kc"], t["vc"], *t["slots"], t["gpost"],
        t["gin"], hkv=HKV, hd=HD, fill=fill, num_q_heads=HQ)
    assert th.shape == (8, D) and tqkv.shape == (8, (HQ + 2 * HKV) * HD)
    _close(th, jh)
    _close(tqkv, jqkv)


def test_fused_layer_batched_plain_matches_jax_at_group_112(jax_infers_group_112):
    """K6's plain version at B = 3, staggered cursors, groups of 112, heads
    of 64: (h_new, qkv_{l+1}) within TOL."""
    b, s_len, layer = 3, 128, 0
    slots, gpost, gin, rng, _ = _slots(31)
    q32 = (HD ** -0.5 * rng.standard_normal((b, HKV, 8, HD))).astype(np.float32)
    q32[:, :, HQ // HKV:] = 0.0
    q32 = q32.reshape(b, HKV * 8, HD).astype(jnp.bfloat16)
    kc = rng.standard_normal((L, b, s_len, HKV * HD)).astype(np.float32).astype(jnp.bfloat16)
    vc = rng.standard_normal((L, b, s_len, HKV * HD)).astype(np.float32).astype(jnp.bfloat16)
    fill = np.array([20, s_len - 1, 77], np.int32)
    mask = np.where(np.arange(s_len)[None] <= fill[:, None], 0.0, -1e30).astype(np.float32)
    h = rng.standard_normal((b, D)).astype(np.float32)
    jh, jqkv = jfused.fused_layer_batched(
        jnp.asarray(q32), jnp.asarray(mask), jnp.asarray(h), jnp.asarray(layer, jnp.int32),
        jnp.asarray(kc), jnp.asarray(vc), *slots, jnp.asarray(gpost), jnp.asarray(gin),
        hkv=HKV, hd=HD, fill=jnp.asarray(fill))
    t = weights.from_jax_params(dict(q32=q32, mask=mask, h=h, kc=kc, vc=vc, slots=slots,
                                     gpost=gpost, gin=gin), device="cpu")
    th, tqkv = tfused.fused_layer_batched(
        t["q32"], t["mask"], t["h"], layer, t["kc"], t["vc"], *t["slots"], t["gpost"],
        t["gin"], hkv=HKV, hd=HD, fill=fill.tolist(), num_q_heads=HQ)
    _close(th, jh)
    _close(tqkv, jqkv)


@pytest.mark.parametrize("layer", [0, 1])
def test_fused_o_gateup_and_down_qkv_plain_match_jax_at_group_112(jax_infers_group_112,
                                                                   layer):
    """K4 then K5 at m = 20 rows (the route of 17..32), groups of 112 on
    gate_up, down and qkv: each output within TOL of JAX's, h_new in h's
    dtype. Layer 1 is the last: K5 streams its own qkv again."""
    slots, gpost, gin, rng, _ = _slots(41 + layer)
    o, gu_slot, down, qkv = slots
    m = 20
    attn = rng.standard_normal((m, HKV * 8 * HD)).astype(np.float32)
    attn.reshape(m, HKV, 8, HD)[:, :, HQ // HKV:] = 0.0
    attn = attn.astype(jnp.bfloat16)
    h = rng.standard_normal((m, D)).astype(np.float32).astype(jnp.bfloat16)
    jh, jgu = jfused.fused_o_gateup(jnp.asarray(attn), jnp.asarray(h),
                                    jnp.asarray(layer, jnp.int32), o, gu_slot,
                                    jnp.asarray(gpost))
    jh2, jqkv = jfused.fused_down_qkv(jgu, jh, jnp.asarray(layer, jnp.int32), down, qkv,
                                      jnp.asarray(gin))
    t = weights.from_jax_params(dict(attn=attn, h=h, slots=slots, gpost=gpost, gin=gin),
                                device="cpu")
    to, tgu, tdown, tqkv_slot = t["slots"]
    th, tgu_out = tfused.fused_o_gateup(t["attn"], t["h"], layer, to, tgu, t["gpost"])
    assert th.dtype == torch.bfloat16 and tgu_out.shape == (m, 2 * INTER)
    _close(th, jh)
    _close(tgu_out, jgu)
    th2, tqkv = tfused.fused_down_qkv(tgu_out, th, layer, tdown, tqkv_slot, t["gin"])
    assert th2.dtype == torch.bfloat16 and tqkv.shape == (m, (HQ + 2 * HKV) * HD)
    _close(th2, jh2)
    _close(tqkv, jqkv)
