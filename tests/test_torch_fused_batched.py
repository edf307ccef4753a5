"""Parity of the port's batched fused decode layers with the JAX package's,
on the CPU: K6 `fused_layer_batched` (one whole layer for 1 < B <= 16) and
the two-kernel layer K4 `fused_o_gateup` + K5 `fused_down_qkv`.

The JAX side takes its reference branches off a TPU (per-row attention and
the W4 decode kernel in interpret mode), as `tests/test_fused_interpret.py`
runs them; the port runs the plain versions its wrappers take for CPU
tensors. Inputs are drawn with numpy from a seed at the widths of
`tests/test_torch_fused_decode.py`. Tolerance 1e-2 (atol and rtol), as
there: the products take bf16 activations through the int8-digit W4
arithmetic on both sides, but the JAX reference rounds each product to bf16
before the residual add and spreads nonzero pad-head outputs into the o
row's digit scale, where the port keeps f32 sums and zero pad heads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.ops import fused_decode as jfused
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.utils import weights

D, INTER, HQ, HKV, L = 256, 512, 4, 2, 2
HD = D // HQ
S = 128
TOL = 1e-2


def _slots(seed):
    cfg = jqwen2.LLMConfig(vocab_size=64, hidden_size=D, intermediate_size=INTER,
                           num_hidden_layers=L, num_attention_heads=HQ,
                           num_key_value_heads=HKV, dtype="float32")
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
    return (
        [lay[n] for n in ("o_proj", "gate_up_proj", "down_proj", "qkv_proj")],
        lay["post_attention_layernorm"]["scale"], lay["input_layernorm"]["scale"], rng,
    )


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("b,layer", [(3, 0), (9, 1)])
def test_fused_layer_batched_plain_matches_jax(b, layer):
    """B = 3 and B = 9 (the JAX kernel's 8- and 16-row forms), staggered
    cursors, one row at S - 1: (h_new, qkv_{l+1}) within TOL."""
    slots, gpost, gin, rng = _slots(11 + b)
    q32 = (HD ** -0.5 * rng.standard_normal((b, HKV, 8, HD))).astype(np.float32)
    q32[:, :, HQ // HKV:] = 0.0  # group padding rows, as qwen2's K6 route pads
    q32 = q32.reshape(b, HKV * 8, HD).astype(jnp.bfloat16)
    kc = rng.standard_normal((L, b, S, HKV * HD)).astype(np.float32).astype(jnp.bfloat16)
    vc = rng.standard_normal((L, b, S, HKV * HD)).astype(np.float32).astype(jnp.bfloat16)
    fill = rng.integers(0, S - 1, b).astype(np.int32)
    fill[b // 2] = S - 1
    mask = np.where(np.arange(S)[None] <= fill[:, None], 0.0, -1e30).astype(np.float32)
    h = rng.standard_normal((b, D)).astype(np.float32)
    jh, jqkv = jfused.fused_layer_batched(
        jnp.asarray(q32), jnp.asarray(mask), jnp.asarray(h), jnp.asarray(layer, jnp.int32),
        jnp.asarray(kc), jnp.asarray(vc), *slots, jnp.asarray(gpost), jnp.asarray(gin),
        hkv=HKV, hd=HD, fill=jnp.asarray(fill),
    )
    t = weights.from_jax_params(dict(q32=q32, mask=mask, h=h, kc=kc, vc=vc, slots=slots,
                                     gpost=gpost, gin=gin), device="cpu")
    th, tqkv = tfused.fused_layer_batched(
        t["q32"], t["mask"], t["h"], layer, t["kc"], t["vc"], *t["slots"],
        t["gpost"], t["gin"], hkv=HKV, hd=HD, fill=fill.tolist(), num_q_heads=HQ,
    )
    assert th.shape == (b, D) and tqkv.shape == (b, (HQ + 2 * HKV) * HD)
    _close(th, jh)
    _close(tqkv, jqkv)

    # rows past each row's live prefix never reach the result
    dead = torch.as_tensor(np.arange(S)[None] > fill[:, None])
    t["kc"][layer][dead] = float("nan")
    t["vc"][layer][dead] = float("nan")
    again = tfused.fused_layer_batched(
        t["q32"], t["mask"], t["h"], layer, t["kc"], t["vc"], *t["slots"],
        t["gpost"], t["gin"], hkv=HKV, hd=HD, fill=fill.tolist(), num_q_heads=HQ,
    )
    for g, w in zip(again, (th, tqkv)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("layer", [0, 1])
def test_fused_o_gateup_and_down_qkv_plain_match_jax(layer):
    """K4 then K5 at m = 20 rows (the two-kernel route's 17..32), bf16 h as
    on the card: each output within TOL of the JAX reference, and h_new
    handed back in h's dtype. Layer 1 is the last: K5 streams its own qkv
    again (clamped l + 1)."""
    slots, gpost, gin, rng = _slots(5 + layer)
    o, gu_slot, down, qkv = slots
    m = 20
    attn = rng.standard_normal((m, HKV * 8 * HD)).astype(np.float32)
    attn.reshape(m, HKV, 8, HD)[:, :, HQ // HKV:] = 0.0  # GQA pad lanes
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
