"""Parity of the port's fused bs=1 decode layer (kernel K3,
`vila_tpu_torch.ops.fused_decode.fused_layer`) with the JAX package's
`fused_layer` on the CPU.

The JAX side takes its reference branch off a TPU (explicit attention plus
the W4 decode kernel in interpret mode), as `tests/test_fused_interpret.py`
runs it; the port runs the plain version of its five launches. Inputs are
drawn with numpy from a seed at the widths of `test_fused_interpret.py`'s
`_tiny_cfg`.
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

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

D, INTER, HQ, HKV, L = 256, 512, 4, 2, 2
HD = D // HQ


def _inputs(seed, s_len, fill):
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
    q = jax.tree.map(np.asarray, jquant.quantize_llm_params(p, fuse=True, cfg=cfg))
    q32 = (HD ** -0.5 * rng.standard_normal((HKV, 8, HD))).astype(np.float32)
    q32[:, HQ // HKV:] = 0.0  # group padding rows, as qwen2's mega path pads
    q32 = q32.reshape(HKV * 8, HD).astype(jnp.bfloat16)
    kc = rng.standard_normal((L, 1, s_len, HKV * HD)).astype(np.float32)
    vc = rng.standard_normal((L, 1, s_len, HKV * HD)).astype(np.float32)
    mask = np.where(np.arange(s_len) <= fill, 0.0, -1e30).astype(np.float32)[None]
    h = np.broadcast_to(rng.standard_normal((1, D)).astype(np.float32), (8, D))
    return q, q32, mask, np.ascontiguousarray(h), kc, vc


@pytest.mark.parametrize("s_len,fill,layer", [(32, 20, 0), (512, 300, 1)])
def test_fused_layer_plain_matches_jax(s_len, fill, layer):
    """(h_new, qkv_{l+1}) within 1e-2: the JAX reference spreads the heads
    over 8 rows (one int8-digit scale per row), the port feeds one row."""
    q, q32, mask, h, kc, vc = _inputs(7 + s_len, s_len, fill)
    lay = q["layers"]
    slots = [lay[n] for n in ("o_proj", "gate_up_proj", "down_proj", "qkv_proj")]
    gpost = lay["post_attention_layernorm"]["scale"]
    gin = lay["input_layernorm"]["scale"]
    jh, jqkv = jfused.fused_layer(
        jnp.asarray(q32), jnp.asarray(mask), jnp.asarray(h),
        jnp.asarray(layer, jnp.int32), jnp.asarray(kc), jnp.asarray(vc),
        *slots, jnp.asarray(gpost), jnp.asarray(gin), hkv=HKV, hd=HD,
        fill=jnp.asarray(fill, jnp.int32),
    )
    t = weights.from_jax_params(
        dict(q32=q32, mask=mask, h=h, kc=kc, vc=vc, slots=slots, gpost=gpost,
             gin=gin), device="cpu")
    th, tqkv = tfused.fused_layer(
        t["q32"], t["mask"], t["h"], layer, t["kc"], t["vc"], *t["slots"],
        t["gpost"], t["gin"], hkv=HKV, hd=HD, fill=fill, num_q_heads=HQ,
    )
    assert th.shape == (8, D) and tqkv.shape == (8, (HQ + 2 * HKV) * HD)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32),
                               atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(tqkv.float().numpy(), np.asarray(jqkv, np.float32),
                               atol=1e-2, rtol=1e-2)


def test_fused_layer_reads_only_the_live_prefix():
    """Cache rows past `fill` never reach the result: garbage there (NaN)
    changes nothing, as the TPU kernel's live-block skipping guarantees."""
    q, q32, mask, h, kc, vc = _inputs(3, 512, 100)
    lay = q["layers"]
    slots = [lay[n] for n in ("o_proj", "gate_up_proj", "down_proj", "qkv_proj")]
    t = weights.from_jax_params(
        dict(q32=q32, mask=mask, h=h, kc=kc, vc=vc, slots=slots,
             gpost=lay["post_attention_layernorm"]["scale"],
             gin=lay["input_layernorm"]["scale"]), device="cpu")

    def run():
        return tfused.fused_layer(
            t["q32"], t["mask"], t["h"], 0, t["kc"], t["vc"], *t["slots"],
            t["gpost"], t["gin"], hkv=HKV, hd=HD, fill=100, num_q_heads=HQ)

    want = run()
    t["kc"][:, :, 101:] = float("nan")
    t["vc"][:, :, 101:] = float("nan")
    for g, w in zip(run(), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
