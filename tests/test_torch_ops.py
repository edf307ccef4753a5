"""Parity of the port's plain ops (`vila_tpu_torch.ops.{norms,rope,
attention}`) with the JAX package on the CPU, float32, inputs drawn with
numpy from a seed; and the port's `init_params` trees against the JAX
package's (same keys, shapes and dtypes, so `from_jax_params` trees and
the port's own drop into the same code)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.ops import attention as jattn
from vila_tpu.ops import norms as jnorms
from vila_tpu.ops import rope as jrope
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.ops import attention as tattn
from vila_tpu_torch.ops import norms as tnorms
from vila_tpu_torch.ops import rope as trope
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-5, atol=1e-5)  # f32 summation order


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x, g, b = _np(rng, 3, 5, 64), 1 + _np(rng, 64), _np(rng, 64)
    np.testing.assert_allclose(
        tnorms.rms_norm(torch.as_tensor(x), torch.as_tensor(g), 1e-6).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6)), **TOL)
    np.testing.assert_allclose(
        tnorms.layer_norm(torch.as_tensor(x), torch.as_tensor(g), torch.as_tensor(b),
                          1e-5).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)),
        **TOL)


@pytest.mark.parametrize("scaling", [1.0, 4.0])
def test_rope_matches_jax(scaling):
    rng = np.random.default_rng(1)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    x = _np(rng, 2, 7, 3, 64)
    jc, js = jrope.rope_cos_sin(jnp.asarray(pos), 64, 1e6, scaling)
    tc, ts = trope.rope_cos_sin(torch.as_tensor(pos), 64, 1e6, scaling)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(
        trope.apply_rope(torch.as_tensor(x), tc, ts).numpy(),
        np.asarray(jrope.apply_rope(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-4)


def _attn_case(rng, b=2, sq=6, skv=40, hq=6, hkv=2, d=32):
    q, k, v = _np(rng, b, sq, hq, d), _np(rng, b, skv, hkv, d), _np(rng, b, skv, hkv, d)
    qpos = (np.arange(sq)[None] + np.asarray([[30], [20]])).astype(np.int32)
    kvpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    qseg = np.ones((b, sq), np.int32)
    kvseg = (rng.random((b, skv)) < 0.8).astype(np.int32)  # some slots invalid
    kvlen = np.asarray([35, 28], np.int32)
    return q, k, v, dict(q_positions=qpos, kv_positions=kvpos, q_segment_ids=qseg,
                         kv_segment_ids=kvseg, kv_valid_len=kvlen)


@pytest.mark.parametrize("impl", ["xla", "blocked"])
@pytest.mark.parametrize("masks", ["causal", "cache", "segments"])
def test_attention_matches_jax(impl, masks):
    """Each path of `multi_head_attention` under the mask kinds of
    `_build_mask`: plain causal, a decode cache (q_positions, kv validity,
    kv_valid_len), and packed segments without causality."""
    rng = np.random.default_rng(2)
    q, k, v, kw = _attn_case(rng)
    causal = masks != "segments"
    if masks == "causal":
        k, v, kw = k[:, :6], v[:, :6], {}
    elif masks == "segments":
        k, v = k[:, :6], v[:, :6]
        seg = np.asarray([[1, 1, 1, 2, 2, 2], [1, 1, 1, 1, 1, 2]], np.int32)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg)
    extra = {"block": 16} if impl == "blocked" else {}
    want = getattr(jattn, f"attention_{impl}")(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        **{n: jnp.asarray(a) for n, a in kw.items()}, **extra)
    got = getattr(tattn, f"attention_{impl}")(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), causal=causal,
        **{n: torch.as_tensor(a) for n, a in kw.items()}, **extra)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dispatch_picks_blocked_for_large_scores():
    rng = np.random.default_rng(3)
    q, k, v = _np(rng, 1, 256, 2, 16), _np(rng, 1, 16384, 2, 16), _np(rng, 1, 16384, 2, 16)
    q_, k_, v_ = (torch.as_tensor(a) for a in (q, k, v))
    torch.testing.assert_close(
        tattn.multi_head_attention(q_, k_, v_, causal=False),
        tattn.attention_blocked(q_, k_, v_, causal=False), rtol=0, atol=0)
    with pytest.raises(ValueError):
        tattn.multi_head_attention(q_, k_, v_, impl="pallas")


def test_init_params_trees_match_jax():
    llm = dict(vocab_size=50, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, tie_word_embeddings=False)
    vis = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=4, image_size=56, patch_size=14)
    proj = dict(projector_type="mlp_downsample", mm_hidden_size=48, hidden_size=64)
    jcfg = jvlm.VLMConfig(llm=jqwen2.LLMConfig(**llm), vision=jsiglip.SigLIPConfig(**vis),
                          projector=jproj.ProjectorConfig(**proj))
    tcfg = tvlm.VLMConfig(llm=tqwen2.LLMConfig(**llm), vision=tsiglip.SigLIPConfig(**vis),
                          projector=tproj.ProjectorConfig(**proj))
    want = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), jcfg))
    got = tvlm.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(weights.to_numpy_tree(got))[0])
    assert set(flat_g) == {p for p, _ in flat_w}
    for path, leaf in flat_w:
        assert flat_g[path].shape == leaf.shape, path
        assert flat_g[path].dtype == leaf.dtype, path
