"""Parity of the port's Qwen2 decoder (`vila_tpu_torch.models.qwen2`) with
the JAX package on the CPU.

Parameters are drawn with numpy from a seed in the JAX package's tree
layout and handed to both sides; W4 slots come from the JAX quantizer and
reach the port through `utils.weights.from_jax_params`, so both run the
same bytes. The JAX side runs its Pallas kernels as its own tests do off a
TPU (interpret mode, or the fused layer's reference branch); the port runs
the plain versions its kernel wrappers take for CPU tensors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GQA = {
    # 2:1 grouping; prompt of 40 tokens prefills through the W4 GEMM (K2)
    "gqa2": (dict(hidden_size=256, num_attention_heads=4, num_key_value_heads=2), 40),
    # 7:1 grouping and head_dim 128 as in Qwen2-7B; a 6-token prompt
    # prefills through the W4 GEMV (K1)
    "gqa7": (dict(hidden_size=1792, num_attention_heads=14, num_key_value_heads=2), 6),
}


def _cfg(**kw):
    base = dict(vocab_size=96, intermediate_size=512, num_hidden_layers=2,
                dtype="float32", tie_word_embeddings=False)
    base.update(kw)
    return jqwen2.LLMConfig(**base)


def port_cfg(jcfg):
    """The port's LLMConfig with the same fields as a JAX one."""
    return tqwen2.LLMConfig(**{
        f.name: getattr(jcfg, f.name) for f in dataclasses.fields(tqwen2.LLMConfig)
    })


def numpy_params(jcfg, seed):
    """The JAX package's parameter tree, drawn with numpy: norm scales near
    1, every other leaf (kernels, biases, embeddings) normal(0.02)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), jcfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if "scale" in jax.tree_util.keystr(path):
            return 1.0 + 0.1 * x
        return 0.02 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_steps(jcfg, jparams, prompt, max_len=64):
    cache = jqwen2.init_cache(jcfg, batch=1, max_len=max_len)
    logits, cache = jqwen2.forward(jparams, jcfg, input_ids=jnp.asarray(prompt),
                                   cache=cache)
    first = np.asarray(logits[0, -1], np.float32)
    tok = int(np.argmax(first))
    logits, _ = jqwen2.forward(jparams, jcfg, input_ids=jnp.asarray([[tok]]), cache=cache)
    return first, np.asarray(logits[0, -1], np.float32)


def _port_steps(tcfg, tparams, prompt, max_len=64):
    cache = tqwen2.init_cache(tcfg, batch=1, max_len=max_len, device="cpu")
    logits, cache = tqwen2.forward(tparams, tcfg, input_ids=torch.as_tensor(prompt),
                                   cache=cache)
    first = logits[0, -1].float().numpy()
    tok = int(np.argmax(first))
    logits, cache = tqwen2.forward(tparams, tcfg, input_ids=torch.tensor([[tok]]),
                                   cache=cache)
    assert cache["fill"] == prompt.shape[1] + 1
    return first, logits[0, -1].float().numpy()


def test_forward_without_cache_f32():
    """Unquantized f32 forward over a packed batch (segment ids): the plain
    path, 1e-4 (f32 summation order)."""
    jcfg = _cfg(**GQA["gqa7"][0])
    p = numpy_params(jcfg, 0)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    seg = np.asarray([[1] * 7 + [2] * 5, [1] * 12], np.int32)
    want, _ = jqwen2.forward(p, jcfg, input_ids=jnp.asarray(ids),
                             segment_ids=jnp.asarray(seg))
    got, _ = tqwen2.forward(weights.from_jax_params(p, device="cpu"), port_cfg(jcfg),
                            input_ids=torch.as_tensor(ids),
                            segment_ids=torch.as_tensor(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(GQA))
def test_w4_prefill_and_mega_decode_step(name, monkeypatch):
    """W4 fused slots with the GQA-padded o layout: prefill with a cache,
    then one decode step through the mega path (`fused_layer`) on both
    sides. Equal argmax; logits within 2e-2 (bf16 activations into the W4
    kernels, int8-digit rounding of the fused layer's rows)."""
    dims, prompt_len = GQA[name]
    jcfg = _cfg(**dims)
    p = numpy_params(jcfg, 2)
    jq = jquant.quantize_llm_params(p, fuse=True, cfg=jcfg)
    tq = weights.from_jax_params(jax.tree.map(np.asarray, jq), cfg=port_cfg(jcfg),
                                 device="cpu")
    calls = []
    real = tfused.fused_layer
    monkeypatch.setattr(tfused, "fused_layer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (1, prompt_len)).astype(np.int32)
    want = _jax_steps(jcfg, jq, prompt)
    got = _port_steps(port_cfg(jcfg), tq, prompt)
    assert len(calls) == jcfg.num_hidden_layers  # the decode step took K3
    for g, w in zip(got, want):
        assert np.argmax(g) == np.argmax(w)
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=0)


def test_w4_per_op_decode_step(monkeypatch):
    """With the fused decode gated off (VILA_TPU_NO_FUSED_DECODE) both sides
    decode layer by layer through the W4 GEMV; same tolerance."""
    monkeypatch.setenv("VILA_TPU_NO_FUSED_DECODE", "1")
    jcfg = _cfg(**GQA["gqa2"][0])
    p = numpy_params(jcfg, 4)
    jq = jquant.quantize_llm_params(p, fuse=True, cfg=jcfg)
    tq = weights.from_jax_params(jax.tree.map(np.asarray, jq), device="cpu")
    monkeypatch.setattr(tfused, "fused_layer", None)  # must not be reached
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, (1, 9)).astype(np.int32)
    for g, w in zip(_port_steps(port_cfg(jcfg), tq, prompt), _jax_steps(jcfg, jq, prompt)):
        assert np.argmax(g) == np.argmax(w)
        np.testing.assert_allclose(g, w, atol=2e-2, rtol=0)
