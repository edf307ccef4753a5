"""The port's context extension (`vila_tpu_torch.train.context_extend`)
against the JAX package's on the CPU: `extend_llm`'s losses and merged
weights from the same initial LoRA factors on one process and, sequence
parallel, in gloo processes at world sizes 2 (ring sp 2, zigzag) and 4
(hybrid sp 2 x su 2), all against JAX's `extend_llm` on one device (run
once); the chunked loader bit for bit. Tolerances (float32): losses rtol 1e-4 (three AdamW
steps, remat and the chunked cross entropy); merged kernels atol 1e-6 /
rtol 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.train import context_extend as jce
from vila_tpu.train import lora as jlora
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.train import context_extend as tce
from vila_tpu_torch.utils import weights

LOSS_RTOL = 1e-4
MERGED_TOL = dict(atol=1e-6, rtol=1e-4)


def cfg():
    return jqwen2.LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                            dtype="float32", max_position_embeddings=64)


def params():
    return jax.tree.map(np.asarray, jqwen2.init_params(jax.random.PRNGKey(0), cfg()))


def eargs(**kw):
    return dict(dict(target_context=256, rope_theta=1e5, lora_rank=4, steps=3, seq_len=64,
                     learning_rate=1e-3), **kw)


def batches():
    stream = np.random.default_rng(0).integers(2, 64, 4096).astype(np.int32)
    return list(jce.chunk_text_dataset(stream, seq_len=64, batch=2))[:3]


def jax_lora():
    """The factors JAX's extend_llm draws (init_lora at PRNGKey(0))."""
    lcfg = jlora.LoRAConfig(rank=4, alpha=32.0)
    return jax.tree.map(np.asarray, jlora.init_lora(jax.random.PRNGKey(0),
                                                    jax.tree.map(jnp.asarray, params()), lcfg))


@functools.lru_cache(maxsize=None)
def jax_extend():
    merged, _, losses = jce.extend_llm(jax.tree.map(jnp.asarray, params()), cfg(), batches(),
                                       jce.ContextExtendArgs(**eargs()))
    return losses, np.asarray(merged["layers"]["q_proj"]["kernel"])


MESHES = [("sp2", 2, dict(sp=2)), ("sp2-su2", 4, dict(sp=2, su=2))]


@pytest.fixture(scope="module")
def port():
    out = {}
    for name, world, axes in MESHES:
        call = ("extend", dict(mesh_axes=axes, llm=dh.config_fields(cfg()), params=params(),
                               lora=jax_lora(), batches=batches(), eargs=eargs(**axes)))
        ranks = dh.spawn([call], world)
        for r in ranks[1:]:
            assert r[0][0] == ranks[0][0][0]
        out[name] = ranks[0][0]
    return out


def test_extend_llm_matches_jax_on_one_process():
    tcfg = tqwen2.LLMConfig(**dh.config_fields(cfg()))
    merged, ext_cfg, losses = tce.extend_llm(
        weights.to_torch_tree(params(), torch.device("cpu")), tcfg, batches(),
        tce.ContextExtendArgs(**eargs()),
        lora=weights.to_torch_tree(jax_lora(), torch.device("cpu")))
    want_losses, want_q = jax_extend()
    assert ext_cfg.rope_theta == 1e5 and ext_cfg.max_position_embeddings == 256
    assert ext_cfg.remat is True
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(merged["layers"]["q_proj"]["kernel"].numpy(), want_q,
                               **MERGED_TOL)
    assert np.abs(want_q - params()["layers"]["q_proj"]["kernel"]).max() > 0


@pytest.mark.parametrize("name,world,axes", MESHES, ids=[m[0] for m in MESHES])
def test_extend_llm_sequence_parallel_matches_jax(name, world, axes, port):
    losses, merged_q = port[name]
    want_losses, want_q = jax_extend()
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(merged_q, want_q, **MERGED_TOL)


@pytest.mark.parametrize("n,seq,batch", [(100, 16, 2), (4096, 64, 1), (50, 7, 3)])
def test_chunk_text_dataset_matches_jax(n, seq, batch):
    stream = np.arange(n, dtype=np.int32) * 3 + 1
    got = list(tce.chunk_text_dataset(stream, seq_len=seq, batch=batch))
    want = list(jce.chunk_text_dataset(stream, seq_len=seq, batch=batch))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
