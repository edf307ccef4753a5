"""Parity of the port's vision tower, projector and fused multimodal
forward (`vila_tpu_torch.models.{siglip,projector,vlm}`) with the JAX
package, in float32 on the CPU. Parameters and inputs are drawn with numpy
from a seed in the JAX package's tree layout and handed to both sides."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = dict(rtol=1e-4, atol=1e-4)  # f32 summation order


def _same(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _vcfg():
    return jsiglip.SigLIPConfig(hidden_size=48, intermediate_size=96,
                                num_hidden_layers=3, num_attention_heads=4,
                                image_size=56, patch_size=14)


def _pcfg():
    return jproj.ProjectorConfig(projector_type="mlp_downsample",
                                 mm_hidden_size=48, hidden_size=64)


def _draw(init, seed):
    """A JAX init's tree with numpy-drawn leaves: LayerNorm / RMSNorm scales
    near 1, everything else normal(0.02)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0)))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.02 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pixels(seed, n=2, size=56):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


def test_siglip_forward_matches_jax():
    cfg = _vcfg()
    p = _draw(lambda k: jsiglip.init_params(k, cfg), 0)
    px = _pixels(1)
    want = jsiglip.forward(p, cfg, jnp.asarray(px))
    got = tsiglip.forward(weights.from_jax_params(p, device="cpu"),
                          _same(tsiglip.SigLIPConfig, cfg), torch.as_tensor(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_projector_mlp_downsample_matches_jax():
    """Includes an odd side (5x5 patches), where the pixel-unshuffle pads."""
    cfg = _pcfg()
    p = _draw(lambda k: jproj.init_params(k, cfg), 2)
    x = np.random.default_rng(3).standard_normal((2, 25, 48)).astype(np.float32)
    want = jproj.forward(p, cfg, jnp.asarray(x))
    got = tproj.forward(weights.from_jax_params(p, device="cpu"),
                        _same(tproj.ProjectorConfig, cfg), torch.as_tensor(x))
    assert got.shape == (2, 9, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_forward_matches_jax():
    """Vision encode, media splice (with an out-of-range position that is
    dropped) and the LLM, cache-free."""
    llm = jqwen2.LLMConfig(vocab_size=80, hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dtype="float32")
    cfg = jvlm.VLMConfig(llm=llm, vision=_vcfg(), projector=_pcfg())
    p = _draw(lambda k: jvlm.init_params(k, cfg), 4)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 80, (1, 20)).astype(np.int32)
    pos = np.concatenate([np.arange(3, 7), np.arange(10, 13), [1 << 30]]).astype(np.int32)
    px = _pixels(6)
    want, _ = jvlm.forward(jax.tree.map(jnp.asarray, p), cfg,
                           input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
                           media_positions=jnp.asarray(pos))
    tcfg = tvlm.VLMConfig(llm=_same(tqwen2.LLMConfig, llm),
                          vision=_same(tsiglip.SigLIPConfig, cfg.vision),
                          projector=_same(tproj.ProjectorConfig, cfg.projector))
    assert tcfg.tokens_per_image == cfg.tokens_per_image
    got, _ = tvlm.forward(weights.from_jax_params(p, device="cpu"), tcfg,
                          input_ids=torch.as_tensor(ids), pixel_values=torch.as_tensor(px),
                          media_positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
