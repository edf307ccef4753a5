"""W8A8 vision (TinyChat's recipe: W4A16 LLM + W8A8 vision) in the port
against the JAX package on the CPU, inputs drawn with numpy from a seed:

* `quant.quantize_w8a8` gives JAX's bytes (int8 weights, f32 scales);
* `w8a8_linear`'s activations and int32 accumulators equal the ones JAX's
  `w8a8_linear` computes, and its output equals JAX's bit for bit (f32 and
  bf16; tolerance 0: both scale the exact int32 sum in the same order);
* `siglip.quantize_siglip_w8a8` + `siglip.forward` agree with JAX's at a
  tiny size (tolerance below);
* `entry.load(vision_int8=True, device="cpu")` gives the greedy transcript
  of `vila_tpu.load(vision_int8=True)`;
* the card's int8 product never takes the plain version.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
import vila_tpu  # noqa: E402
from gen_goldens import FLAVORS  # noqa: E402
from vila_tpu.inference import generate as jgen  # noqa: E402
from vila_tpu.models import siglip as jsiglip  # noqa: E402
from vila_tpu.ops import quant as jquant  # noqa: E402
from vila_tpu_torch import entry  # noqa: E402
from vila_tpu_torch.inference import generate as tgen  # noqa: E402
from vila_tpu_torch.models import siglip as tsiglip  # noqa: E402
from vila_tpu_torch.ops import quant as tquant  # noqa: E402
from vila_tpu_torch.utils import weights  # noqa: E402

# The tower end to end: f32 attention and norms sum in another order on
# each side, and an activation that lands within that difference of an
# int8 rounding boundary takes the other digit, which attention then
# spreads over every token; relative to max |feature| (this draw: 1.6e-3,
# against 3.2e-3 between the W8A8 and the f32 tower).
TOWER_RTOL = 2e-3


def _jax_acc(x, w8):
    """JAX's `w8a8_linear` up to its int32 sum (the same steps)."""
    xf = jnp.asarray(x, jnp.float32)
    a = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8)
    xq = jnp.clip(jnp.round(xf * (127.0 / a)), -127, 127).astype(jnp.int8)
    acc = jax.lax.dot_general(xq, w8, (((xq.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(a), np.asarray(acc)


@pytest.mark.parametrize("shape", [(96, 40), (3, 48, 64)])
def test_quantize_w8a8_bytes_identical(shape):
    w = 0.05 * np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero output channel takes the 1e-8 floor
    want = jquant.quantize_w8a8(jnp.asarray(w))
    got = tquant.quantize_w8a8(torch.from_numpy(w))
    assert got["w8"].dtype == torch.int8 and got["w_scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w8"].numpy(), np.asarray(want["w8"]))
    np.testing.assert_array_equal(got["w_scale"].numpy(), np.asarray(want["w_scale"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 37, 64)) * rng.uniform(0.1, 4, (2, 37, 1))).astype(np.float32)
    w = 0.05 * rng.standard_normal((64, 48)).astype(np.float32)
    bias = 0.1 * rng.standard_normal(48).astype(np.float32)
    jp = dict(jquant.quantize_w8a8(jnp.asarray(w)), bias=jnp.asarray(bias))
    tp = dict(tquant.quantize_w8a8(torch.from_numpy(w)), bias=torch.from_numpy(bias))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))

    want_xq, want_a, want_acc = _jax_acc(jx, jp["w8"])
    xq, a = tquant.w8a8_activations(tx)
    np.testing.assert_array_equal(xq.numpy(), want_xq)
    np.testing.assert_array_equal(a.numpy(), want_a)
    acc = tquant.int8_matmul(xq.reshape(-1, 64), tp["w8"]).reshape(2, 37, 48)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), want_acc)

    want = np.asarray(jquant.w8a8_linear(jx, jp, jnp.dtype(dtype)).astype(jnp.float32))
    got = tquant.w8a8_linear(tx, tp, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


def _same(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def test_quantized_tower_matches_jax():
    jcfg = jsiglip.SigLIPConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                                num_attention_heads=4, image_size=56, patch_size=14)
    rng = np.random.default_rng(2)
    shapes = jax.eval_shape(lambda: jsiglip.init_params(jax.random.PRNGKey(0), jcfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.05 * x

    p = jax.tree_util.tree_map_with_path(draw, shapes)
    pixels = rng.integers(0, 256, (2, 56, 56, 3), dtype=np.uint8)
    jq = jsiglip.quantize_siglip_w8a8(jax.tree.map(jnp.asarray, p))
    tq = tsiglip.quantize_siglip_w8a8(weights.from_jax_params(p, device="cpu"))
    for name in ("q_proj", "fc1", "fc2"):
        np.testing.assert_array_equal(tq["layers"][name]["w8"].numpy(),
                                      np.asarray(jq["layers"][name]["w8"]))
    assert "kernel" not in tq["layers"]["out_proj"] and "bias" in tq["layers"]["out_proj"]
    assert tq["patch_embedding"]["kernel"].dtype == torch.float32

    want = np.asarray(jsiglip.forward(jq, jcfg, jnp.asarray(pixels)))
    got = tsiglip.forward(tq, _same(tsiglip.SigLIPConfig, jcfg), torch.from_numpy(pixels))
    err = np.abs(got.numpy() - want).max()
    assert err <= TOWER_RTOL * np.abs(want).max(), err
    bf = tsiglip.forward(weights.from_jax_params(p, device="cpu"),
                         _same(tsiglip.SigLIPConfig, jcfg), torch.from_numpy(pixels))
    assert not torch.equal(bf, got)  # the W8 slots are the ones taken


def test_load_vision_int8_gives_the_jax_transcript(tmp_path):
    d = str(tmp_path / "base")
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    jengine = vila_tpu.load(d, vision_int8=True)
    tengine = entry.load(d, device="cpu", vision_int8=True)
    lp = tengine.params["vision_tower"]["layers"]
    assert lp["q_proj"]["w8"].dtype == torch.int8 and "kernel" not in lp["fc2"]
    image = np.random.default_rng(3).integers(0, 255, (50, 50, 3), np.uint8)
    prompt = [image, "hi"]
    jin, tin = jengine.prepare_inputs(list(prompt)), tengine.prepare_inputs(list(prompt))
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    want = jengine.generate_ids(jin, jgen.GenerationConfig(max_new_tokens=8,
                                                           stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(max_new_tokens=8,
                                                          stop_token_ids=(-1,)))
    assert len(want) == 8 and got == want


def test_int8_matmul_never_falls_back():
    """A tensor off the CPU goes to the card's product, which refuses it
    here; shapes the card cannot take raise before any launch."""
    xq = torch.empty((32, 64), dtype=torch.int8, device="meta")
    w8 = torch.empty((64, 48), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tquant.int8_matmul(xq, w8)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tquant.w8a8_linear(torch.empty((32, 64), device="meta"),
                           {"w8": w8, "w_scale": torch.empty(48, device="meta")},
                           torch.bfloat16)
