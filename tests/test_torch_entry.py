"""The port's loader (`vila_tpu_torch.entry`) against the JAX package's
(`vila_tpu.entry`) on the CPU, over checkpoints that
`helpers.save_tiny_checkpoint(seed=0, ...)` writes: the `base` flavor and
`gqa8b`'s shape (7:1 GQA, qkv bias, untied lm_head; `gen_goldens.FLAVORS`).

* `build_config` equals JAX's field by field;
* `load_params(device="cpu")` equals JAX's `load_params`, in f32 and in
  bf16, bit for bit (JAX's tree through `from_jax_params`);
* checkpoints round-trip both ways: port `save` -> JAX `load_params`, and
  JAX `save` -> port `load_params`;
* `load(device="cpu")` gives the greedy transcript of `vila_tpu.load`'s
  engine on one image + prompt (f32, so no one-ulp bf16 tie can split the
  two);
* the `dynamic_s2` and `video_tsp` flavors build JAX's config (the
  projector over every S2 scale's features, the TSP pool sizes), load
  JAX's weights, and round-trip through the port's `save`;
* a tower JAX refuses raises JAX's error naming the field (the other
  towers' loading: test_torch_tower_load.py).
"""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from gen_goldens import FLAVORS  # noqa: E402
from vila_tpu import entry as jentry  # noqa: E402
from vila_tpu.inference import generate as jgen  # noqa: E402
from vila_tpu_torch import entry as tentry  # noqa: E402
from vila_tpu_torch.inference import generate as tgen  # noqa: E402
from vila_tpu_torch.utils import weights  # noqa: E402

NEW_TOKENS = 8


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    out = {}
    for name in ("base", "gqa8b"):
        d = str(tmp_path_factory.mktemp("ckpt") / name)
        helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS[name])
        out[name] = d
    return out


def _assert_same_config(tcfg, jcfg, path="cfg"):
    """Every field of the port's config equals JAX's field of that name."""
    for f in dataclasses.fields(tcfg):
        t, j = getattr(tcfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(t):
            _assert_same_config(t, j, f"{path}.{f.name}")
        else:
            assert t == j, f"{path}.{f.name}: {t!r} != {j!r}"


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    assert got.dtype == want.dtype and got.shape == want.shape, path
    assert torch.equal(got, want), path


def _jax_as_port(jparams):
    return weights.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("name", ["base", "gqa8b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_config_and_load_params_match_jax(ckpts, name, dtype):
    d = ckpts[name]
    jcfg = jentry.build_config(d, dtype=dtype)
    tcfg = tentry.build_config(d, dtype=dtype, device="cpu")
    _assert_same_config(tcfg, jcfg)
    got = tentry.load_params(d, tcfg, device="cpu")
    _assert_tree_equal(got, _jax_as_port(jentry.load_params(d, jcfg)))
    leaf = got["llm"]["layers"]["q_proj"]["kernel"]
    assert leaf.dtype == getattr(torch, dtype) and leaf.is_contiguous()
    if name == "gqa8b":
        assert (tcfg.llm.num_attention_heads, tcfg.llm.num_key_value_heads) == (14, 2)
        assert tcfg.llm.qkv_bias and not tcfg.llm.tie_word_embeddings


def test_default_dtype_follows_the_device(ckpts):
    assert tentry.build_config(ckpts["base"], device="cpu").llm.dtype == "float32"
    assert tentry.build_config(ckpts["base"], device="cuda").llm.dtype == "bfloat16"


def test_port_save_loads_in_jax(ckpts, tmp_path):
    d = ckpts["gqa8b"]
    tcfg = tentry.build_config(d, device="cpu")
    out = str(tmp_path / "port_saved")
    n = tentry.save(tentry.load_params(d, tcfg, device="cpu"), tcfg, None, out)
    assert n == sum(os.path.getsize(os.path.join(out, c, "model.safetensors"))
                    for c in tentry.COMPONENTS)
    jcfg = jentry.build_config(d)
    _assert_same_config(tentry.build_config(out, device="cpu"), jentry.build_config(out))
    back, want = jentry.load_params(out, jcfg), jentry.load_params(d, jcfg)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), np.asarray(b)),
                 back, want)


def test_jax_save_loads_in_port(ckpts, tmp_path):
    d = ckpts["base"]
    jcfg = jentry.build_config(d)
    out = str(tmp_path / "jax_saved")
    jentry.save(jentry.load_params(d, jcfg), jcfg, None, out)
    tcfg = tentry.build_config(out, device="cpu")
    _assert_same_config(tcfg, jentry.build_config(out))
    _assert_tree_equal(tentry.load_params(out, tcfg, device="cpu"),
                       tentry.load_params(d, tcfg, device="cpu"))


def test_load_gives_the_jax_engines_transcript(ckpts):
    d = ckpts["base"]
    image = np.random.default_rng(4).integers(0, 256, (200, 300, 3), dtype=np.uint8)
    prompt = [image, "What is shown here?"]
    jengine = jentry.load(d)
    tengine = tentry.load(d, device="cpu")
    assert isinstance(tengine, tgen.GenerationEngine) and tengine.device.type == "cpu"
    jin, tin = jengine.prepare_inputs(list(prompt)), tengine.prepare_inputs(list(prompt))
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    want = jengine.generate_ids(jin, jgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    assert len(want) == NEW_TOKENS and got == want


@pytest.mark.parametrize("name", ["dynamic_s2", "video_tsp"])
def test_media_flavors_build_the_jax_config(tmp_path, name):
    d = str(tmp_path / name)
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS[name])
    jcfg = jentry.build_config(d)
    tcfg = tentry.build_config(d, device="cpu")
    _assert_same_config(tcfg, jcfg)
    if name == "dynamic_s2":
        assert tcfg.image_aspect_ratio == "dynamic_s2" and tcfg.s2_scales == (56, 112)
        assert tcfg.projector.mm_hidden_size == 2 * tcfg.vision.hidden_size
    else:
        assert tcfg.video_encoder == "tsp"
        assert tcfg.tsp_pool_sizes == ((1, 1, 1), (2, 2, 2))
    params = tentry.load_params(d, tcfg, device="cpu")
    _assert_tree_equal(params, _jax_as_port(jentry.load_params(d, jcfg)))
    out = str(tmp_path / "saved")
    tentry.save(params, tcfg, None, out)
    _assert_same_config(tentry.build_config(out, device="cpu"), tcfg)
    _assert_tree_equal(tentry.load_params(out, tcfg, device="cpu"), params)


def test_unported_tower_raises_naming_the_field(tmp_path):
    """Every tower of the JAX package is ported now: a `clip_vision_model`
    tower builds JAX's config (its loading is in test_torch_tower_load.py),
    and a tower JAX refuses, a RADIO config naming a timm model of unknown
    widths, raises JAX's `ValueError` naming the field's value."""
    d = str(tmp_path / "clip")
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    path = os.path.join(d, "vision_tower", "config.json")
    with open(path) as f:
        vt = json.load(f)
    vt["model_type"] = "clip_vision_model"
    with open(path, "w") as f:
        json.dump(vt, f)
    tcfg = tentry.build_config(d, device="cpu")
    assert tcfg.vision_tower_type == "clip"
    _assert_same_config(tcfg, jentry.build_config(d))
    with open(path, "w") as f:
        json.dump({"model_type": "radio", "args": {"model": "eva02_large_patch14"}}, f)
    with pytest.raises(ValueError, match="eva02_large_patch14") as want:
        jentry.build_config(d)
    with pytest.raises(ValueError, match="eva02_large_patch14") as got:
        tentry.build_config(d, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="eva02_large_patch14"):
        tentry.load(d, device="cpu")
