"""The port's generic ViT tower (`vila_tpu_torch.models.vit`) against
`vila_tpu/models/vit.py` on the CPU, in f32, with numpy-drawn parameters
handed to both sides: every tower flavour (CLIP; InternViT with and without
qk-norm; RADIO's timm widths, cut), at `feature_layer` -2 and full depth,
`select` patch and cls_patch, uint8 and float pixels, a position-embedding
resize; `quantize_vit_w8a8` (int8 bytes and scales equal, features at the
same bar); the config parsers; the single-repo export layout
(`entry.generic_vit_state_dict`); and `from_jax_params`'s check of a
tower's optional leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu import entry as jentry
from vila_tpu.models import vit as jvit
from vila_tpu_torch import entry as tentry
from vila_tpu_torch.models import vit as tvit
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False

# f32 on both sides, sums in another order
RTOL = 1e-5

BASE = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, image_size=56, patch_size=14)
FLAVORS = {
    "clip": dict(BASE),
    "internvit_qk": dict(BASE, hidden_act="gelu", layer_scale=True, qk_norm=True,
                         pre_layernorm=False, layer_norm_eps=1e-6),
    "internvit": dict(BASE, hidden_act="gelu", layer_scale=True, pre_layernorm=False,
                      layer_norm_eps=1e-6),
    # RADIO: the timm widths' form (gelu, no pre-norm, eps 1e-6), cut
    "radio": dict(BASE, hidden_act="gelu", pre_layernorm=False, layer_norm_eps=1e-6,
                  patch_size=16, image_size=64, image_mean=(0.485, 0.456, 0.406),
                  image_std=(0.229, 0.224, 0.225)),
}


def vit_params(cfg, seed):
    """A JAX-layout tree of numpy f32 arrays with every optional leaf the
    config asks for; norms, biases and layer scales drawn, not constant."""
    rng = np.random.default_rng(seed)
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size

    def n(*shape, scale=0.05, mean=0.0):
        return (mean + scale * rng.standard_normal(shape)).astype(np.float32)

    def ln(*shape):
        return {"scale": n(*shape, scale=0.1, mean=1.0), "bias": n(*shape, scale=0.02)}

    def proj(din, dout):
        return {"kernel": n(L, din, dout), "bias": n(L, dout, scale=0.02)}

    layers = {"layer_norm1": ln(L, D), "q_proj": proj(D, D), "k_proj": proj(D, D),
              "v_proj": proj(D, D), "out_proj": proj(D, D), "layer_norm2": ln(L, D),
              "fc1": proj(D, I), "fc2": proj(I, D)}
    if cfg.layer_scale:
        layers["ls1"] = {"scale": n(L, D, scale=0.05, mean=0.1)}
        layers["ls2"] = {"scale": n(L, D, scale=0.05, mean=0.1)}
    if cfg.qk_norm:
        layers["q_norm"] = {"scale": n(L, D, scale=0.1, mean=1.0)}
        layers["k_norm"] = {"scale": n(L, D, scale=0.1, mean=1.0)}
    p = {"patch_embedding": {"kernel": n(cfg.patch_size ** 2 * 3, D)},
         "position_embedding": {"embedding": n(cfg.num_positions, D)},
         "layers": layers, "post_layernorm": ln(D)}
    if cfg.class_token:
        p["class_embedding"] = n(D)
    if cfg.pre_layernorm:
        p["pre_layernorm"] = ln(D)
    return p


def _cfgs(flavor):
    jcfg = jvit.ViTConfig(**FLAVORS[flavor])
    return jcfg, tvit.ViTConfig(**FLAVORS[flavor])


def _pixels(cfg, seed, size=None, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    size = size or cfg.image_size
    if dtype == np.uint8:
        return rng.integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    return rng.standard_normal((2, size, size, 3)).astype(np.float32)


def _both(flavor, px, seed=0, quantize=False, **kw):
    jcfg, tcfg = _cfgs(flavor)
    p = vit_params(jcfg, seed)
    jp = jax.tree.map(jnp.asarray, p)
    tp = weights.from_jax_params(p, device="cpu")
    if quantize:
        jp, tp = jvit.quantize_vit_w8a8(jp), tvit.quantize_vit_w8a8(tp)
    want = np.asarray(jvit.forward(jp, jcfg, jnp.asarray(px), **kw))
    got = tvit.forward(tp, tcfg, torch.as_tensor(px), **kw).numpy()
    return got, want, jp, tp


def _close(got, want, rtol=RTOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("flavor", list(FLAVORS))
@pytest.mark.parametrize("feature_layer", [-2, -1])
@pytest.mark.parametrize("select", ["patch", "cls_patch"])
def test_forward_matches_jax(flavor, feature_layer, select):
    cfg = _cfgs(flavor)[0]
    got, want, _, _ = _both(flavor, _pixels(cfg, 1), feature_layer=feature_layer,
                            select=select)
    n_tok = cfg.num_patches + (select == "cls_patch")
    assert got.shape == (2, n_tok, cfg.hidden_size)
    _close(got, want)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_float_pixels_and_position_resize_match_jax(flavor):
    """Normalised float pixels at another resolution: the position
    embeddings are interpolated to the new token count on both sides."""
    cfg = _cfgs(flavor)[0]
    size = cfg.image_size + cfg.patch_size
    got, want, _, _ = _both(flavor, _pixels(cfg, 2, size=size, dtype=np.float32),
                            feature_layer=1, select="cls_patch")
    assert got.shape[1] == (size // cfg.patch_size) ** 2 + 1
    _close(got, want)


def test_patch_select_drops_token_zero_without_a_class_token():
    """As the reference: "patch" drops token 0 even when there is no class
    token (the first patch goes)."""
    kw = dict(FLAVORS["radio"], class_token=False)
    jcfg, tcfg = jvit.ViTConfig(**kw), tvit.ViTConfig(**kw)
    p = vit_params(jcfg, 3)
    px = _pixels(jcfg, 3)
    want = np.asarray(jvit.forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(px)))
    got = tvit.forward(weights.from_jax_params(p, device="cpu"), tcfg,
                       torch.as_tensor(px)).numpy()
    assert got.shape == (2, jcfg.num_patches - 1, jcfg.hidden_size)
    _close(got, want)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_quantize_vit_w8a8_matches_jax(flavor):
    cfg = _cfgs(flavor)[0]
    got, want, jp, tp = _both(flavor, _pixels(cfg, 4), quantize=True, select="cls_patch")
    for name in tvit.LINEARS:
        js, ts = jp["layers"][name], tp["layers"][name]
        np.testing.assert_array_equal(ts["w8"].numpy(), np.asarray(js["w8"]))
        np.testing.assert_array_equal(ts["w_scale"].numpy(), np.asarray(js["w_scale"]))
        np.testing.assert_array_equal(ts["bias"].numpy(), np.asarray(js["bias"]))
        assert "kernel" not in ts
    # everything that is not a linear layer is kept as it was
    for name in set(tp["layers"]) - set(tvit.LINEARS):
        assert tp["layers"][name] is not None and "w8" not in tp["layers"][name]
    _close(got, want)


HF_CONFIGS = [
    dict(model_type="clip_vision_model", hidden_size=1024, intermediate_size=4096,
         num_hidden_layers=24, num_attention_heads=16, image_size=336, patch_size=14),
    dict(model_type="intern_vit_6b", hidden_size=3200, intermediate_size=12800,
         num_hidden_layers=45, num_attention_heads=25, image_size=448, patch_size=14,
         qk_normalization=True, layer_norm_eps=1e-6),
    dict(model_type="internvit", hidden_size=64, intermediate_size=128,
         num_hidden_layers=2, num_attention_heads=4, image_size=56, patch_size=14,
         hidden_act="gelu"),
]
RADIO_CONFIGS = [
    dict(model_type="radio", args={"model": "vit_huge_patch16_224"}),
    dict(model_type="radio", args={"model": "vit_large_patch14_dinov2"},
         preferred_resolution=[448, 448]),
    dict(model_type="radio", model="vit_base_patch16", preferred_resolution=384),
    dict(model_type="radio", hidden_size=32, intermediate_size=64, num_hidden_layers=2,
         num_attention_heads=4, image_size=56, patch_size=14),
]


@pytest.mark.parametrize("hf", HF_CONFIGS + RADIO_CONFIGS)
def test_config_parsers_match_jax(hf):
    parse = "from_radio_config" if hf["model_type"] == "radio" else "from_hf_config"
    want = getattr(jvit.ViTConfig, parse)(hf, dtype="bfloat16")
    got = getattr(tvit.ViTConfig, parse)(hf, dtype="bfloat16")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.head_dim, got.num_patches, got.num_positions) == (
        want.head_dim, want.num_patches, want.num_positions)


def test_unknown_radio_model_raises_as_jax():
    hf = dict(model_type="radio", args={"model": "eva02_large"})
    with pytest.raises(ValueError, match="eva02_large") as jerr:
        jvit.ViTConfig.from_radio_config(hf)
    with pytest.raises(ValueError, match="eva02_large") as terr:
        tvit.ViTConfig.from_radio_config(hf)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_init_params_has_jax_structure(flavor):
    jcfg, tcfg = _cfgs(flavor)
    want = jax.eval_shape(lambda: jvit.init_params(jax.random.PRNGKey(0), jcfg))
    got = tvit.init_params(torch.Generator().manual_seed(0), tcfg)
    flat_w = {jax.tree_util.keystr(k): v.shape
              for k, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): tuple(v.shape)
              for k, v in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g == flat_w
    assert float(got["layers"]["fc1"]["kernel"].std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("flavor", list(FLAVORS))
def test_generic_vit_state_dict_matches_jax(flavor):
    cfg = _cfgs(flavor)[0]
    p = vit_params(cfg, 5)
    want = jentry.generic_vit_state_dict(p, cfg.num_hidden_layers)
    got = tentry.generic_vit_state_dict(weights.from_jax_params(p, device="cpu"),
                                        cfg.num_hidden_layers)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("drop", ["class_embedding", "layers/ls1", "layers/q_norm"])
def test_from_jax_params_checks_the_towers_leaves(drop):
    """`from_jax_params` with a VLMConfig holds a ViT tower's optional
    leaves to the config: a missing class token, layer scale or q norm
    fails there, naming the leaf."""
    from vila_tpu_torch.models import vlm as tvlm

    jcfg, tcfg = _cfgs("internvit_qk")
    p = vit_params(jcfg, 6)
    cfg = tvlm.VLMConfig(llm=None, vision=tcfg, projector=None,
                         vision_tower_type="internvit")
    weights._check_vision(weights.to_torch_tree(p, torch.device("cpu")), cfg)
    node = p
    *path, leaf = drop.split("/")
    for key in path:
        node = node[key]
    del node[leaf]
    with pytest.raises(ValueError, match=f"vision_tower/{drop} is missing"):
        weights._check_vision(p, cfg)
