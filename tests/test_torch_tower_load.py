"""Loading the other towers into the port (`vila_tpu_torch.utils.hf_import`,
`vila_tpu_torch.entry`) against the JAX package on the CPU.

* Every converter on the JAX tests' own synthetic state dicts (the timm
  layout of `tests/test_radio_ps3_load.py`, the InternViT layout of
  `tests/test_vit_parity.py`, an HF `CLIPVisionModel`'s): every output
  array equal to JAX's; the RADIO and PS3 trunks also through the port's
  forward against those tests' independent torch reference.
* Checkpoint directories of each tower (CLIP, InternViT, RADIO, PS3; the
  tower and projector written with numpy by the port's writer):
  `build_config` equal to JAX's field by field, `load_params` bit for bit,
  `save` -> `build_config` / `load_params` round trips (and JAX reading the
  port's save), `load(vision_int8=True)`'s W8A8 tower equal to JAX's, and
  `load(device="cpu")`'s greedy transcript equal to `vila_tpu.load`'s on
  one image + prompt (an f32 LLM).
"""

import dataclasses
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from test_radio_ps3_load import make_timm_state_dict, ref_timm_forward  # noqa: E402
from test_torch_entry import _assert_same_config, _assert_tree_equal  # noqa: E402
from vila_tpu import entry as jentry  # noqa: E402
from vila_tpu.inference import generate as jgen  # noqa: E402
from vila_tpu.models import projector as jproj  # noqa: E402
from vila_tpu.models import ps3 as jps3  # noqa: E402
from vila_tpu.models import siglip as jsiglip  # noqa: E402
from vila_tpu.models import vit as jvit  # noqa: E402
from vila_tpu.utils import hf_import as jhf  # noqa: E402
from vila_tpu_torch import entry as tentry  # noqa: E402
from vila_tpu_torch.inference import generate as tgen  # noqa: E402
from vila_tpu_torch.models import ps3 as tps3  # noqa: E402
from vila_tpu_torch.models import siglip as tsiglip  # noqa: E402
from vila_tpu_torch.models import vit as tvit  # noqa: E402
from vila_tpu_torch.utils import hf_import as thf  # noqa: E402
from vila_tpu_torch.utils import weights  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
NEW_TOKENS = 6
D, MLP = 32, 64


def _tree_equal(got, want, path=""):
    """A port tree (tensors) against a JAX converter's tree (numpy), bit for
    bit, contiguous."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, torch.Tensor) and got.is_contiguous(), path
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(want).dtype and tuple(got.shape) == want.shape, path
    np.testing.assert_array_equal(got.numpy(), want, err_msg=path)


def intern_state_dict(rng, L=3, d=D, mlp=MLP, qk_norm=True, patch=14, n_pos=17):
    """The InternViT layout of tests/test_vit_parity.py (fused qkv,
    norm1/2, ls1/ls2, optional full-width q/k norms)."""

    def t(*shape):
        return torch.tensor(rng.normal(scale=0.05, size=shape).astype(np.float32))

    sd = {"vision_model.embeddings.patch_embedding.weight": t(d, 3, patch, patch),
          "vision_model.embeddings.class_embedding": t(1, 1, d),
          "vision_model.embeddings.position_embedding": t(1, n_pos, d)}
    for i in range(L):
        p = f"vision_model.encoder.layers.{i}."
        sd[p + "norm1.weight"] = 1.0 + 0.1 * t(d)
        sd[p + "norm1.bias"] = t(d)
        sd[p + "attn.qkv.weight"] = t(3 * d, d)
        sd[p + "attn.qkv.bias"] = t(3 * d)
        if qk_norm:
            sd[p + "attn.q_norm.weight"] = 1.0 + 0.1 * t(d)
            sd[p + "attn.k_norm.weight"] = 1.0 + 0.1 * t(d)
        sd[p + "attn.proj.weight"] = t(d, d)
        sd[p + "attn.proj.bias"] = t(d)
        sd[p + "norm2.weight"] = 1.0 + 0.1 * t(d)
        sd[p + "norm2.bias"] = t(d)
        sd[p + "mlp.fc1.weight"] = t(mlp, d)
        sd[p + "mlp.fc1.bias"] = t(mlp)
        sd[p + "mlp.fc2.weight"] = t(d, mlp)
        sd[p + "mlp.fc2.bias"] = t(d)
        sd[p + "ls1"] = 0.1 + 0.01 * t(d)
        sd[p + "ls2"] = 0.1 + 0.01 * t(d)
    return sd


INTERN_CFG = dict(hidden_size=D, intermediate_size=MLP, num_hidden_layers=3,
                  num_attention_heads=4, image_size=56, patch_size=14, hidden_act="gelu",
                  layer_scale=True, pre_layernorm=False, layer_norm_eps=1e-6)
RADIO_CFG = dict(hidden_size=D, intermediate_size=MLP, num_hidden_layers=2,
                 num_attention_heads=4, image_size=56, patch_size=14, hidden_act="gelu",
                 pre_layernorm=False, layer_norm_eps=1e-6)


def _ps3_cfgs(prompt_dim=0, scales=(56, 112)):
    vit = dict(hidden_size=D, intermediate_size=MLP, num_hidden_layers=3,
               num_attention_heads=4, image_size=scales[0], patch_size=14)
    kw = dict(s3_scales=scales, num_hires_select=4, prompt_dim=prompt_dim)
    return (jps3.PS3Config(vit=jsiglip.SigLIPConfig(**vit), **kw),
            tps3.PS3Config(vit=tsiglip.SigLIPConfig(**vit), **kw))


# --------------------------------------------------------------------------
# converters
# --------------------------------------------------------------------------


def test_clip_converter_matches_jax():
    """An HF `CLIPVisionModel`'s state dict, as tests/test_vit_parity.py
    draws it (pre-LayerNorm under HF's `pre_layrnorm` spelling)."""
    from transformers import CLIPVisionConfig, CLIPVisionModel

    hf = CLIPVisionConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=3,
                          num_attention_heads=4, image_size=56, patch_size=14)
    torch.manual_seed(0)
    sd = CLIPVisionModel(hf).eval().state_dict()
    got = thf.convert_vit_state_dict(sd, tvit.ViTConfig.from_hf_config(hf.to_dict()))
    _tree_equal(got, jhf.convert_vit_state_dict(sd, jvit.ViTConfig.from_hf_config(hf.to_dict())))
    assert "pre_layernorm" in got and "ls1" not in got["layers"]


@pytest.mark.parametrize("qk_norm", [True, False])
def test_internvit_converter_matches_jax(qk_norm):
    sd = intern_state_dict(np.random.default_rng(7), qk_norm=qk_norm)
    kw = dict(INTERN_CFG, qk_norm=qk_norm)
    got = thf.convert_vit_state_dict(sd, tvit.ViTConfig(**kw))
    _tree_equal(got, jhf.convert_vit_state_dict(sd, jvit.ViTConfig(**kw)))
    assert ("q_norm" in got["layers"]) == qk_norm


def _cpe_state_dict(rng):
    """RADIO's CPE patch generator, as tests/test_radio_ps3_load.py draws it."""
    patch = 14
    sd = {
        "model.patch_generator.embedder.weight": torch.tensor(
            rng.normal(scale=0.05, size=(D, patch * patch * 3)).astype(np.float32)),
        "model.patch_generator.pos_embed": torch.tensor(
            rng.normal(scale=0.05, size=(1, 16, D)).astype(np.float32)),
        "model.patch_generator.cls_token.token": torch.tensor(
            rng.normal(scale=0.05, size=(1, 1, D)).astype(np.float32)),
    }
    base = make_timm_state_dict(rng, L=2, d=D, mlp=MLP, prefix="model.")
    sd.update({k: v for k, v in base.items()
               if "patch_embed" not in k and "pos_embed" not in k and "cls" not in k})
    return sd


RADIO_DICTS = {
    "hub": lambda rng: make_timm_state_dict(rng, L=2, d=D, mlp=MLP, n_pos=17,
                                            prefix="radio_model.model."),
    "no_class_row": lambda rng: make_timm_state_dict(rng, L=2, d=D, mlp=MLP, n_pos=16,
                                                     prefix="model."),
    "cpe": _cpe_state_dict,
}


@pytest.mark.parametrize("kind", list(RADIO_DICTS))
def test_radio_converter_matches_jax(kind):
    rng = np.random.default_rng(0)
    sd = RADIO_DICTS[kind](rng)
    got = thf.convert_radio_state_dict(sd, tvit.ViTConfig(**RADIO_CFG))
    _tree_equal(got, jhf.convert_radio_state_dict(sd, jvit.ViTConfig(**RADIO_CFG)))
    assert got["position_embedding"]["embedding"].shape == (17, D)
    if kind == "hub":  # and through the port's forward: the independent reference
        px = rng.normal(size=(2, 56, 56, 3)).astype(np.float32)
        out = tvit.forward(got, tvit.ViTConfig(**RADIO_CFG), torch.as_tensor(px),
                           feature_layer=-1, select="cls_patch")
        bare = {k.removeprefix("radio_model.model."): v for k, v in sd.items()}
        with torch.no_grad():
            ref = ref_timm_forward(bare, px, heads=4, n_layers=2)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)


def test_radio_cpe_with_registers_raises_as_jax():
    sd = _cpe_state_dict(np.random.default_rng(1))
    sd["model.patch_generator.cls_token.token"] = torch.zeros(1, 3, D)
    for hf, cfg in ((jhf, jvit.ViTConfig(**RADIO_CFG)), (thf, tvit.ViTConfig(**RADIO_CFG))):
        with pytest.raises(ValueError, match="3 summary/register tokens"):
            hf.convert_radio_state_dict(sd, cfg)


def _radio_with_layer_scale(rng):
    sd = make_timm_state_dict(rng, L=2, d=D, mlp=MLP, n_pos=17)
    for i in range(2):
        for ls in ("ls1", "ls2"):
            sd[f"blocks.{i}.{ls}.gamma"] = torch.tensor(
                rng.normal(0.5, 0.1, size=D).astype(np.float32))
    return sd


@pytest.mark.parametrize("fault", ["internvit_patch_bias", "internvit_rms_norms",
                                   "radio_layer_scale"])
def test_reference_tower_faults_mirrored(fault):
    """Three simplifications of the JAX reference's towers, which the port
    keeps (ROADMAP.md §3): InternViT's patch-convolution bias is dropped;
    InternViT-6B's `norm_type: "rms"` is not read, norm1/norm2 are
    LayerNorms with a bias, so an RMS checkpoint (weights alone) raises
    KeyError; RADIO's timm layer-scale gammas are converted but
    `from_radio_config` sets no `layer_scale`, so the forward skips them."""
    rng = np.random.default_rng(11)
    if fault == "internvit_patch_bias":
        sd = intern_state_dict(rng)
        biased = dict(sd)
        biased["vision_model.embeddings.patch_embedding.bias"] = torch.ones(D)
        got = thf.convert_vit_state_dict(biased, tvit.ViTConfig(**INTERN_CFG))
        _tree_equal(got, jhf.convert_vit_state_dict(biased, jvit.ViTConfig(**INTERN_CFG)))
        _tree_equal(got, jhf.convert_vit_state_dict(sd, jvit.ViTConfig(**INTERN_CFG)))
        assert sorted(got["patch_embedding"]) == ["kernel"]
    elif fault == "internvit_rms_norms":
        hf = dict(model_type="intern_vit_6b", hidden_size=D, intermediate_size=MLP,
                  num_hidden_layers=3, num_attention_heads=4, image_size=56, patch_size=14,
                  qk_normalization=True)
        for mod in (tvit, jvit):
            assert (mod.ViTConfig.from_hf_config(dict(hf, norm_type="rms"))
                    == mod.ViTConfig.from_hf_config(dict(hf, norm_type="layer_norm")))
        rms = {k: v for k, v in intern_state_dict(rng).items()
               if not k.endswith(("norm1.bias", "norm2.bias"))}
        for hf_mod, mod in ((thf, tvit), (jhf, jvit)):
            with pytest.raises(KeyError, match="norm1.bias"):
                hf_mod.convert_vit_state_dict(rms, mod.ViTConfig(**INTERN_CFG))
    else:
        sd = _radio_with_layer_scale(rng)
        radio = dict(args={"model": "vit_huge_patch16_224"}, hidden_size=D,
                     intermediate_size=MLP, num_hidden_layers=2, num_attention_heads=4,
                     image_size=56, patch_size=14)
        tcfg = tvit.ViTConfig.from_radio_config(radio)
        jcfg = jvit.ViTConfig.from_radio_config(radio)
        assert not tcfg.layer_scale and not jcfg.layer_scale
        got = thf.convert_radio_state_dict(sd, tcfg)
        want = jhf.convert_radio_state_dict(sd, jcfg)
        _tree_equal(got, want)
        assert sorted(got["layers"]["ls1"]) == ["scale"]
        px = rng.normal(size=(1, 56, 56, 3)).astype(np.float32)
        bare = dict(got, layers={k: v for k, v in got["layers"].items()
                                 if k not in ("ls1", "ls2")})
        out = tvit.forward(got, tcfg, torch.as_tensor(px))
        assert torch.equal(out, tvit.forward(bare, tcfg, torch.as_tensor(px)))
        with jax.default_matmul_precision("highest"):
            ref = np.asarray(jvit.forward(jax.tree.map(jax.numpy.asarray, want), jcfg,
                                          jax.numpy.asarray(px)))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("prefix", ["radio_model.", "", "model."])
def test_radio_image_stats_match_jax(prefix):
    sd = {f"{prefix}input_conditioner.norm_mean": torch.tensor([[[0.1]], [[0.2]], [[0.3]]]),
          f"{prefix}input_conditioner.norm_std": torch.tensor([[[0.4]], [[0.5]], [[0.6]]])}
    assert thf.radio_image_stats(sd) == jhf.radio_image_stats(sd)
    assert thf.radio_image_stats({}) is None


@pytest.mark.parametrize("prefix", list(jhf._TIMM_PREFIX_CANDIDATES))
def test_find_timm_prefix_matches_jax(prefix):
    sd = make_timm_state_dict(np.random.default_rng(2), L=1, d=8, mlp=16, patch=2,
                              n_pos=5, prefix=prefix)
    assert thf._find_timm_prefix(sd) == jhf._find_timm_prefix(sd) == prefix
    with pytest.raises(KeyError, match="no timm-ViT key layout"):
        thf._find_timm_prefix({"vision_model.embeddings.x": 0})


@pytest.mark.parametrize("prompt_dim", [0, 48])
@pytest.mark.parametrize("scale_key", [None, "vision_model.scale_embed", "scale_embedding"])
def test_ps3_converter_matches_jax(prompt_dim, scale_key):
    rng = np.random.default_rng(3)
    sd = make_timm_state_dict(rng, L=3, d=D, mlp=MLP, n_pos=16, cls_token=False,
                              prefix="vision_model.trunk.")
    if scale_key:  # three rows stored for two scales: the first two are read
        sd[scale_key] = torch.tensor(rng.normal(size=(3, D)).astype(np.float32))
    jcfg, tcfg = _ps3_cfgs(prompt_dim)
    got = thf.convert_ps3_state_dict(sd, tcfg)
    _tree_equal(got, jhf.convert_ps3_state_dict(sd, jcfg))
    assert ("top_down_prompt_head" in got) == bool(prompt_dim)
    # the low-res pass through the port against the independent reference
    px = rng.normal(size=(1, 56, 56, 3)).astype(np.float32)
    feats, _, _ = tps3.forward(got, tcfg, torch.as_tensor(px), num_look_close=0)
    bare = {k.removeprefix("vision_model.trunk."): v for k, v in sd.items()
            if k.startswith("vision_model.trunk.")}
    if scale_key is None:  # a zero scale embedding: the plain trunk
        with torch.no_grad():
            ref = ref_timm_forward(bare, px, heads=4, n_layers=2, cls_token=False,
                                   final_norm=False)
        np.testing.assert_allclose(feats.numpy(), ref.numpy(), atol=2e-4, rtol=1e-3)


# --------------------------------------------------------------------------
# checkpoint directories
# --------------------------------------------------------------------------


def _projector_sd(ptype, mm_hidden, hidden, seed):
    """A projector of `ptype` in the reference's nn.Sequential layout, drawn
    with numpy (norm scales around 1)."""
    cfg = jproj.ProjectorConfig(projector_type=ptype, mm_hidden_size=mm_hidden,
                                hidden_size=hidden)
    shapes = jax.eval_shape(lambda: jproj.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.1 * x

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tentry.projector_state_dict({"mm_projector": weights.to_torch_tree(
        tree, torch.device("cpu"))})


def _tower(kind, rng):
    """(state dict, vision config.json, projector type) of a tower."""
    base = dict(hidden_size=D, intermediate_size=MLP, num_attention_heads=4,
                image_size=56, patch_size=14)
    if kind == "clip":
        from transformers import CLIPVisionConfig, CLIPVisionModel

        hf = CLIPVisionConfig(num_hidden_layers=3, **base)
        torch.manual_seed(int(rng.integers(1 << 30)))
        return (CLIPVisionModel(hf).eval().state_dict(),
                dict(hf.to_dict(), model_type="clip_vision_model"), "mlp_downsample")
    if kind == "internvit":
        return (intern_state_dict(rng), dict(base, model_type="intern_vit_6b",
                                             num_hidden_layers=3, qk_normalization=True,
                                             layer_norm_eps=1e-6), "mlp_downsample")
    if kind == "radio":
        sd = make_timm_state_dict(rng, L=2, d=D, mlp=MLP, n_pos=17,
                                  prefix="radio_model.model.")
        sd["radio_model.input_conditioner.norm_mean"] = torch.tensor([0.4, 0.5, 0.6])
        sd["radio_model.input_conditioner.norm_std"] = torch.tensor([0.25, 0.2, 0.3])
        return sd, dict(base, model_type="radio", num_hidden_layers=2), "mlp_downsample"
    sd = make_timm_state_dict(rng, L=3, d=D, mlp=MLP, n_pos=16, cls_token=False,
                              prefix="vision_model.trunk.")
    sd["vision_model.scale_embed"] = torch.tensor(rng.normal(size=(2, D)).astype(np.float32))
    return sd, dict(model_type="ps3_vision_model", hidden_size=D, intermediate_size=MLP,
                    num_hidden_layers=3, num_attention_heads=4, patch_size=14,
                    ps3_scales=[56, 112], num_hires_select=4), "mlp2x_gelu"


TOWERS = ("clip", "internvit", "radio", "ps3")


def write_tower_ckpt(d, kind, seed=0):
    """A checkpoint directory of tower `kind`: the LLM and tokenizer of
    `helpers.save_tiny_checkpoint`, the tower and projector written with
    numpy by the port's writer. Returns `d`."""
    import json

    helpers.save_tiny_checkpoint(d, seed=0, hidden_size=64, intermediate_size=128)
    sd, vt_cfg, ptype = _tower(kind, np.random.default_rng(10 + seed))
    for comp, tensors, cfg in (
            ("vision_tower", sd, vt_cfg),
            ("mm_projector", _projector_sd(ptype, D, 64, 20 + seed),
             {"mm_projector_type": ptype})):
        path = os.path.join(d, comp)
        os.remove(os.path.join(path, "model.safetensors"))
        thf.save_safetensors({k: v.numpy() for k, v in tensors.items()},
                             os.path.join(path, "model.safetensors"))
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llava", "image_aspect_ratio": "resize",
                   "mm_vision_select_layer": -2, "mm_vision_select_feature": "patch",
                   "mm_hidden_size": D}, f)
    return d


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    return {kind: write_tower_ckpt(str(tmp_path_factory.mktemp("tower") / kind), kind, i)
            for i, kind in enumerate(TOWERS)}


def _jax_as_port(jparams):
    return weights.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("kind", TOWERS)
def test_build_config_and_load_params_match_jax(ckpts, kind):
    d = ckpts[kind]
    jcfg = jentry.build_config(d, dtype="float32")
    tcfg = tentry.build_config(d, dtype="float32", device="cpu")
    _assert_same_config(tcfg, jcfg)
    assert tcfg.vision_tower_type == kind
    if kind == "radio":
        assert tcfg.vision.image_mean == (0.4000000059604645, 0.5, 0.6000000238418579)
    if kind == "ps3":
        assert tcfg.vision.prompt_dim == tcfg.llm.hidden_size == 64
        assert tcfg.tokens_per_image == 16 + 4
    params = tentry.load_params(d, tcfg, device="cpu")
    _assert_tree_equal(params, _jax_as_port(jentry.load_params(d, jcfg)))
    weights.from_jax_params(jax.tree.map(np.asarray, jentry.load_params(d, jcfg)), cfg=tcfg,
                            device="cpu")  # the tower's leaves fit its config


@pytest.mark.parametrize("kind", TOWERS)
def test_save_round_trips_and_loads_in_jax(ckpts, kind, tmp_path):
    d = ckpts[kind]
    tcfg = tentry.build_config(d, device="cpu")
    params = tentry.load_params(d, tcfg, device="cpu")
    if kind == "ps3":  # heads the reference's checkpoints lack, kept by the port's save
        g = torch.Generator().manual_seed(0)
        for head in ("select_head", "top_down_prompt_head"):
            params["vision_tower"][head]["kernel"] = torch.randn(
                params["vision_tower"][head]["kernel"].shape, generator=g)
        tcfg = dataclasses.replace(tcfg, ps3_look_close_mode="after_prompt")
    out = str(tmp_path / "saved")
    tentry.save(params, tcfg, None, out)
    _assert_same_config(tentry.build_config(out, device="cpu"), tcfg)
    _assert_tree_equal(tentry.load_params(out, tcfg, device="cpu"), params)
    # the JAX package reads the port's save (it zeroes PS3's heads)
    jcfg = jentry.build_config(out)
    _assert_same_config(dataclasses.replace(tcfg, ps3_look_close_mode="after_image"), jcfg)
    back = _jax_as_port(jentry.load_params(out, jcfg))
    if kind == "ps3":
        for head in ("select_head", "top_down_prompt_head"):
            assert not back["vision_tower"][head]["kernel"].any()
            back["vision_tower"][head] = params["vision_tower"][head]
    _assert_tree_equal(back, params)


@pytest.mark.parametrize("kind", ["clip", "internvit", "radio"])
def test_vision_int8_matches_jax(ckpts, kind):
    d = ckpts[kind]
    engine = tentry.load(d, device="cpu", vision_int8=True)
    jcfg = jentry.build_config(d)
    want = jvit.quantize_vit_w8a8(jentry.load_params(d, jcfg)["vision_tower"])
    _assert_tree_equal(engine.params["vision_tower"], _jax_as_port(want))
    assert "w8" in engine.params["vision_tower"]["layers"]["fc1"]


@pytest.mark.parametrize("kind", TOWERS)
def test_load_gives_the_jax_engines_transcript(ckpts, kind):
    d = ckpts[kind]
    image = np.random.default_rng(4).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    prompt = [image, "What is shown here?"]
    jengine = jentry.load(d)
    tengine = tentry.load(d, device="cpu")
    jin, tin = jengine.prepare_inputs(list(prompt)), tengine.prepare_inputs(list(prompt))
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    np.testing.assert_array_equal(tin["media_pos"], jin["media_pos"])
    assert [e["kind"] for e in tin["media"]] == [e["kind"] for e in jin["media"]]
    want = jengine.generate_ids(jin, jgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    assert len(want) == NEW_TOKENS and got == want


def test_jax_save_of_other_towers_does_not_round_trip(ckpts, tmp_path):
    """Pinned reference behaviour: the JAX package's `save` writes every
    tower's config.json as `siglip_vision_model` and a CLIP tree in the
    single-repo export's layout, so its own `load_params` of that directory
    fails (the tower reads back as SigLIP); a PS3 config has no
    `intermediate_size`, so its `save` raises. The port's `save` writes
    each tower in the layout its converter reads (the round trips above)."""
    jcfg = jentry.build_config(ckpts["clip"])
    out = str(tmp_path / "jax_clip")
    jentry.save(jentry.load_params(ckpts["clip"], jcfg), jcfg, None, out)
    back = jentry.build_config(out)
    assert back.vision_tower_type == "siglip"
    with pytest.raises(KeyError, match="embeddings.patch_embedding.weight"):
        jentry.load_params(out, back)
    jcfg = jentry.build_config(ckpts["ps3"])
    with pytest.raises(AttributeError, match="intermediate_size"):
        jentry.save(jentry.load_params(ckpts["ps3"], jcfg), jcfg, None,
                    str(tmp_path / "jax_ps3"))


@pytest.mark.parametrize("kind", TOWERS)
def test_infer_cli_serves_the_tower(ckpts, kind, tmp_path, capsys):
    """`python -m vila_tpu_torch.cli.infer` takes each tower's checkpoint,
    `--vision-int8` included where JAX takes it (PS3 raises, as in JAX); it
    prints the engine's greedy answer."""
    from PIL import Image as PILImage

    from vila_tpu_torch.cli import infer
    from vila_tpu_torch.media import Image

    path = str(tmp_path / "photo.png")
    PILImage.fromarray(np.random.default_rng(5).integers(
        0, 256, (40, 60, 3), dtype=np.uint8)).save(path)
    argv = ["--model-path", ckpts[kind], "--media", path, "--text", "What is it?",
            "--max-new-tokens", "4", "--device", "cpu", "--vision-int8"]
    if kind == "ps3":
        with pytest.raises(ValueError, match="vision_int8 unsupported for tower 'ps3'"):
            infer.main(argv)
        argv = argv[:-1]
    assert infer.main(argv) == 0
    engine = tentry.load(ckpts[kind], device="cpu", vision_int8=kind != "ps3")
    want = engine.generate_content([Image(path), "What is it?"], tgen.GenerationConfig(
        max_new_tokens=4, do_sample=False, temperature=1e-4))
    assert capsys.readouterr().out == want + "\n"
