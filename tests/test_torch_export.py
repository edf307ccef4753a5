"""The port's single-repo HF export (`vila_tpu_torch.export.export_hf_repo`)
against the JAX package's (`vila_tpu.export.export_hf_repo`), on the CPU,
for a SigLIP tower, a `vila_vit` tower (InternViT's flags: layer scale, qk
norm, a class token) and PS3's trunk (`tests/test_hf_export.py`'s three
models, weights drawn by JAX from a seed and carried across with
`from_jax_params`):

* both exports' `config.json` are equal as dicts, their `model.safetensors`
  hold the same keys with every tensor bit for bit equal, and the remote
  code is the same file;
* `AutoModel.from_pretrained(<port export>, trust_remote_code=True)` gives
  logits within 1e-4 of the port's forward (`GenerationEngine`'s media
  encode, splice and `qwen2.forward`) and of JAX's on the same ids and
  image;
* its `generate` and `VILAProcessor` run on the port's export, whose
  tokenizer files the port's own tokenizer wrote.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from vila_tpu.data.tokenizer_utils import add_media_tokens as jadd_media_tokens  # noqa: E402
from vila_tpu.export import export_hf_repo as jexport  # noqa: E402
from vila_tpu.inference.generate import GenerationEngine as JEngine  # noqa: E402
from vila_tpu.media import Image as JImage  # noqa: E402
from vila_tpu.models import projector as jprojector  # noqa: E402
from vila_tpu.models import ps3 as jps3  # noqa: E402
from vila_tpu.models import qwen2 as jqwen2  # noqa: E402
from vila_tpu.models import siglip as jsiglip  # noqa: E402
from vila_tpu.models import vit as jvit  # noqa: E402
from vila_tpu.models import vlm as jvlm  # noqa: E402
from vila_tpu_torch.data.tokenizer_json import JsonTokenizer  # noqa: E402
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens  # noqa: E402
from vila_tpu_torch.export import export_hf_repo  # noqa: E402
from vila_tpu_torch.export import hf_remote  # noqa: E402
from vila_tpu_torch.inference.generate import GenerationEngine  # noqa: E402
from vila_tpu_torch.media import Image  # noqa: E402
from vila_tpu_torch.models import projector, ps3, qwen2, siglip, vit, vlm  # noqa: E402
from vila_tpu_torch.utils import weights  # noqa: E402
from vila_tpu_torch.utils.hf_import import read_safetensors  # noqa: E402

KINDS = ("siglip", "internvit", "ps3")
TOL = 1e-4
TOWER = dict(hidden_size=48, intermediate_size=96, num_hidden_layers=3,
             num_attention_heads=4, image_size=56, patch_size=14)
VIT_FLAGS = dict(hidden_act="gelu", pre_layernorm=False, layer_scale=True, qk_norm=True,
                 class_token=True)


def _configs(kind, vocab):
    """The same VLM config in both packages (f32)."""
    llm = dict(vocab_size=vocab, hidden_size=64, intermediate_size=112, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, dtype="float32")
    ptype = "linear" if kind == "ps3" else "mlp_downsample"  # PS3 keeps every token
    proj = dict(projector_type=ptype, mm_hidden_size=48, hidden_size=64)
    top = {}
    if kind == "siglip":
        vis = (jsiglip.SigLIPConfig(**TOWER), siglip.SigLIPConfig(**TOWER))
    elif kind == "internvit":
        vis = (jvit.ViTConfig(**TOWER, **VIT_FLAGS), vit.ViTConfig(**TOWER, **VIT_FLAGS))
        top = dict(vision_tower_type="internvit", vision_select="patch")
    else:
        kw = dict(s3_scales=(56, 112), prompt_dim=64)
        vis = (jps3.PS3Config(vit=jsiglip.SigLIPConfig(**TOWER), **kw),
               ps3.PS3Config(vit=siglip.SigLIPConfig(**TOWER), **kw))
        top = dict(vision_tower_type="ps3")
    return (jvlm.VLMConfig(llm=jqwen2.LLMConfig(**llm), vision=vis[0],
                           projector=jprojector.ProjectorConfig(**proj), **top),
            vlm.VLMConfig(llm=qwen2.LLMConfig(**llm), vision=vis[1],
                          projector=projector.ProjectorConfig(**proj), **top))


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """For each tower: both packages' exports of one JAX draw, and what the
    logit checks need."""
    jtok = helpers.make_tiny_tokenizer()
    tok_dir = str(tmp_path_factory.mktemp("tok"))
    jtok.save_pretrained(tok_dir)
    jadd_media_tokens(jtok)
    ttok = JsonTokenizer.from_pretrained(tok_dir)
    add_media_tokens(ttok)
    out = {}
    for seed, kind in enumerate(KINDS):
        jcfg, tcfg = _configs(kind, len(jtok))
        jparams = jvlm.init_params(jax.random.PRNGKey(seed), jcfg)
        tparams = weights.from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
        root = tmp_path_factory.mktemp(f"export_{kind}")
        jdir, tdir = str(root / "jax"), str(root / "port")
        jexport(jparams, jcfg, jtok, jdir)
        assert export_hf_repo(tparams, tcfg, ttok, tdir) == tdir
        out[kind] = dict(jdir=jdir, tdir=tdir, jcfg=jcfg, tcfg=tcfg, jparams=jparams,
                         tparams=tparams, jtok=jtok, ttok=ttok)
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_export_equals_jax_file_for_file(exports, kind):
    e = exports[kind]
    files = ("config.json", "model.safetensors", "modeling_vila.py", "tokenizer.json")
    for d in (e["jdir"], e["tdir"]):
        assert all(os.path.exists(os.path.join(d, f)) for f in files), d
    with open(os.path.join(e["jdir"], "config.json")) as f:
        want = json.load(f)
    with open(os.path.join(e["tdir"], "config.json")) as f:
        got = json.load(f)
    assert got == want
    assert got == hf_remote.export_config(e["tcfg"])
    from safetensors.numpy import load_file

    want_sd = load_file(os.path.join(e["jdir"], "model.safetensors"))
    got_sd = read_safetensors(os.path.join(e["tdir"], "model.safetensors"))
    assert sorted(got_sd) == sorted(want_sd)
    for k, v in want_sd.items():
        g = got_sd[k]
        assert g.dtype == torch.float32 and tuple(g.shape) == v.shape, k
        assert np.array_equal(g.numpy().view(np.uint32), v.view(np.uint32)), k
    with open(os.path.join(e["jdir"], "modeling_vila.py"), "rb") as f:
        want_code = f.read()
    with open(os.path.join(e["tdir"], "modeling_vila.py"), "rb") as f:
        assert f.read() == want_code


def _inputs(e, seed):
    """One image + prompt through both packages' host pipelines: the ids,
    tiles and media positions (the port's equal to JAX's), and the pixels
    normalised as the remote code takes them."""
    jengine = JEngine(e["jparams"], e["jcfg"], e["jtok"])
    tengine = GenerationEngine(e["tparams"], e["tcfg"], e["ttok"], device="cpu")
    img = np.random.default_rng(seed).integers(0, 255, (70, 90, 3), np.uint8)
    jin = jengine.prepare_inputs([JImage(img), "what is this?"])
    tin = tengine.prepare_inputs([Image(img), "what is this?"])
    assert np.array_equal(np.asarray(tin["input_ids"]), np.asarray(jin["input_ids"]))
    assert np.array_equal(np.asarray(tin["media_pos"]), np.asarray(jin["media_pos"]))
    tiles = np.concatenate([m["tiles"] for m in jin["media"]])
    assert np.array_equal(np.concatenate([np.asarray(m["tiles"]) for m in tin["media"]]), tiles)
    return jengine, tengine, jin, tin, tiles


def _remote_logits(d, cfg, ids, tiles, mp):
    from transformers import AutoModel

    vis = cfg.vision.vit if cfg.vision_tower_type == "ps3" else cfg.vision
    mean = np.asarray(vis.image_mean, np.float32) * 255.0
    std = np.asarray(vis.image_std, np.float32) * 255.0
    px = torch.tensor(((tiles.astype(np.float32) - mean) / std).transpose(0, 3, 1, 2))
    model = AutoModel.from_pretrained(d, trust_remote_code=True, dtype=torch.float32).eval()
    with torch.no_grad():
        return model(input_ids=torch.tensor(ids.astype(np.int64)), pixel_values=px,
                     media_positions=torch.tensor(mp.astype(np.int64))).logits[0].numpy()


@pytest.mark.parametrize("kind", ("siglip", "internvit"))
def test_automodel_logits_match_both_engines(exports, kind):
    import jax.numpy as jnp

    e = exports[kind]
    jengine, tengine, jin, tin, tiles = _inputs(e, seed=KINDS.index(kind))
    ids = np.asarray(jin["input_ids"], np.int64)[None]
    mp = np.asarray(jin["media_pos"], np.int64)

    jl = e["jparams"]["llm"]
    jemb = jvlm.splice_media(jqwen2.embed_tokens(jl, e["jcfg"].llm, jnp.asarray(ids)),
                             jengine.encode_media(jin["media"]), jnp.asarray(mp))
    want = np.asarray(jqwen2.forward(jl, e["jcfg"].llm, inputs_embeds=jemb)[0][0], np.float32)

    tl = e["tparams"]["llm"]
    with torch.no_grad():
        temb = vlm.splice_media(qwen2.embed_tokens(tl, e["tcfg"].llm, torch.tensor(ids)),
                                tengine.encode_media(tin["media"]), torch.tensor(mp))
        port = qwen2.forward(tl, e["tcfg"].llm, inputs_embeds=temb)[0][0].float().numpy()

    remote = _remote_logits(e["tdir"], e["tcfg"], ids, tiles, mp)
    assert np.abs(remote - port).max() < TOL
    assert np.abs(remote - want).max() < TOL
    assert (remote.argmax(-1) == port.argmax(-1)).all()


def test_ps3_trunk_logits_match_both_packages(exports):
    """PS3 exports its SigLIP trunk alone: the remote model's logits over
    the low-res tile against each package's trunk encode, projector, splice
    and LLM forward on the same ids."""
    import jax.numpy as jnp

    e = exports["ps3"]
    jcfg, tcfg = e["jcfg"], e["tcfg"]
    n = tcfg.ps3_tokens_low
    assert n == jcfg.ps3_tokens_low
    rng = np.random.default_rng(7)
    tiles = rng.integers(0, 256, (1, 56, 56, 3), np.uint8)
    text = rng.integers(0, 200, 12)
    ids = np.concatenate([text[:4], np.full(n, e["ttok"].media_token_ids["image"]), text[4:]])[None]
    mp = np.arange(4, 4 + n, dtype=np.int64)
    sel = dict(feature_layer=tcfg.vision_feature_layer, select=tcfg.vision_select)

    jp = e["jparams"]
    jf = jsiglip.forward(jp["vision_tower"]["vit"], jcfg.vision.vit, jnp.asarray(tiles), **sel)
    jemb = jvlm.splice_media(
        jqwen2.embed_tokens(jp["llm"], jcfg.llm, jnp.asarray(ids)),
        jprojector.forward(jp["mm_projector"], jcfg.projector, jf).reshape(n, -1),
        jnp.asarray(mp))
    want = np.asarray(jqwen2.forward(jp["llm"], jcfg.llm, inputs_embeds=jemb)[0][0], np.float32)

    tp = e["tparams"]
    with torch.no_grad():
        tf = siglip.forward(tp["vision_tower"]["vit"], tcfg.vision.vit, torch.tensor(tiles), **sel)
        temb = vlm.splice_media(
            qwen2.embed_tokens(tp["llm"], tcfg.llm, torch.tensor(ids)),
            projector.forward(tp["mm_projector"], tcfg.projector, tf).reshape(n, -1),
            torch.tensor(mp))
        port = qwen2.forward(tp["llm"], tcfg.llm, inputs_embeds=temb)[0][0].float().numpy()

    remote = _remote_logits(e["tdir"], tcfg, ids, tiles, mp)
    assert np.abs(remote - port).max() < TOL
    assert np.abs(remote - want).max() < TOL


@pytest.mark.parametrize("kind", KINDS)
def test_remote_generate_and_processor_on_the_port_export(exports, kind):
    from transformers import AutoModel
    from transformers.dynamic_module_utils import get_class_from_dynamic_module

    e = exports[kind]
    cfg = e["tcfg"]
    model = AutoModel.from_pretrained(e["tdir"], trust_remote_code=True,
                                      dtype=torch.float32).eval()
    processor = get_class_from_dynamic_module("modeling_vila.VILAProcessor",
                                              e["tdir"]).from_pretrained(e["tdir"])
    img = np.random.default_rng(1).integers(0, 255, (64, 64, 3), np.uint8)
    batch = processor("<image>\ndescribe", images=[img])
    want_tokens = cfg.ps3_tokens_low if kind == "ps3" else cfg.tokens_per_image
    assert batch["media_positions"].shape[0] == want_tokens
    assert processor.image_token_id == e["ttok"].media_token_ids["image"]
    assert (batch["input_ids"][0, :want_tokens] == processor.image_token_id).all()
    ids = model.generate(input_ids=batch["input_ids"], pixel_values=batch["pixel_values"],
                         media_positions=batch["media_positions"], max_new_tokens=3,
                         do_sample=False)
    assert ids.shape[0] == 1 and ids.shape[1] >= 1
