"""Model loading and saving in VILA's component-wise checkpoint layout, as
`vila_tpu/entry.py`.

A checkpoint is a directory with `llm/`, `vision_tower/` and
`mm_projector/` subdirectories, each an HF model directory (config.json
plus safetensors), and a top-level config.json with the multimodal fields.
`build_config` reads the configs, `load_params` the weights (read with
numpy by `utils.hf_import`, cast to the parameter dtype and placed on the
device), `load` returns a ready `GenerationEngine`, and `save` writes the
same layout back (tensors in f32).

Every tower of the JAX package loads: SigLIP (with every aspect mode,
dynamic-S2's multi-scale projector width, every projector type, basic or
TSP video), CLIP, InternViT, RADIO (its input-conditioner statistics read
from the weights) and PS3 (its top-down head as wide as the LLM). `save`
writes each tower in the layout its converter reads (the reference's:
HF CLIP, InternViT, RADIO's and PS3's timm trunks), so every tower
round-trips.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from vila_tpu_torch.conversation import auto_set_conversation_mode
from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import ps3, qwen2, siglip, vit, vlm
from vila_tpu_torch.utils import hf_import
from vila_tpu_torch.utils.device import host_to_device, resolve_device

COMPONENTS = ("llm", "vision_tower", "mm_projector")
# the reference's TSP video encoder class (its hydra `_target_`)
TSP_TARGET = "llava.model.encoders.TSPVideoEncoder"


def _default_dtype(device) -> str:
    """bf16 on the card, f32 on the CPU (the JAX package: bf16 on a TPU)."""
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def _tower_type(vt_hf: dict) -> str:
    """The JAX package's tower dispatch on the vision config's model_type."""
    vt_type = vt_hf.get("model_type", "siglip_vision_model")
    for key, tower in (("radio", "radio"), ("ps3", "ps3"), ("clip", "clip"),
                       ("intern", "internvit")):
        if key in vt_type:
            return tower
    return "siglip"


def build_config(model_path: str, dtype: Optional[str] = None, device="cuda",
                 **overrides) -> vlm.VLMConfig:
    """A VLMConfig from a component checkpoint directory; `dtype` defaults
    to bf16 when `device` is the card and f32 on the CPU."""
    dtype = dtype or _default_dtype(device)
    top = hf_import.load_hf_config(model_path)
    llm_hf = hf_import.load_hf_config(os.path.join(model_path, "llm"))
    vt_hf = hf_import.load_hf_config(os.path.join(model_path, "vision_tower"))
    if "vision_config" in vt_hf:
        vt_hf = vt_hf["vision_config"]
    proj_hf = hf_import.load_hf_config(os.path.join(model_path, "mm_projector"))

    tower = _tower_type(vt_hf)
    llm_cfg = qwen2.LLMConfig.from_hf_config(llm_hf, dtype=dtype)
    if tower == "radio":
        vis_cfg = vit.ViTConfig.from_radio_config(vt_hf, dtype=dtype)
        # the input conditioner's statistics live in the weights
        # (radio_encoder.py's make_preprocessor_external)
        stats = hf_import.radio_image_stats(hf_import.peek_safetensors(
            os.path.join(model_path, "vision_tower"),
            [f"{pre}input_conditioner.norm_{k}" for pre in ("radio_model.", "")
             for k in ("mean", "std")]))
        if stats is not None:
            vis_cfg = dataclasses.replace(vis_cfg, image_mean=stats[0], image_std=stats[1])
    elif tower == "ps3":
        vis_cfg = ps3.PS3Config.from_hf_config(vt_hf, dtype=dtype,
                                               prompt_dim=llm_cfg.hidden_size)
    elif tower in ("clip", "internvit"):
        vis_cfg = vit.ViTConfig.from_hf_config(vt_hf, dtype=dtype)
    else:
        vis_cfg = siglip.SigLIPConfig.from_hf_config(vt_hf, dtype=dtype)
    s2_scales = top.get("s2_scales") or (vis_cfg.image_size,)
    if isinstance(s2_scales, str):
        s2_scales = tuple(int(s) for s in s2_scales.split(","))
    # under dynamic-S2 the projector takes every scale's features side by side
    num_scales = len(s2_scales) if top.get("dynamic_s2") else 1
    proj_cfg = projector_lib.ProjectorConfig(
        projector_type=proj_hf.get("mm_projector_type", "mlp_downsample"),
        mm_hidden_size=top.get("mm_hidden_size") or vis_cfg.hidden_size * num_scales,
        hidden_size=llm_cfg.hidden_size,
        dtype=dtype,
    )
    projector_lib.build_spec(proj_cfg)  # raises for an unknown projector_type
    aspect = top.get("image_aspect_ratio") or "resize"
    if top.get("dynamic_s2") and "dynamic_s2" not in aspect:
        aspect = "dynamic_s2"
    cfg = vlm.VLMConfig(
        llm=llm_cfg,
        vision=vis_cfg,
        projector=proj_cfg,
        vision_tower_type=tower,
        ps3_look_close_mode=top.get("ps3_look_close_mode", "after_image"),
        vision_feature_layer=top.get("mm_vision_select_layer", -2),
        vision_select=top.get("mm_vision_select_feature", "cls_patch"),
        image_aspect_ratio=aspect,
        num_video_frames=top.get("num_video_frames") or 8,
        fps=top.get("fps") or 0.0,
        min_tiles=top.get("min_tiles") or 1,
        max_tiles=top.get("max_tiles") or 12,
        s2_scales=tuple(s2_scales),
        s2_resize_output_to_scale_idx=top.get("s2_resize_output_to_scale_idx", 0),
    )
    # the reference stores the video encoder as a hydra _target_ dict
    # (configuration_llava.py:67-68)
    venc = top.get("video_encoder")
    if isinstance(venc, dict) and "TSP" in venc.get("_target_", ""):
        cfg = dataclasses.replace(cfg, video_encoder="tsp", tsp_pool_sizes=tuple(
            tuple(p) for p in venc.get("pool_sizes", [(1, 1, 1)])))
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def _cast(tree: Any, dtype: torch.dtype) -> Any:
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def load_params(model_path: str, cfg: vlm.VLMConfig, param_dtype=None,
                device="cuda") -> Dict[str, Any]:
    """Every component's weights on `device` (default the card), converted
    to the port's trees and each leaf cast to `param_dtype` (default the
    LLM's compute dtype; round to nearest even, as `jnp.asarray(x,
    dtype=...)`), one component at a time: the stored tensors are copied to
    the device as they are read, and stacked, transposed and cast there."""
    dev = resolve_device(device)
    dtype = param_dtype or cfg.llm.compute_dtype
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    tower = {"radio": hf_import.convert_radio_state_dict,
             "ps3": hf_import.convert_ps3_state_dict,
             "clip": hf_import.convert_vit_state_dict,
             "internvit": hf_import.convert_vit_state_dict,
             }.get(cfg.vision_tower_type, hf_import.convert_siglip_state_dict)
    convert = {
        "llm": lambda sd: hf_import.convert_llm_state_dict(sd, cfg.llm),
        "vision_tower": lambda sd: tower(sd, cfg.vision),
        "mm_projector": hf_import.convert_projector_state_dict,
    }
    params = {}
    for name in COMPONENTS:
        sd = hf_import.load_safetensors_dir(os.path.join(model_path, name))
        sd = {k: host_to_device(v, dev) for k, v in sd.items()}
        params[name] = _cast(convert[name](sd), dtype)
        del sd
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return params


def load_tokenizer(model_path: str):
    """The checkpoint's tokenizer (`llm/tokenizer.json`) read by the port's
    own reader (`data.tokenizer_json`: the forms the repository holds; any
    other raises), with the media tokens added. No `transformers`."""
    from vila_tpu_torch.data.tokenizer_json import JsonTokenizer
    from vila_tpu_torch.data.tokenizer_utils import add_media_tokens

    tokenizer = JsonTokenizer.from_pretrained(os.path.join(model_path, "llm"))
    add_media_tokens(tokenizer)
    return tokenizer


def load(model_path: str, device="cuda", dtype: Optional[str] = None,
         vision_int8: bool = False, **kwargs):
    """A checkpoint loaded into a ready `GenerationEngine` on `device`
    (default the card; without CUDA it raises). `vision_int8` quantizes the
    SigLIP, CLIP, InternViT or RADIO tower to W8A8 (TinyChat's vision
    deployment recipe; a PS3 tower raises `ValueError`, as in the JAX
    package). Other keyword arguments go to the engine."""
    from vila_tpu_torch.inference.generate import GenerationEngine

    dev = resolve_device(device)
    auto_set_conversation_mode(model_path)
    cfg = build_config(model_path, dtype=dtype, device=dev)
    if vision_int8 and cfg.vision_tower_type not in ("siglip", "clip", "internvit", "radio"):
        raise ValueError(f"vision_int8 unsupported for tower {cfg.vision_tower_type!r}")
    params = load_params(model_path, cfg, device=dev)
    if vision_int8:
        quantize = (siglip.quantize_siglip_w8a8 if cfg.vision_tower_type == "siglip"
                    else vit.quantize_vit_w8a8)
        params["vision_tower"] = quantize(params["vision_tower"])
    tokenizer = load_tokenizer(model_path)
    return GenerationEngine(params, cfg, tokenizer, device=dev, **kwargs)


# --------------------------------------------------------------------------
# Saving (component-wise, HF-compatible layout)
# --------------------------------------------------------------------------


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.detach().float().contiguous().cpu()


def _f32t(x: torch.Tensor) -> torch.Tensor:
    """The transpose, made contiguous on the tensor's own device."""
    return _f32(x.detach().float().T)


def llm_state_dict(params: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """The llm tree -> an HF Qwen2/Llama state dict (f32, CPU)."""
    lp = params["llm"]
    L = lp["layers"]
    sd = {"model.embed_tokens.weight": _f32(lp["embed_tokens"]["embedding"])}
    for i in range(cfg.llm.num_hidden_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = _f32(L["input_layernorm"]["scale"][i])
        sd[pre + "post_attention_layernorm.weight"] = _f32(
            L["post_attention_layernorm"]["scale"][i])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[pre + f"self_attn.{name}.weight"] = _f32t(L[name]["kernel"][i])
            if "bias" in L[name]:
                sd[pre + f"self_attn.{name}.bias"] = _f32(L[name]["bias"][i])
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[pre + f"mlp.{name}.weight"] = _f32t(L[name]["kernel"][i])
    sd["model.norm.weight"] = _f32(lp["norm"]["scale"])
    if not cfg.llm.tie_word_embeddings:
        sd["lm_head.weight"] = _f32t(lp["lm_head"]["kernel"])
    return sd


def _stacked(L: Dict[str, Any], name: str, key: str, i: int, t: bool = False):
    return (_f32t if t else _f32)(L[name][key][i])


_HF_LINEARS = (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
               ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
               ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))


def _hf_layers(L: Dict[str, Any], layers: int, pre: str) -> Dict[str, torch.Tensor]:
    """Stacked layers in HF SigLIP's and CLIP's names."""
    sd = {}
    for i in range(layers):
        lp = f"{pre}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[lp + f"{ln}.weight"] = _stacked(L, ln, "scale", i)
            sd[lp + f"{ln}.bias"] = _stacked(L, ln, "bias", i)
        for name, hf in _HF_LINEARS:
            sd[lp + hf + ".weight"] = _stacked(L, name, "kernel", i, True)
            sd[lp + hf + ".bias"] = _stacked(L, name, "bias", i)
    return sd


def _fused_layers(L: Dict[str, Any], layers: int, fmt: str,
                  ls: str = "{}.gamma") -> Dict[str, torch.Tensor]:
    """Stacked layers in timm's and InternViT's names (`fmt` the layer
    prefix): norm1/norm2, one fused attn.qkv, attn.proj, mlp.fc1/fc2, the
    layer scales under `ls` (timm's `ls1.gamma`, InternViT's `ls1`) and
    InternViT's q/k norms."""
    sd = {}
    for i in range(layers):
        lp = fmt.format(i)
        for src, dst in (("layer_norm1", "norm1"), ("layer_norm2", "norm2")):
            sd[lp + dst + ".weight"] = _stacked(L, src, "scale", i)
            sd[lp + dst + ".bias"] = _stacked(L, src, "bias", i)
        for key, hf in (("kernel", "weight"), ("bias", "bias")):
            sd[lp + "attn.qkv." + hf] = torch.cat(
                [_stacked(L, n, key, i, key == "kernel") for n in ("q_proj", "k_proj", "v_proj")])
        for src, dst in (("out_proj", "attn.proj"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            sd[lp + dst + ".weight"] = _stacked(L, src, "kernel", i, True)
            sd[lp + dst + ".bias"] = _stacked(L, src, "bias", i)
        for name in ("ls1", "ls2"):
            if name in L:
                sd[lp + ls.format(name)] = _stacked(L, name, "scale", i)
        for name in ("q_norm", "k_norm"):
            if name in L:
                sd[lp + f"attn.{name}.weight"] = _stacked(L, name, "scale", i)
    return sd


def _conv(kernel: torch.Tensor, p: int) -> torch.Tensor:
    """The (P*P*3, D) patch matmul weight -> the (D, 3, P, P) convolution."""
    return _f32(kernel).reshape(p, p, 3, -1).permute(3, 2, 0, 1).contiguous()


def _ln(tree: Dict[str, Any], name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _f32(tree["scale"]), f"{name}.bias": _f32(tree["bias"])}


def siglip_state_dict(vp: Dict[str, Any], vcfg) -> Dict[str, torch.Tensor]:
    """A SigLIP tree -> a stock `SiglipVisionModel` state dict (f32)."""
    pre = "vision_model."
    return {
        pre + "embeddings.patch_embedding.weight": _conv(vp["patch_embedding"]["kernel"],
                                                          vcfg.patch_size),
        pre + "embeddings.patch_embedding.bias": _f32(vp["patch_embedding"]["bias"]),
        pre + "embeddings.position_embedding.weight": _f32(vp["position_embedding"]["embedding"]),
        **_hf_layers(vp["layers"], vcfg.num_hidden_layers, pre),
        **_ln(vp["post_layernorm"], pre + "post_layernorm"),
    }


def _vit_layout(vp: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """A `models.vit` tree -> the checkpoint layout `hf_import` reads for
    its tower: HF CLIP; InternViT (no post-LayerNorm: it loads as
    identity); or RADIO's timm ViT under `radio_model.model.` with its input
    conditioner."""
    vcfg, tower = cfg.vision, cfg.vision_tower_type
    n = vcfg.num_hidden_layers
    patch = _conv(vp["patch_embedding"]["kernel"], vcfg.patch_size)
    pos = _f32(vp["position_embedding"]["embedding"])
    cls = _f32(vp["class_embedding"])
    if tower == "radio":
        pre = "radio_model.model."
        sd = {**_fused_layers(vp["layers"], n, pre + "blocks.{}."),
              **_ln(vp["post_layernorm"], pre + "norm"),
              pre + "patch_embed.proj.weight": patch, pre + "pos_embed": pos[None],
              pre + "cls_token": cls.reshape(1, 1, -1)}
        if "bias" in vp["patch_embedding"]:
            sd[pre + "patch_embed.proj.bias"] = _f32(vp["patch_embedding"]["bias"])
        for k, v in (("mean", vcfg.image_mean), ("std", vcfg.image_std)):
            sd[f"radio_model.input_conditioner.norm_{k}"] = torch.tensor(
                v, dtype=torch.float32).reshape(-1, 1, 1)
        return sd
    pre = "vision_model."
    if tower == "internvit":
        return {**_fused_layers(vp["layers"], n, pre + "encoder.layers.{}.", ls="{}"),
                pre + "embeddings.patch_embedding.weight": patch,
                pre + "embeddings.position_embedding": pos[None],
                pre + "embeddings.class_embedding": cls.reshape(1, 1, -1)}
    sd = {**_hf_layers(vp["layers"], n, pre),
          **_ln(vp["post_layernorm"], pre + "post_layernorm"),
          pre + "embeddings.patch_embedding.weight": patch,
          pre + "embeddings.position_embedding.weight": pos,
          pre + "embeddings.class_embedding": cls}
    if "pre_layernorm" in vp:  # HF's spelling of CLIP's pre-LayerNorm
        sd.update(_ln(vp["pre_layernorm"], pre + "pre_layrnorm"))
    return sd


def _ps3_layout(vp: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """A `models.ps3` tree -> the PS3 layout `hf_import` reads: the SigLIP
    trunk in timm's layout under `vision_model.trunk.`, the scale
    embeddings, and the selection heads as HF Linear weights (which the
    reference's checkpoints lack)."""
    pre, trunk = "vision_model.trunk.", vp["vit"]
    sd = {**_fused_layers(trunk["layers"], cfg.vision.vit.num_hidden_layers,
                          pre + "blocks.{}."),
          **_ln(trunk["post_layernorm"], pre + "norm"),
          pre + "patch_embed.proj.weight": _conv(trunk["patch_embedding"]["kernel"],
                                                 cfg.vision.patch_size),
          pre + "patch_embed.proj.bias": _f32(trunk["patch_embedding"]["bias"]),
          pre + "pos_embed": _f32(trunk["position_embedding"]["embedding"])[None],
          hf_import.PS3_SCALE_KEYS[0]: _f32(vp["scale_embedding"])}
    for name in ("select_head", "top_down_prompt_head"):
        if name in vp:
            sd[f"{name}.weight"] = _f32t(vp[name]["kernel"])
            sd[f"{name}.bias"] = _f32(vp[name]["bias"])
    return sd


def vision_state_dict(params: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """The tower's tree -> the state dict its converter reads back (f32):
    a stock `SiglipVisionModel`'s for SigLIP, `_vit_layout`'s for CLIP,
    InternViT and RADIO, `_ps3_layout`'s for PS3."""
    vp = params["vision_tower"]
    if cfg.vision_tower_type in ("clip", "internvit", "radio"):
        return _vit_layout(vp, cfg)
    if cfg.vision_tower_type == "ps3":
        return _ps3_layout(vp, cfg)
    return siglip_state_dict(vp, cfg.vision)


def generic_vit_state_dict(vp: Dict[str, Any], num_layers: int) -> Dict[str, torch.Tensor]:
    """A `models.vit` tree -> the state dict of the single-repo HF export's
    VILAGenericViT module (JAX's export/modeling_vila.py; the reference's
    remote_code/modeling_vila.py:506), CLIP, InternViT and RADIO alike."""
    vsd = {
        "patch_embed.weight": _f32t(vp["patch_embedding"]["kernel"]),
        "pos_embed": _f32(vp["position_embedding"]["embedding"]),
        "post_ln.weight": _f32(vp["post_layernorm"]["scale"]),
        "post_ln.bias": _f32(vp["post_layernorm"]["bias"]),
    }
    if "class_embedding" in vp:
        vsd["class_embedding"] = _f32(vp["class_embedding"])
    if "pre_layernorm" in vp:
        vsd["pre_ln.weight"] = _f32(vp["pre_layernorm"]["scale"])
        vsd["pre_ln.bias"] = _f32(vp["pre_layernorm"]["bias"])
    L = vp["layers"]
    for i in range(num_layers):
        pre = f"blocks.{i}."
        for src, dst in (("layer_norm1", "ln1"), ("layer_norm2", "ln2")):
            vsd[pre + dst + ".weight"] = _stacked(L, src, "scale", i)
            vsd[pre + dst + ".bias"] = _stacked(L, src, "bias", i)
        for src, dst in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                         ("out_proj", "out"), ("fc1", "fc1"), ("fc2", "fc2")):
            vsd[pre + dst + ".weight"] = _stacked(L, src, "kernel", i, True)
            vsd[pre + dst + ".bias"] = _stacked(L, src, "bias", i)
        for opt in ("ls1", "ls2"):
            if opt in L:
                vsd[pre + opt] = _stacked(L, opt, "scale", i)
        for opt in ("q_norm", "k_norm"):
            if opt in L:
                vsd[pre + opt + ".weight"] = _stacked(L, opt, "scale", i)
    return vsd


def projector_state_dict(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The projector tree -> the reference nn.Sequential's state dict."""
    psd = {}
    for idx, slot in params["mm_projector"].items():
        if "kernel" in slot:
            psd[f"layers.{idx}.weight"] = _f32t(slot["kernel"])
        if "scale" in slot:
            psd[f"layers.{idx}.weight"] = _f32(slot["scale"])
        if "bias" in slot:
            psd[f"layers.{idx}.bias"] = _f32(slot["bias"])
    return psd


def _write_json(obj: dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


# the vision tower's config.json model_type, by tower (what `_tower_type` reads)
TOWER_MODEL_TYPES = {"siglip": "siglip_vision_model", "clip": "clip_vision_model",
                     "internvit": "intern_vit_6b", "radio": "radio",
                     "ps3": "ps3_vision_model"}


def vision_config(cfg: vlm.VLMConfig) -> Dict[str, Any]:
    """The vision tower's config.json, from which `build_config` reads the
    tower's config back (PS3: its trunk's widths, scales and selection)."""
    tower = cfg.vision_tower_type
    vis = cfg.vision.vit if tower == "ps3" else cfg.vision
    out = {
        "model_type": TOWER_MODEL_TYPES[tower],
        "hidden_size": vis.hidden_size,
        "intermediate_size": vis.intermediate_size,
        "num_hidden_layers": vis.num_hidden_layers,
        "num_attention_heads": vis.num_attention_heads,
        "image_size": vis.image_size,
        "patch_size": vis.patch_size,
        "layer_norm_eps": vis.layer_norm_eps,
    }
    if tower in ("clip", "internvit"):
        out["hidden_act"] = vis.hidden_act
    if tower == "internvit":
        out["qk_normalization"] = vis.qk_norm
    if tower == "ps3":
        out.update(ps3_scales=list(cfg.vision.s3_scales),
                   num_hires_select=cfg.vision.num_hires_select,
                   num_look_close=cfg.vision.num_look_close)
    return out


def save_config(cfg: vlm.VLMConfig, out_dir: str, tokenizer=None) -> None:
    """The config.json files of the component layout (and the tokenizer,
    when given), with the JAX package's fields; a TSP video encoder is
    written as the reference's `video_encoder` dict (the JAX package's
    `save` leaves it out), so `build_config` reads back `cfg`."""
    dirs = {name: os.path.join(out_dir, name) for name in COMPONENTS}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    llm = cfg.llm
    _write_json({
        "model_type": "qwen2",
        "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_hidden_layers,
        "num_attention_heads": llm.num_attention_heads,
        "num_key_value_heads": llm.num_key_value_heads,
        "head_dim": llm.head_dim,
        "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "max_position_embeddings": llm.max_position_embeddings,
        "torch_dtype": "bfloat16",
    }, os.path.join(dirs["llm"], "config.json"))
    if tokenizer is not None:
        tokenizer.save_pretrained(dirs["llm"])
    _write_json(vision_config(cfg), os.path.join(dirs["vision_tower"], "config.json"))
    _write_json({"model_type": "v2l_projector",
                 "mm_projector_type": cfg.projector.projector_type},
                os.path.join(dirs["mm_projector"], "config.json"))
    _write_json({
        "model_type": "llava",
        "image_aspect_ratio": cfg.image_aspect_ratio,
        "num_video_frames": cfg.num_video_frames,
        "fps": cfg.fps,
        "mm_hidden_size": cfg.projector.mm_hidden_size,
        "mm_vision_select_layer": cfg.vision_feature_layer,
        "mm_vision_select_feature": cfg.vision_select,
        "min_tiles": cfg.min_tiles,
        "max_tiles": cfg.max_tiles,
        "dynamic_s2": cfg.image_aspect_ratio == "dynamic_s2",
        "s2_scales": list(cfg.s2_scales),
        "s2_resize_output_to_scale_idx": cfg.s2_resize_output_to_scale_idx,
        **({"ps3_look_close_mode": cfg.ps3_look_close_mode}
           if cfg.vision_tower_type == "ps3" else {}),
        **({"video_encoder": {"_target_": TSP_TARGET,
                              "pool_sizes": [list(p) for p in cfg.tsp_pool_sizes]}}
           if cfg.video_encoder == "tsp" else {}),
    }, os.path.join(out_dir, "config.json"))


def save(params: Dict[str, Any], cfg: vlm.VLMConfig, tokenizer, out_dir: str) -> int:
    """Save in the reference's component layout: the weights as f32
    safetensors and `save_config`'s files, so that checkpoints round-trip
    between the port, the JAX package and HF tooling. Returns the weight
    bytes written."""
    save_config(cfg, out_dir, tokenizer)
    written = 0
    for name, sd in (("llm", llm_state_dict(params, cfg)),
                     ("vision_tower", vision_state_dict(params, cfg)),
                     ("mm_projector", projector_state_dict(params))):
        written += hf_import.save_safetensors(
            sd, os.path.join(out_dir, name, "model.safetensors"))
    return written
