"""Model loading and saving in VILA's component-wise checkpoint layout, as
`vila_tpu/entry.py`.

A checkpoint is a directory with `llm/`, `vision_tower/` and
`mm_projector/` subdirectories, each an HF model directory (config.json
plus safetensors), and a top-level config.json with the multimodal fields.
`build_config` reads the configs, `load_params` the weights (read with
numpy by `utils.hf_import`, cast to the parameter dtype and placed on the
device), `load` returns a ready `GenerationEngine`, and `save` writes the
same layout back (tensors in f32).

The port serves the SigLIP tower with every aspect mode (plain, dynamic,
dynamic-S2 with its multi-scale projector width), every projector type and
basic or TSP video: a checkpoint that asks for another tower raises
`NotImplementedError` naming the field, rather than loading into a model
that would serve it otherwise.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch

from vila_tpu_torch.conversation import auto_set_conversation_mode
from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import qwen2, siglip, vlm
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
    if tower != "siglip":
        raise NotImplementedError(
            f"vision_tower model_type={vt_hf.get('model_type')!r} ({tower}) is "
            f"not ported yet")
    llm_cfg = qwen2.LLMConfig.from_hf_config(llm_hf, dtype=dtype)
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
    convert = {
        "llm": lambda sd: hf_import.convert_llm_state_dict(sd, cfg.llm),
        "vision_tower": lambda sd: hf_import.convert_siglip_state_dict(sd, cfg.vision),
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
    from transformers import AutoTokenizer

    from vila_tpu_torch.data.tokenizer_utils import add_media_tokens

    tokenizer = AutoTokenizer.from_pretrained(os.path.join(model_path, "llm"))
    add_media_tokens(tokenizer)
    return tokenizer


def load(model_path: str, device="cuda", dtype: Optional[str] = None,
         vision_int8: bool = False, **kwargs):
    """A checkpoint loaded into a ready `GenerationEngine` on `device`
    (default the card; without CUDA it raises). `vision_int8` quantizes the
    SigLIP tower to W8A8 (TinyChat's vision deployment recipe). Other
    keyword arguments go to the engine."""
    from vila_tpu_torch.inference.generate import GenerationEngine

    dev = resolve_device(device)
    auto_set_conversation_mode(model_path)
    cfg = build_config(model_path, dtype=dtype, device=dev)
    params = load_params(model_path, cfg, device=dev)
    if vision_int8:
        params["vision_tower"] = siglip.quantize_siglip_w8a8(params["vision_tower"])
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


def vision_state_dict(params: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """The SigLIP tree -> a stock `SiglipVisionModel` state dict (f32)."""
    if cfg.vision_tower_type != "siglip":
        raise NotImplementedError(
            f"vision_tower_type={cfg.vision_tower_type!r} is not ported yet")
    vp, vcfg = params["vision_tower"], cfg.vision
    p, d = vcfg.patch_size, vcfg.hidden_size
    pk = _f32(vp["patch_embedding"]["kernel"])  # (P*P*3, D)
    vsd = {
        "vision_model.embeddings.patch_embedding.weight":
            pk.reshape(p, p, 3, d).permute(3, 2, 0, 1).contiguous(),
        "vision_model.embeddings.patch_embedding.bias": _f32(vp["patch_embedding"]["bias"]),
        "vision_model.embeddings.position_embedding.weight":
            _f32(vp["position_embedding"]["embedding"]),
    }
    L = vp["layers"]
    for i in range(vcfg.num_hidden_layers):
        pre = f"vision_model.encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            vsd[pre + f"{ln}.weight"] = _f32(L[ln]["scale"][i])
            vsd[pre + f"{ln}.bias"] = _f32(L[ln]["bias"][i])
        for name, hf in (("q_proj", "self_attn.q_proj"), ("k_proj", "self_attn.k_proj"),
                         ("v_proj", "self_attn.v_proj"), ("out_proj", "self_attn.out_proj"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            vsd[pre + hf + ".weight"] = _f32t(L[name]["kernel"][i])
            vsd[pre + hf + ".bias"] = _f32(L[name]["bias"][i])
    vsd["vision_model.post_layernorm.weight"] = _f32(vp["post_layernorm"]["scale"])
    vsd["vision_model.post_layernorm.bias"] = _f32(vp["post_layernorm"]["bias"])
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
    vis = cfg.vision
    _write_json({
        "model_type": "siglip_vision_model",
        "hidden_size": vis.hidden_size,
        "intermediate_size": vis.intermediate_size,
        "num_hidden_layers": vis.num_hidden_layers,
        "num_attention_heads": vis.num_attention_heads,
        "image_size": vis.image_size,
        "patch_size": vis.patch_size,
        "layer_norm_eps": vis.layer_norm_eps,
    }, os.path.join(dirs["vision_tower"], "config.json"))
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
