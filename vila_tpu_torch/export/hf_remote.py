"""Single-repo HF export, as `vila_tpu/export/hf_remote.py`: one
`trust_remote_code` artifact any transformers consumer can load (capability
of llava/remote_code/modeling_vila.py:229,506 and auto_processor.py:148).

`export_hf_repo(params, cfg, tokenizer, out_dir)` writes:

  out_dir/
    config.json            model_type "vila" + auto_map + sub-configs +
                           projector spec (the Sequential as data)
    model.safetensors      llm.* / vision_tower.* / mm_projector.* weights
                           (f32, written by `utils.hf_import`)
    modeling_vila.py       self-contained torch remote code (the port's
                           copy, `export/remote_code/modeling_vila.py`)
    tokenizer files        through the tokenizer's `save_pretrained`

Then, wherever `transformers` is installed:

    from transformers import AutoModel
    model = AutoModel.from_pretrained(out_dir, trust_remote_code=True)

The remote code is data to this package: it imports `transformers`, so it
sits in a directory without `__init__.py` and the port never imports it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

import torch

from vila_tpu_torch import entry
from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import vlm

REMOTE_CODE = os.path.join(os.path.dirname(__file__), "remote_code", "modeling_vila.py")
WEIGHTS = "model.safetensors"


def _llm_config_dict(cfg: vlm.VLMConfig) -> Dict[str, Any]:
    llm = cfg.llm
    return {
        "model_type": "qwen2",
        "vocab_size": llm.vocab_size,
        "hidden_size": llm.hidden_size,
        "intermediate_size": llm.intermediate_size,
        "num_hidden_layers": llm.num_hidden_layers,
        "num_attention_heads": llm.num_attention_heads,
        "num_key_value_heads": llm.num_key_value_heads,
        "rope_theta": llm.rope_theta,
        "rms_norm_eps": llm.rms_norm_eps,
        "tie_word_embeddings": llm.tie_word_embeddings,
        "max_position_embeddings": llm.max_position_embeddings,
        "attn_implementation": "eager",
        **({"head_dim": llm.head_dim} if llm.head_dim else {}),
    }


def _vision_config_dict(cfg: vlm.VLMConfig) -> Dict[str, Any]:
    """The vision sub-config: SigLIP as the stock `SiglipVisionModel`, PS3
    as its SigLIP trunk alone (the top-down selection heads stay in the
    package), CLIP / InternViT / RADIO as the remote code's own
    `VILAGenericViT` (`model_type: "vila_vit"`): transformers has no
    stock class for them."""
    vis = cfg.vision
    if cfg.vision_tower_type in ("clip", "internvit", "radio"):
        return {
            "model_type": "vila_vit",
            "source_tower": cfg.vision_tower_type,
            "hidden_size": vis.hidden_size,
            "intermediate_size": vis.intermediate_size,
            "num_hidden_layers": vis.num_hidden_layers,
            "num_attention_heads": vis.num_attention_heads,
            "image_size": vis.image_size,
            "patch_size": vis.patch_size,
            "layer_norm_eps": vis.layer_norm_eps,
            "hidden_act": vis.hidden_act,
            "class_token": vis.class_token,
            "pre_layernorm": vis.pre_layernorm,
            "layer_scale": vis.layer_scale,
            "qk_norm": vis.qk_norm,
        }
    if cfg.vision_tower_type == "ps3":
        vis = cfg.vision.vit
    return {
        "model_type": "siglip_vision_model",
        # skip the SigLIP pooling head: features come from hidden_states
        "vision_use_head": False,
        **({"ps3_trunk_only": True} if cfg.vision_tower_type == "ps3" else {}),
        "hidden_size": vis.hidden_size,
        "intermediate_size": vis.intermediate_size,
        "num_hidden_layers": vis.num_hidden_layers,
        "num_attention_heads": vis.num_attention_heads,
        "image_size": (cfg.vision.s3_scales[0] if cfg.vision_tower_type == "ps3"
                       else vis.image_size),
        "patch_size": vis.patch_size,
        "layer_norm_eps": vis.layer_norm_eps,
        "attn_implementation": "eager",
    }


def _vis_stats(cfg: vlm.VLMConfig):
    """(image_mean, image_std): PS3Config keeps them on its trunk."""
    vis = cfg.vision.vit if cfg.vision_tower_type == "ps3" else cfg.vision
    return vis.image_mean, vis.image_std


def export_config(cfg: vlm.VLMConfig) -> Dict[str, Any]:
    """The export's config.json as a dict."""
    mean, std = _vis_stats(cfg)
    return {
        "model_type": "vila",
        "architectures": ["VILAForCausalLM"],
        "auto_map": {
            "AutoConfig": "modeling_vila.VILAConfig",
            "AutoModel": "modeling_vila.VILAForCausalLM",
            "AutoModelForCausalLM": "modeling_vila.VILAForCausalLM",
            "AutoProcessor": "modeling_vila.VILAProcessor",
        },
        "llm_config": _llm_config_dict(cfg),
        "vision_config": _vision_config_dict(cfg),
        "projector_spec": [list(row) for row in projector_lib.build_spec(cfg.projector)],
        "vision_feature_layer": cfg.vision_feature_layer,
        "vision_select": cfg.vision_select,
        # PS3 exports its trunk alone: an image spends only its low-res tokens
        "tokens_per_image": (cfg.ps3_tokens_low if cfg.vision_tower_type == "ps3"
                             else cfg.tokens_per_image),
        "image_token": MEDIA_TOKENS["image"],
        "image_size": cfg.vision.image_size,
        "image_mean": list(mean),
        "image_std": list(std),
        "torch_dtype": "bfloat16",
    }


def export_state_dict(params: Dict[str, Any], cfg: vlm.VLMConfig) -> Dict[str, torch.Tensor]:
    """The export's one flat state dict (f32, on the host): `llm.*` an HF
    Qwen2, `vision_tower.*` a stock `SiglipVisionModel` (SigLIP, PS3's
    trunk) or `VILAGenericViT` (CLIP, InternViT, RADIO), `mm_projector.*`
    the projector Sequential. Each leaf is copied to the host once."""
    if cfg.vision_tower_type in ("clip", "internvit", "radio"):
        vsd = entry.generic_vit_state_dict(params["vision_tower"], cfg.vision.num_hidden_layers)
    elif cfg.vision_tower_type == "ps3":
        vsd = entry.siglip_state_dict(params["vision_tower"]["vit"], cfg.vision.vit)
    else:
        vsd = entry.siglip_state_dict(params["vision_tower"], cfg.vision)
    sd = {f"llm.{k}": v for k, v in entry.llm_state_dict(params, cfg).items()}
    sd.update((f"vision_tower.{k}", v) for k, v in vsd.items())
    sd.update((f"mm_projector.{k}", v) for k, v in entry.projector_state_dict(params).items())
    return sd


def export_hf_repo(params: Dict[str, Any], cfg: vlm.VLMConfig, tokenizer, out_dir: str) -> str:
    from vila_tpu_torch.utils.hf_import import save_safetensors

    os.makedirs(out_dir, exist_ok=True)
    save_safetensors(export_state_dict(params, cfg), os.path.join(out_dir, WEIGHTS))
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(export_config(cfg), f, indent=2)
    shutil.copy(REMOTE_CODE, os.path.join(out_dir, "modeling_vila.py"))
    if tokenizer is not None:
        tokenizer.save_pretrained(out_dir)
    return out_dir
