"""VLM meta-architecture: vision tower + projector + LLM with media splice,
as `vila_tpu/models/vlm.py` (the SigLIP tower with plain images; the
other towers, S2, PS3 and video are not ported yet).

The host expands each media token into a fixed run of placeholder positions
(plus the encoder's end-token ids); the device scatters the flattened
vision features into those slots of the text embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import qwen2, siglip

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    llm: qwen2.LLMConfig
    vision: siglip.SigLIPConfig
    projector: projector_lib.ProjectorConfig
    vision_feature_layer: int = -2
    vision_select: str = "cls_patch"
    image_aspect_ratio: str = "resize"  # resize | pad

    @property
    def tokens_per_image(self) -> int:
        """LLM tokens contributed by one vision-tower forward of one tile."""
        side = self.vision.image_size // self.vision.patch_size
        r = self.projector.downsample_rate
        return ((side + r - 1) // r) ** 2


def init_params(generator: torch.Generator, cfg: VLMConfig,
                param_dtype=torch.float32) -> Params:
    return {
        "llm": qwen2.init_params(generator, cfg.llm, param_dtype),
        "vision_tower": siglip.init_params(generator, cfg.vision, param_dtype),
        "mm_projector": projector_lib.init_params(generator, cfg.projector, param_dtype),
    }


def encode_images(params: Params, cfg: VLMConfig, pixel_values: torch.Tensor):
    """(N, H, W, 3) pixels -> (N, tokens_per_image, llm_hidden)."""
    feats = siglip.forward(
        params["vision_tower"], cfg.vision, pixel_values,
        feature_layer=cfg.vision_feature_layer, select=cfg.vision_select,
    )
    return projector_lib.forward(params["mm_projector"], cfg.projector, feats)


def splice_media(
    text_embeds: torch.Tensor,  # (B, S, D)
    media_embeds: torch.Tensor,  # (M, D) flattened media features in order
    media_positions: torch.Tensor,  # (M,) flat indices into B*S; >= B*S drops
) -> torch.Tensor:
    """Scatter media embeddings into their placeholder slots (a new tensor)."""
    b, s, d = text_embeds.shape
    flat = text_embeds.reshape(b * s, d).clone()
    pos = media_positions.to(flat.device).long()
    keep = pos < b * s
    flat[pos[keep]] = media_embeds[keep].to(flat.dtype)
    return flat.reshape(b, s, d)


def forward(
    params: Params,
    cfg: VLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, S) with media placeholders expanded
    pixel_values: Optional[torch.Tensor] = None,  # (N, H, W, 3)
    media_positions: Optional[torch.Tensor] = None,  # (M,) flat indices
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    token_valid: Optional[torch.Tensor] = None,
    cache: Optional[Params] = None,
    last_token_only: bool = False,
    gather_position: Optional[torch.Tensor] = None,
    attn_impl: str = "auto",
):
    """Fused multimodal forward. Returns (logits, new_cache)."""
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, input_ids)
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values)
        embeds = splice_media(embeds, feats.reshape(-1, feats.shape[-1]), media_positions)
    return qwen2.forward(
        params["llm"], cfg.llm,
        inputs_embeds=embeds, positions=positions, segment_ids=segment_ids,
        token_valid=token_valid, cache=cache, last_token_only=last_token_only,
        gather_position=gather_position, attn_impl=attn_impl,
    )
