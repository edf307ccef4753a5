"""VLM meta-architecture: vision tower + projector + LLM with media splice,
as `vila_tpu/models/vlm.py` (the SigLIP tower; the other towers and PS3
are not ported yet), and the training forward over a collated batch
(`forward_batch`). Dynamic-S2 images encode through `models/s2.py`, TSP
videos through `models/encoders.py`.

The host expands each media token into a fixed run of placeholder positions
(plus the encoder's end-token ids); the device scatters the flattened
vision features into those slots of the text embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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
    # resize | pad | crop | dynamic | dynamic_s2 | longest_edge
    image_aspect_ratio: str = "resize"
    vision_tower_type: str = "siglip"  # the other towers (PS3, ...) come later
    num_video_frames: int = 8
    fps: float = 0.0
    # video token assembly (llava/model/encoders/video/): "basic" splices
    # every frame as an image; "tsp" mean-pools frames (models/encoders.py)
    video_encoder: str = "basic"
    tsp_pool_sizes: Tuple[Tuple[int, int, int], ...] = ((1, 1, 1),)
    # dynamic tiling (mm_utils.py:299-405)
    min_tiles: int = 1
    max_tiles: int = 12
    # dynamic-S2
    s2_scales: Tuple[int, ...] = (448, 896, 1344)
    s2_resize_output_to_scale_idx: int = 0

    def __post_init__(self):
        if self.vision_tower_type != "siglip":
            raise NotImplementedError(
                f"vision_tower_type={self.vision_tower_type!r} is not ported yet")

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
    """Scatter media embeddings into their placeholder slots (a new tensor).
    Dropped rows land in one spare row past the end, so nothing waits for
    the device to learn which positions are kept."""
    b, s, d = text_embeds.shape
    flat = torch.cat([text_embeds.reshape(b * s, d),
                      text_embeds.new_zeros((1, d))])
    pos = media_positions.to(flat.device).long().clamp(max=b * s)
    flat = flat.index_copy(0, pos, media_embeds.to(flat.dtype))
    return flat[:b * s].reshape(b, s, d)


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


def forward_batch(params: Params, cfg: VLMConfig, batch: Dict[str, torch.Tensor], *,
                  attn_impl: str = "auto", return_hidden: bool = False) -> torch.Tensor:
    """Training forward over a collated batch (`data/collate.py`). Returns
    logits (B, S, V), or the final hidden states (B, S, D) with
    `return_hidden` (for the chunked cross entropy).

    Batch: input_ids, positions, segment_ids (B, S); pixel_values
    (B, T, s, s, 3) per-sample tiles; media_positions (B, M) row-local flat
    indices with an out-of-range sentinel for padding, M = T *
    tokens_per_image. `attn_impl` picks the LLM's attention route."""
    input_ids = batch["input_ids"]
    b, s = input_ids.shape
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, input_ids)
    pixels = batch.get("pixel_values")
    if pixels is not None:
        feats = encode_images(params, cfg, pixels.reshape((-1,) + pixels.shape[2:]))
        feats = feats.reshape(b, -1, feats.shape[-1])  # (B, M, D)
        mp = batch["media_positions"].to(embeds.device).long()
        # row-local -> global flat indices; the sentinels stay out of range
        offsets = (torch.arange(b, device=mp.device) * s)[:, None]
        global_pos = torch.where(mp < s, mp + offsets, b * s)
        embeds = splice_media(embeds, feats.reshape(-1, feats.shape[-1]),
                              global_pos.reshape(-1))
    out, _ = qwen2.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds,
        positions=batch.get("positions"), segment_ids=batch.get("segment_ids"),
        attn_impl=attn_impl, return_hidden=return_hidden,
    )
    return out
