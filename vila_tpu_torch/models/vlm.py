"""VLM meta-architecture: vision tower + projector + LLM with media splice,
as `vila_tpu/models/vlm.py`, and the training forward over a collated batch
(`forward_batch`; `forward_batch_ps3` for PS3). The tower is SigLIP
(`models/siglip.py`), CLIP, InternViT or RADIO (`models/vit.py`), or PS3
(`models/ps3.py`, VILA-HD's selective high-resolution tower, encoded by
`encode_images_ps3`).
Dynamic-S2 images encode through `models/s2.py`, TSP videos through
`models/encoders.py`.

The host expands each media token into a fixed run of placeholder positions
(plus the encoder's end-token ids); the device scatters the flattened
vision features into those slots of the text embeddings.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import ps3, qwen2, siglip, vit

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    llm: qwen2.LLMConfig
    vision: Any  # SigLIPConfig | vit.ViTConfig | ps3.PS3Config (vision_tower_type)
    projector: projector_lib.ProjectorConfig
    vision_feature_layer: int = -2
    vision_select: str = "cls_patch"
    # resize | pad | crop | dynamic | dynamic_s2 | longest_edge
    image_aspect_ratio: str = "resize"
    # the tower (build_vision_tower, multimodal_encoder/builder.py:30):
    # siglip | clip | internvit | radio | ps3
    vision_tower_type: str = "siglip"
    # PS3's look-close mode (llava_arch.py:1627): "after_image" selects
    # bottom-up; "after_prompt" runs the two-pass top-down generation (a
    # low-res pass gives the prompt embedding that steers the selection)
    ps3_look_close_mode: str = "after_image"
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

    @property
    def tokens_per_image(self) -> int:
        """LLM tokens contributed by one vision-tower forward of one tile."""
        if self.vision_tower_type == "ps3":
            assert self.projector.downsample_rate == 1, (
                "PS3 output mixes grid and selected tokens; use a "
                "non-downsampling projector (linear / mlpNx_gelu)")
            return self.vision.n_output_tokens
        side = self.vision.image_size // self.vision.patch_size
        r = self.projector.downsample_rate
        return ((side + r - 1) // r) ** 2

    @property
    def ps3_tokens_low(self) -> int:
        """Tokens of PS3's low-res pass alone (num_look_close == 0)."""
        return self.vision.low_grid ** 2


def vision_module(cfg: VLMConfig):
    """The tower's module (multimodal_encoder/builder.py:30-68): RADIO's
    backbone is a plain ViT, served by the generic tower."""
    if cfg.vision_tower_type in ("clip", "internvit", "radio"):
        return vit
    if cfg.vision_tower_type == "ps3":
        return ps3
    return siglip


def init_params(generator: torch.Generator, cfg: VLMConfig,
                param_dtype=torch.float32) -> Params:
    return {
        "llm": qwen2.init_params(generator, cfg.llm, param_dtype),
        "vision_tower": vision_module(cfg).init_params(generator, cfg.vision, param_dtype),
        "mm_projector": projector_lib.init_params(generator, cfg.projector, param_dtype),
    }


def encode_images(params: Params, cfg: VLMConfig, pixel_values: torch.Tensor):
    """(N, H, W, 3) pixels -> (N, tokens_per_image, llm_hidden); PS3 towers
    take two pixel scales and encode through `encode_images_ps3`."""
    if cfg.vision_tower_type == "ps3":
        raise ValueError("PS3 towers use encode_images_ps3 (two pixel scales)")
    feats = vision_module(cfg).forward(
        params["vision_tower"], cfg.vision, pixel_values,
        feature_layer=cfg.vision_feature_layer, select=cfg.vision_select,
    )
    return projector_lib.forward(params["mm_projector"], cfg.projector, feats)


def encode_images_ps3(
    params: Params,
    cfg: VLMConfig,
    pixels_low: torch.Tensor,  # (N, s0, s0, 3)
    pixels_high: Optional[Any] = None,  # (N, s1, s1, 3) or a list, one per high scale
    *,
    prompt: Optional[torch.Tensor] = None,  # (N, llm_hidden) top-down prompt
    num_look_close: Optional[int] = None,
    gt_selection_maps: Optional[torch.Tensor] = None,
    smooth_selection_prob: bool = False,
):
    """PS3's selective encode and the projector (encode_images_ps3,
    llava_arch.py:967). Returns (projected features, selection
    probabilities, selection maps)."""
    if pixels_high is not None and not isinstance(pixels_high, (list, tuple)):
        pixels_high = [pixels_high]
    feats, probs, maps = ps3.forward(
        params["vision_tower"], cfg.vision, pixels_low, pixels_high,
        prompt=prompt, num_look_close=num_look_close,
        gt_selection_maps=gt_selection_maps,
        smooth_selection_prob=smooth_selection_prob,
        feature_layer=cfg.vision_feature_layer,
    )
    return projector_lib.forward(params["mm_projector"], cfg.projector, feats), probs, maps


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
    sp: Optional[Any] = None,  # parallel.sp.SPConfig
):
    """Fused multimodal forward. Returns (logits, new_cache). With `sp` the
    arrays are this rank's sequence shard (`qwen2.forward`)."""
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, input_ids)
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values)
        embeds = splice_media(embeds, feats.reshape(-1, feats.shape[-1]), media_positions)
    return qwen2.forward(
        params["llm"], cfg.llm,
        inputs_embeds=embeds, positions=positions, segment_ids=segment_ids,
        token_valid=token_valid, cache=cache, last_token_only=last_token_only,
        gather_position=gather_position, attn_impl=attn_impl, sp=sp,
    )


def _splice_batch(embeds: torch.Tensor, feats: torch.Tensor, batch) -> torch.Tensor:
    """Per-row features (B, M, D) into their row-local media positions."""
    b, s = embeds.shape[:2]
    mp = batch["media_positions"].to(embeds.device).long()
    # row-local -> global flat indices; the sentinels stay out of range
    offsets = (torch.arange(b, device=mp.device) * s)[:, None]
    global_pos = torch.where(mp < s, mp + offsets, b * s)
    return splice_media(embeds, feats.reshape(-1, feats.shape[-1]), global_pos.reshape(-1))


def forward_batch(params: Params, cfg: VLMConfig, batch: Dict[str, torch.Tensor], *,
                  attn_impl: str = "auto", return_hidden: bool = False,
                  sp: Optional[Any] = None) -> torch.Tensor:
    """Training forward over a collated batch (`data/collate.py`). Returns
    logits (B, S, V), or the final hidden states (B, S, D) with
    `return_hidden` (for the chunked cross entropy). A PS3 config runs
    `forward_batch_ps3`.

    Batch: input_ids, positions, segment_ids (B, S); pixel_values
    (B, T, s, s, 3) per-sample tiles; media_positions (B, M) row-local flat
    indices with an out-of-range sentinel for padding, M = T *
    tokens_per_image. `attn_impl` picks the LLM's attention route. With
    `sp` (an active `parallel.sp.SPConfig`) the batch is this rank's shard
    (`parallel.distributed.host_local_batch`): its media positions local
    to its sequence slice, the LLM's attention sequence parallel."""
    if cfg.vision_tower_type == "ps3":
        out, _ = forward_batch_ps3(params, cfg, batch, attn_impl=attn_impl,
                                   return_hidden=return_hidden, sp=sp)
        return out
    input_ids = batch["input_ids"]
    b = input_ids.shape[0]
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, input_ids)
    pixels = batch.get("pixel_values")
    if pixels is not None:
        feats = encode_images(params, cfg, pixels.reshape((-1,) + pixels.shape[2:]))
        embeds = _splice_batch(embeds, feats.reshape(b, -1, feats.shape[-1]), batch)
    out, _ = qwen2.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds,
        positions=batch.get("positions"), segment_ids=batch.get("segment_ids"),
        attn_impl=attn_impl, return_hidden=return_hidden, sp=sp,
    )
    return out


def forward_batch_ps3(params: Params, cfg: VLMConfig, batch: Dict[str, Any], *,
                      attn_impl: str = "auto", return_hidden: bool = False,
                      num_look_close: Optional[int] = None, sp: Optional[Any] = None
                      ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """PS3 training forward: bottom-up look-close selection, teacher-forced
    by the gt maps when the batch has them (the reference's "after_image"
    training path, llava_trainer.py:917-998). Returns (logits or hidden,
    selection_probs) for the token-selection loss.

    Extra batch keys: pixel_values_high (B, T, s1, s1, 3), or a list with
    one such array a high scale; gt_selection_maps (B, T, gh, gw) binary,
    optional."""
    input_ids = batch["input_ids"]
    b = input_ids.shape[0]
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, input_ids)
    sel_probs: List[torch.Tensor] = []
    pixels = batch.get("pixel_values")
    if pixels is not None:
        bt = pixels.shape[0] * pixels.shape[1]
        high = batch.get("pixel_values_high")
        if high is not None:
            high = [h.reshape((bt,) + h.shape[2:])
                    for h in (high if isinstance(high, (list, tuple)) else [high])]
        gt = batch.get("gt_selection_maps")
        if gt is not None:
            gt = gt.reshape((bt,) + gt.shape[2:])
        feats, sel_probs, _ = encode_images_ps3(
            params, cfg, pixels.reshape((bt,) + pixels.shape[2:]), high,
            gt_selection_maps=gt, num_look_close=num_look_close,
            smooth_selection_prob=False)
        embeds = _splice_batch(embeds, feats.reshape(b, -1, feats.shape[-1]), batch)
    out, _ = qwen2.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds,
        positions=batch.get("positions"), segment_ids=batch.get("segment_ids"),
        attn_impl=attn_impl, return_hidden=return_hidden, sp=sp,
    )
    return out, sel_probs
