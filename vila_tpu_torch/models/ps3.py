"""PS3 / VILA-HD: the multi-scale vision tower with top-down token
selection, as `vila_tpu/models/ps3.py` (capability parity: the reference's
`encode_images_ps3` and two-pass generation, llava_arch.py:966-1685, and
the top-down prompt head, base_projector.py:226-238).

  * Pass 1 encodes the low-resolution view through a SigLIP trunk
    (`siglip.embed_pixels` / `encode_tokens`): the selection basis.
  * Selection scores: a bottom-up saliency head over the low-res features
    upsampled to each high-res grid, plus, given a prompt (the LLM's hidden
    state at the end of the user prompt), its projection dotted with the
    features. Every high scale selects a fixed K = num_hires_select x
    num_look_close patches.
  * The whole high-res grid goes through the patch embedding as one GEMM;
    the K selected rows are gathered and given the scale embedding.
  * Pass 2 runs the trunk once over [low tokens ++ selected tokens].

The top-k keeps JAX's order (`jax.lax.top_k`): by descending score, and
among equal scores the lower index first. Equal scores are the rule here,
not the exception: each low-res cell's features are repeated over its
block of the high-res grid. So the order comes from a stable descending
sort, not from `torch.topk`, which promises no order among ties.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from vila_tpu_torch.models import siglip

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PS3Config:
    """`vit.image_size` is the base (low-res) scale, `s3_scales[0]`."""

    vit: siglip.SigLIPConfig
    s3_scales: Tuple[int, ...] = (448, 896)  # low -> high (VILA-HD: 378/756/1512)
    num_hires_select: int = 64  # K tokens per look-close pass per high scale
    num_look_close: int = 1
    prompt_dim: int = 0  # the LLM's hidden size; 0: no top-down head

    @property
    def hidden_size(self) -> int:
        return self.vit.hidden_size

    @property
    def image_size(self) -> int:  # the low-res scale (the preprocessor's base)
        return self.s3_scales[0]

    @property
    def patch_size(self) -> int:
        return self.vit.patch_size

    @property
    def dtype(self) -> str:
        return self.vit.dtype

    @property
    def compute_dtype(self) -> torch.dtype:
        return self.vit.compute_dtype

    @property
    def low_grid(self) -> int:
        return self.s3_scales[0] // self.vit.patch_size

    def hi_grid(self, i: int) -> int:
        return self.s3_scales[i] // self.vit.patch_size

    @property
    def k_per_scale(self) -> int:
        return self.num_hires_select * max(self.num_look_close, 1)

    @property
    def n_output_tokens(self) -> int:
        """The low-res grid plus K selected tokens per high scale."""
        return self.low_grid ** 2 + self.k_per_scale * (len(self.s3_scales) - 1)

    @classmethod
    def from_hf_config(cls, hf: dict, **overrides) -> "PS3Config":
        """A PS3 checkpoint's vision config: the `ps3` package's open_clip
        names (width, layers, heads, mlp_ratio) or HF ones (the save path
        writes those)."""
        vis = hf.get("vision_config") or hf
        width = vis.get("hidden_size") or vis.get("width") or 1152
        scales = tuple(vis.get("ps3_scales") or vis.get("s3_scales")
                       or hf.get("ps3_scales") or (378, 756, 1512))
        vit_cfg = siglip.SigLIPConfig(
            hidden_size=width,
            intermediate_size=vis.get("intermediate_size") or int(
                width * vis.get("mlp_ratio", 3.7362)),
            num_hidden_layers=vis.get("num_hidden_layers") or vis.get("layers") or 27,
            num_attention_heads=vis.get("num_attention_heads") or vis.get("heads") or 16,
            image_size=scales[0],
            patch_size=vis.get("patch_size") or 14,
            layer_norm_eps=vis.get("layer_norm_eps", 1e-6),
            dtype=overrides.pop("dtype", "float32"),
        )
        kw = dict(
            vit=vit_cfg,
            s3_scales=scales,
            num_hires_select=(vis.get("num_hires_select") or hf.get("num_hires_select")
                              or 64),
            num_look_close=hf.get("num_look_close", 1),
        )
        kw.update(overrides)
        return cls(**kw)


def init_params(generator: torch.Generator, cfg: PS3Config,
                param_dtype=torch.float32) -> Params:
    """Random parameters on the generator's device: the trunk as
    `siglip.init_params`, normal(0.02) scale embeddings and heads."""
    D = cfg.vit.hidden_size
    dev = generator.device

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator, device=dev)).to(param_dtype)

    vit_cfg = dataclasses.replace(cfg.vit, image_size=cfg.s3_scales[0])
    params: Params = {
        "vit": siglip.init_params(generator, vit_cfg, param_dtype),
        "scale_embedding": dense(len(cfg.s3_scales), D),
        "select_head": {"kernel": dense(D, 1),
                        "bias": torch.zeros((1,), dtype=param_dtype, device=dev)},
    }
    if cfg.prompt_dim:
        # the reference's projector holds it (base_projector.py:227): LLM
        # hidden -> vision hidden, dotted with the patch features
        params["top_down_prompt_head"] = {
            "kernel": dense(cfg.prompt_dim, D),
            "bias": torch.zeros((D,), dtype=param_dtype, device=dev)}
    return params


def _upsample_grid(x: torch.Tensor, g_from: int, g_to: int) -> torch.Tensor:
    """(N, g_from², D) -> (N, g_to², D), nearest-neighbour grid upsample."""
    assert g_to % g_from == 0, (g_from, g_to)
    r = g_to // g_from
    n, _, d = x.shape
    x = x.reshape(n, g_from, g_from, d)
    x = x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
    return x.reshape(n, g_to * g_to, d)


def selection_logits(params: Params, cfg: PS3Config, low_feats: torch.Tensor, g_hi: int,
                     prompt: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, g_hi²) selection logits of pass-1 features (N, low_grid², D):
    bottom-up saliency, plus the top-down match when `prompt` (N,
    prompt_dim) is given and the head exists."""
    dtype = cfg.compute_dtype
    f = _upsample_grid(low_feats, cfg.low_grid, g_hi).to(dtype)
    head = params["select_head"]
    logits = (f @ head["kernel"].to(dtype))[..., 0] + head["bias"].to(dtype)[0]
    if prompt is not None and "top_down_prompt_head" in params:
        hd = params["top_down_prompt_head"]
        p = prompt.to(dtype) @ hd["kernel"].to(dtype) + hd["bias"].to(dtype)  # (N, D)
        # JAX divides by sqrt(D) rounded to the compute dtype
        root = float(torch.tensor(f.shape[-1], dtype=dtype).sqrt())
        logits = logits + torch.einsum("ntd,nd->nt", f, p) / root
    return logits


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """(N, T) scores -> (N, k) int64 indices in `jax.lax.top_k`'s order: by
    descending score, equal scores by ascending index."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[:, :k]


def forward(
    params: Params,
    cfg: PS3Config,
    pixels_low: torch.Tensor,  # (N, s0, s0, 3)
    pixels_high: Optional[List[torch.Tensor]] = None,  # [(N, s_i, s_i, 3)]
    *,
    prompt: Optional[torch.Tensor] = None,  # (N, prompt_dim)
    num_look_close: Optional[int] = None,  # 0: the low-res pass alone
    gt_selection_maps: Optional[torch.Tensor] = None,  # (N, gh, gw) binary
    smooth_selection_prob: bool = False,
    feature_layer: int = -2,
    attn_impl: str = "auto",
    tp=None,  # parallel.tensor_parallel.TPConfig: the trunk's tp chunks
) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """Selective multi-scale encode. Returns (features, selection_probs,
    selection_maps):
      features        (N, n_output_tokens, D), or (N, low_grid², D) when
                      num_look_close == 0 (the pass that feeds the top-down
                      prompt, llava_arch.py:1165);
      selection_probs [(N, g_i, g_i) f32] per high scale;
      selection_maps  [(N, g_i, g_i) bool], the chosen tokens per high scale.
    `gt_selection_maps` puts the marked patches first (the probabilities
    break their ties); `smooth_selection_prob` scales each selected token by
    its probability."""
    nlc = cfg.num_look_close if num_look_close is None else num_look_close
    dtype = cfg.compute_dtype
    vit_cfg = dataclasses.replace(cfg.vit, image_size=cfg.s3_scales[0])
    vparams = params["vit"]
    scale_emb = params["scale_embedding"].to(dtype)

    # pass 1: the low-res trunk, the selection basis
    tokens_low = siglip.embed_pixels(vparams, vit_cfg, pixels_low) + scale_emb[0]
    low_feats = siglip.encode_tokens(vparams, vit_cfg, tokens_low,
                                     feature_layer=feature_layer, attn_impl=attn_impl, tp=tp)
    n = pixels_low.shape[0]
    probs_all: List[torch.Tensor] = []
    maps_all: List[torch.Tensor] = []
    if nlc == 0 or len(cfg.s3_scales) == 1:
        # low-res only; the probabilities are still reported
        for i in range(1, len(cfg.s3_scales)):
            g = cfg.hi_grid(i)
            logits = selection_logits(params, cfg, low_feats, g, prompt)
            probs_all.append(torch.sigmoid(logits.float()).reshape(-1, g, g))
            maps_all.append(torch.zeros((n, g, g), dtype=torch.bool, device=low_feats.device))
        return low_feats, probs_all, maps_all

    assert pixels_high is not None and len(pixels_high) == len(cfg.s3_scales) - 1
    k = cfg.num_hires_select * nlc
    parts = [tokens_low]
    for i in range(1, len(cfg.s3_scales)):
        g = cfg.hi_grid(i)
        probs = torch.sigmoid(selection_logits(params, cfg, low_feats, g, prompt).float())
        probs_all.append(probs.reshape(n, g, g))
        score = probs
        if gt_selection_maps is not None:
            # teacher forcing: the marked patches first, the probability as tie-break
            gt = _area_resize(gt_selection_maps.float(), g, g).reshape(n, -1)
            score = probs + torch.where(gt > 0, 2.0, 0.0)
        idx = top_k_indices(score, k)
        sel_map = torch.zeros((n, g * g), dtype=torch.bool, device=probs.device)
        maps_all.append(sel_map.scatter(1, idx, True).reshape(n, g, g))

        # the whole high-res grid through the patch embedding (one GEMM),
        # then the K selected rows
        patches = siglip.patchify(siglip.normalize_pixels(pixels_high[i - 1], cfg.vit),
                                  cfg.vit.patch_size)
        emb = siglip._linear(patches, vparams["patch_embedding"], dtype)
        pos = siglip.resize_position_embedding(vparams["position_embedding"]["embedding"],
                                               g * g).to(dtype)
        emb = emb + pos[None]
        sel = emb.gather(1, idx[..., None].expand(n, k, emb.shape[-1])) + scale_emb[i]
        if smooth_selection_prob:
            # scaled by its probability: the LM loss reaches the selector
            sel = sel * probs.gather(1, idx).to(dtype)[..., None]
        parts.append(sel)

    # pass 2: the trunk over [low tokens ++ selected high-res tokens]
    feats = siglip.encode_tokens(vparams, vit_cfg, torch.cat(parts, dim=1),
                                 feature_layer=feature_layer, attn_impl=attn_impl, tp=tp)
    return feats, probs_all, maps_all


def _area_resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(N, H, W) -> (N, h, w) area-average resize at an integer ratio
    either way (`F.interpolate(mode="area")`, llava_trainer.py:905)."""
    n, H, W = x.shape
    if (H, W) == (h, w):
        return x
    if H % h == 0 and W % w == 0:
        return x.reshape(n, h, H // h, w, W // w).mean(dim=(2, 4))
    if h % H == 0 and w % W == 0:
        return x.repeat_interleave(h // H, dim=1).repeat_interleave(w // W, dim=2)
    raise ValueError(f"non-integer area resize {(H, W)} -> {(h, w)}")
