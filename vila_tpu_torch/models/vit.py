"""Generic pre-norm ViT tower: CLIP, InternViT and RADIO, as
`vila_tpu/models/vit.py` (capability parity: the reference's
`CLIPVisionTower`, `InternVisionTower` and `RADIOVisionTower`, dispatched by
`build_vision_tower`, multimodal_encoder/builder.py:30-68; features as
`VisionTower.feature_select`, vision_encoder.py:44-52).

One parameterised tower covers them all:
  * CLIP: class token, learned position embeddings (N+1), pre-embed
    LayerNorm, quick_gelu MLP;
  * InternViT: class token, layer-scale residual weights (ls1/ls2),
    optional qk normalization (RMSNorm over the full width), gelu MLP;
  * RADIO: a timm ViT (class token, gelu, no pre-norm), its widths from the
    timm model name (`_TIMM_VIT_DIMS`).

As in the SigLIP tower, the patch convolution is one matmul on
pre-patchified pixels, layer parameters are stacked on a leading axis, and
`feature_layer` runs only the layers it needs. The encoder's linear layers
take the same W8A8 slot as SigLIP's (`quantize_vit_w8a8`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from vila_tpu_torch.models.siglip import normalize_pixels, patchify, resize_position_embedding
from vila_tpu_torch.ops.attention import multi_head_attention
from vila_tpu_torch.ops.norms import layer_norm, rms_norm
from vila_tpu_torch.ops.quant import quantize_w8a8, w8a8_linear

Params = Dict[str, Any]

# the encoder's linear layers (the W8A8 slots of `quantize_vit_w8a8`)
LINEARS = ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"  # quick_gelu (CLIP) | gelu (InternViT, RADIO)
    class_token: bool = True
    pre_layernorm: bool = True  # CLIP's pre_layrnorm
    layer_scale: bool = False  # InternViT's ls1/ls2
    qk_norm: bool = False  # InternViT's qk normalization
    dtype: str = "float32"
    image_mean: Tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + (1 if self.class_token else 0)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def from_hf_config(cls, hf: dict, **overrides) -> "ViTConfig":
        """A CLIP vision config, or InternViT's (`model_type` holds
        "intern")."""
        kw = dict(
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            image_size=hf["image_size"],
            patch_size=hf["patch_size"],
            num_channels=hf.get("num_channels", 3),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
            hidden_act=hf.get("hidden_act", "quick_gelu"),
        )
        if "intern" in hf.get("model_type", "clip_vision_model"):
            kw.update(
                hidden_act=hf.get("hidden_act", "gelu"),
                layer_scale=True,
                qk_norm=hf.get("qk_normalization", False),
                pre_layernorm=False,
                image_mean=(0.485, 0.456, 0.406),
                image_std=(0.229, 0.224, 0.225),
            )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def from_radio_config(cls, hf: dict, **overrides) -> "ViTConfig":
        """A RADIO tower's config (multimodal_encoder/radio_encoder.py): the
        HF-hub config names a timm model under `args.model`, whose widths
        come from `_TIMM_VIT_DIMS`, unless the config carries them itself
        (`hidden_size`, ...: the save path writes those)."""
        args = hf.get("args") or {}
        name = args.get("model") or hf.get("model") or ""
        dims = next((d for timm_name, d in _TIMM_VIT_DIMS.items()
                     if name.startswith(timm_name)), None)
        if dims is None and "hidden_size" not in hf:
            raise ValueError(
                f"unknown RADIO timm model {name!r} and no direct dims in config")
        hidden, inter, layers, heads = dims or (None,) * 4
        pref = hf.get("preferred_resolution") or [432, 432]
        kw = dict(
            hidden_size=hf.get("hidden_size", hidden),
            intermediate_size=hf.get("intermediate_size", inter),
            num_hidden_layers=hf.get("num_hidden_layers", layers),
            num_attention_heads=hf.get("num_attention_heads", heads),
            image_size=hf.get("image_size") or (
                pref[0] if isinstance(pref, (list, tuple)) else pref),
            patch_size=hf.get("patch_size") or (14 if "patch14" in name else 16),
            hidden_act="gelu",
            pre_layernorm=False,
            layer_norm_eps=hf.get("layer_norm_eps", 1e-6),
            image_mean=(0.485, 0.456, 0.406),
            image_std=(0.229, 0.224, 0.225),
        )
        kw.update(overrides)
        return cls(**kw)


# timm VisionTransformer widths: name prefix -> (hidden, mlp, layers, heads)
_TIMM_VIT_DIMS = {
    "vit_small_patch16": (384, 1536, 12, 6),
    "vit_base_patch16": (768, 3072, 12, 12),
    "vit_base_patch14": (768, 3072, 12, 12),
    "vit_large_patch16": (1024, 4096, 24, 16),
    "vit_large_patch14": (1024, 4096, 24, 16),
    "vit_huge_patch16": (1280, 5120, 32, 16),
    "vit_huge_patch14": (1280, 5120, 32, 16),
}


def init_params(generator: torch.Generator, cfg: ViTConfig,
                param_dtype=torch.float32) -> Params:
    """Random parameters (normal(0.02) kernels, unit norms, zero biases,
    layer scales 0.1) on the generator's device. Stacked kernels are drawn
    one layer at a time into the stack, so the f32 draw of one layer is the
    only temporary (InternViT-6B is ≈ 11.8 GB in bf16)."""
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels
    dev = generator.device

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator, device=dev)).to(param_dtype)

    def full(value, *shape):
        return torch.full(shape, value, dtype=param_dtype, device=dev)

    def ln(*shape):
        return {"scale": full(1.0, *shape), "bias": full(0.0, *shape)}

    def proj(din, dout):
        kernel = torch.empty((L, din, dout), dtype=param_dtype, device=dev)
        for l in range(L):
            kernel[l] = dense(din, dout)
        return {"kernel": kernel, "bias": full(0.0, L, dout)}

    layers = {
        "layer_norm1": ln(L, D),
        "q_proj": proj(D, D),
        "k_proj": proj(D, D),
        "v_proj": proj(D, D),
        "out_proj": proj(D, D),
        "layer_norm2": ln(L, D),
        "fc1": proj(D, I),
        "fc2": proj(I, D),
    }
    if cfg.layer_scale:
        layers["ls1"] = {"scale": full(0.1, L, D)}
        layers["ls2"] = {"scale": full(0.1, L, D)}
    if cfg.qk_norm:
        layers["q_norm"] = {"scale": full(1.0, L, D)}
        layers["k_norm"] = {"scale": full(1.0, L, D)}
    params: Params = {
        "patch_embedding": {"kernel": dense(patch_in, D)},
        "position_embedding": {"embedding": dense(cfg.num_positions, D)},
        "layers": layers,
    }
    if cfg.class_token:
        params["class_embedding"] = dense(D)
    if cfg.pre_layernorm:
        params["pre_layernorm"] = ln(D)
    params["post_layernorm"] = ln(D)
    return params


def _linear(x, p, dtype):
    if "w8" in p:  # W8A8 slot (quantize_vit_w8a8)
        return w8a8_linear(x, p, dtype)
    y = x @ p["kernel"].to(dtype)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def quantize_vit_w8a8(params: Params) -> Params:
    """W8A8 for the generic ViT towers, TinyChat's vision recipe as
    `siglip.quantize_siglip_w8a8`: the encoder's linear layers become
    {w8, w_scale[, bias]} slots (per output channel, so quantized one layer
    at a time: the same bytes as the whole stack at once); norms, layer
    scales, the patch matmul, position and class embeddings stay in the
    compute dtype."""
    src = params["layers"]
    layers: Params = dict(src)
    for name in LINEARS:
        kernel = src[name]["kernel"]
        per_layer = [quantize_w8a8(kernel[l]) for l in range(kernel.shape[0])]
        slot = {k: torch.stack([q[k] for q in per_layer]) for k in ("w8", "w_scale")}
        if "bias" in src[name]:
            slot["bias"] = src[name]["bias"]
        layers[name] = slot
    return {**params, "layers": layers}


def _act(x, kind: str):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return torch.nn.functional.gelu(x)


def forward(params: Params, cfg: ViTConfig, pixel_values: torch.Tensor, *,
            feature_layer: int = -2, select: str = "patch",
            attn_impl: str = "auto") -> torch.Tensor:
    """(B, H, W, C) pixels (uint8 are rescaled and normalized here) -> the
    selected tokens after `feature_layer` (HF hidden_states indexing; the
    post-LayerNorm only at full depth). `select="patch"` drops token 0, also
    without a class token, as the reference does."""
    dtype = cfg.compute_dtype
    L = cfg.num_hidden_layers
    n_run = feature_layer + L + 1 if feature_layer < 0 else feature_layer
    assert 0 <= n_run <= L, f"feature_layer {feature_layer} out of range"

    h = _linear(patchify(normalize_pixels(pixel_values, cfg), cfg.patch_size),
                params["patch_embedding"], dtype)
    if cfg.class_token:
        cls = params["class_embedding"].to(dtype).expand(h.shape[0], 1, h.shape[2])
        h = torch.cat([cls, h], dim=1)
    pos = params["position_embedding"]["embedding"]
    if pos.shape[0] != h.shape[1]:
        pos = resize_position_embedding(pos, h.shape[1])
    h = h + pos.to(dtype)[None]
    if cfg.pre_layernorm and "pre_layernorm" in params:
        h = layer_norm(h, params["pre_layernorm"]["scale"], params["pre_layernorm"]["bias"],
                       cfg.layer_norm_eps)

    b, s, d = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    layers = {name: {k: v.unbind(0) for k, v in slot.items()}
              for name, slot in params["layers"].items()}
    for l in range(n_run):
        lp = {name: {k: v[l] for k, v in slot.items()} for name, slot in layers.items()}
        x = layer_norm(h, lp["layer_norm1"]["scale"], lp["layer_norm1"]["bias"],
                       cfg.layer_norm_eps)
        q = _linear(x, lp["q_proj"], dtype)
        k = _linear(x, lp["k_proj"], dtype)
        v = _linear(x, lp["v_proj"], dtype)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"]["scale"], cfg.layer_norm_eps)
            k = rms_norm(k, lp["k_norm"]["scale"], cfg.layer_norm_eps)
        attn = multi_head_attention(q.reshape(b, s, nh, hd), k.reshape(b, s, nh, hd),
                                    v.reshape(b, s, nh, hd), causal=False, impl=attn_impl)
        attn = _linear(attn.reshape(b, s, d), lp["out_proj"], dtype)
        if cfg.layer_scale:
            attn = attn * lp["ls1"]["scale"].to(dtype)
        h = h + attn
        x = layer_norm(h, lp["layer_norm2"]["scale"], lp["layer_norm2"]["bias"],
                       cfg.layer_norm_eps)
        x = _linear(_act(_linear(x, lp["fc1"], dtype), cfg.hidden_act), lp["fc2"], dtype)
        if cfg.layer_scale:
            x = x * lp["ls2"]["scale"].to(dtype)
        h = h + x
    if n_run == L:
        h = layer_norm(h, params["post_layernorm"]["scale"], params["post_layernorm"]["bias"],
                       cfg.layer_norm_eps)
    if select == "patch":
        return h[:, 1:]  # the reference drops token 0 with or without a class token
    if select != "cls_patch":
        raise ValueError(f"unknown select: {select}")
    return h
