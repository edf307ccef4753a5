"""SigLIP vision tower, as `vila_tpu/models/siglip.py`: bf16 or f32, or
with its encoder's linear layers in W8A8 (`quantize_siglip_w8a8`, TinyChat's
vision recipe: int8 weights and dynamic per-token int8 activations,
`ops.quant.w8a8_linear`).

The stride == kernel patch convolution is one matmul on pre-patchified
pixels; `feature_layer=-2` runs the encoder only up to the requested layer.
Layer parameters are stacked on a leading axis, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vila_tpu_torch.ops.attention import multi_head_attention
from vila_tpu_torch.ops.norms import layer_norm
from vila_tpu_torch.ops.quant import quantize_w8a8, w8a8_linear
from vila_tpu_torch.utils.device import host_to_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class SigLIPConfig:
    hidden_size: int = 1152
    intermediate_size: int = 4304
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    image_size: int = 448
    patch_size: int = 14
    num_channels: int = 3
    layer_norm_eps: float = 1e-6
    dtype: str = "float32"
    image_mean: Tuple[float, ...] = (0.5, 0.5, 0.5)
    image_std: Tuple[float, ...] = (0.5, 0.5, 0.5)

    @classmethod
    def from_hf_config(cls, hf: dict, **overrides) -> "SigLIPConfig":
        kw = dict(
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            image_size=hf["image_size"],
            patch_size=hf["patch_size"],
            num_channels=hf.get("num_channels", 3),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-6),
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def init_params(generator: torch.Generator, cfg: SigLIPConfig,
                param_dtype=torch.float32) -> Params:
    """Random parameters (normal(0.02) kernels, unit norms, zero biases) on
    the generator's device."""
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.patch_size * cfg.patch_size * cfg.num_channels
    dev = generator.device

    def dense(*shape):
        return (0.02 * torch.randn(shape, generator=generator, device=dev)).to(param_dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=param_dtype, device=dev)

    def ln(*shape):
        return {"scale": torch.ones(shape, dtype=param_dtype, device=dev),
                "bias": zeros(*shape)}

    def proj(din, dout):
        return {"kernel": dense(L, din, dout), "bias": zeros(L, dout)}

    return {
        "patch_embedding": {"kernel": dense(patch_in, D), "bias": zeros(D)},
        "position_embedding": {"embedding": dense(cfg.num_patches, D)},
        "layers": {
            "layer_norm1": ln(L, D),
            "q_proj": proj(D, D),
            "k_proj": proj(D, D),
            "v_proj": proj(D, D),
            "out_proj": proj(D, D),
            "layer_norm2": ln(L, D),
            "fc1": proj(D, I),
            "fc2": proj(I, D),
        },
        "post_layernorm": ln(D),
    }


def patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C), pixels flattened (row, col, ch)."""
    b, h, w, c = pixel_values.shape
    gh, gw = h // patch, w // patch
    x = pixel_values.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def _linear(x, p, dtype):
    if "w8" in p:  # W8A8 slot (quantize_siglip_w8a8)
        return w8a8_linear(x, p, dtype)
    y = x @ p["kernel"].to(dtype)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def quantize_siglip_w8a8(params: Params) -> Params:
    """The encoder's linear layers (q, k, v, out, fc1, fc2) to W8A8 slots
    {w8, w_scale[, bias]}, on the parameters' device; norms, the patch
    matmul and the position embeddings stay in the compute dtype.
    `_linear` dispatches on the slot's contents."""
    src = params["layers"]
    layers: Params = {"layer_norm1": src["layer_norm1"], "layer_norm2": src["layer_norm2"]}
    for name in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
        slot = quantize_w8a8(src[name]["kernel"])
        if "bias" in src[name]:
            slot["bias"] = src[name]["bias"]
        layers[name] = slot
    return {**params, "layers": layers}


def resize_position_embedding(pos_embed: torch.Tensor, num_new: int) -> torch.Tensor:
    """1-D linear interpolation of position embeddings (resolution change)."""
    old = pos_embed.shape[0]
    if old == num_new:
        return pos_embed
    mapped = torch.arange(num_new, dtype=torch.float32, device=pos_embed.device)
    mapped = mapped / (num_new - 1) * (old - 1)
    lo = mapped.floor().long().clamp(0, old - 1)
    hi = mapped.ceil().long().clamp(0, old - 1)
    frac = (mapped - lo.float())[:, None]
    return (pos_embed[hi] * frac + pos_embed[lo] * (1.0 - frac)).to(pos_embed.dtype)


def embed_pixels(params: Params, cfg: SigLIPConfig, pixel_values: torch.Tensor):
    """(B, H, W, C) pixels -> (B, N, D) patch plus position embeddings;
    uint8 pixels are rescaled and normalized here."""
    dtype = cfg.compute_dtype
    if pixel_values.dtype == torch.uint8:
        dev = pixel_values.device
        mean = host_to_device(np.asarray(cfg.image_mean, np.float32), dev).to(dtype) * 255.0
        std = host_to_device(np.asarray(cfg.image_std, np.float32), dev).to(dtype) * 255.0
        pixel_values = (pixel_values.to(dtype) - mean) / std
    x = patchify(pixel_values.to(dtype), cfg.patch_size)
    h = _linear(x, params["patch_embedding"], dtype)
    pos = params["position_embedding"]["embedding"]
    if pos.shape[0] != h.shape[1]:
        pos = resize_position_embedding(pos, h.shape[1])
    return h + pos.to(dtype)[None]


def encode_tokens(params: Params, cfg: SigLIPConfig, h: torch.Tensor, *,
                  feature_layer: int = -2, attn_impl: str = "auto") -> torch.Tensor:
    """The encoder trunk over a token sequence, up to `feature_layer`."""
    dtype = cfg.compute_dtype
    L = cfg.num_hidden_layers
    n_run = feature_layer + L + 1 if feature_layer < 0 else feature_layer
    assert 0 <= n_run <= L, f"feature_layer {feature_layer} out of range"
    b, s, d = h.shape
    nh, hd = cfg.num_attention_heads, cfg.head_dim
    # one unbind per stacked tensor: the backward stacks one gradient per
    # tensor instead of summing a full-size one per layer
    layers = {name: {k: v.unbind(0) for k, v in slot.items()}
              for name, slot in params["layers"].items()}
    for l in range(n_run):
        lp = {name: {k: v[l] for k, v in slot.items()} for name, slot in layers.items()}
        x = layer_norm(h, lp["layer_norm1"]["scale"], lp["layer_norm1"]["bias"],
                       cfg.layer_norm_eps)
        q = _linear(x, lp["q_proj"], dtype).reshape(b, s, nh, hd)
        k = _linear(x, lp["k_proj"], dtype).reshape(b, s, nh, hd)
        v = _linear(x, lp["v_proj"], dtype).reshape(b, s, nh, hd)
        attn = multi_head_attention(q, k, v, causal=False, impl=attn_impl)
        h = h + _linear(attn.reshape(b, s, d), lp["out_proj"], dtype)
        x = layer_norm(h, lp["layer_norm2"]["scale"], lp["layer_norm2"]["bias"],
                       cfg.layer_norm_eps)
        x = torch.nn.functional.gelu(_linear(x, lp["fc1"], dtype), approximate="tanh")
        h = h + _linear(x, lp["fc2"], dtype)
    if n_run == L:
        h = layer_norm(h, params["post_layernorm"]["scale"],
                       params["post_layernorm"]["bias"], cfg.layer_norm_eps)
    return h


def forward(params: Params, cfg: SigLIPConfig, pixel_values: torch.Tensor, *,
            feature_layer: int = -2, select: str = "cls_patch",
            attn_impl: str = "auto") -> torch.Tensor:
    """Run the tower up to `feature_layer` (HF hidden_states indexing) and
    return the selected patch features."""
    h = embed_pixels(params, cfg, pixel_values)
    h = encode_tokens(params, cfg, h, feature_layer=feature_layer, attn_impl=attn_impl)
    if select == "patch":
        h = h[:, 1:]
    elif select != "cls_patch":
        raise ValueError(f"unknown select: {select}")
    return h
