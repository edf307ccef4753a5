"""HF checkpoint import: safetensors state dicts -> the port's parameter
trees, as `vila_tpu/utils/hf_import.py`.

The reference saves checkpoints component-wise (`llm/`, `vision_tower/`,
`mm_projector/` subdirectories). This module reads and writes the
safetensors layout with numpy alone (an 8-byte little-endian header
length, a JSON header whose `data_offsets` count from the end of the
header, then the raw little-endian bytes), so it needs neither
`safetensors` nor `transformers`, and converts each component's HF state
dict into the stacked-layer trees of `models/`.

Tensors keep the dtype they were stored in (BF16 as `torch.bfloat16`, its
raw bits); `entry.load_params` casts every leaf to the parameter dtype
afterwards, as the JAX package does. The converters run on whatever device
the state dict is on (`load_params` moves it to the card first) and return
contiguous tensors, transposes included.

Every tower of the JAX package converts: SigLIP (HF `SiglipVisionModel`),
CLIP (HF `CLIPVisionModel`) and InternViT (fused qkv, layer scale, qk
norm), RADIO (a timm ViT, or its CPE patch generator) and PS3 (its SigLIP
trunk in timm's layout). Each converter's output equals the JAX package's
on the same state dict; PS3's selection heads, which the reference's
checkpoints do not hold and JAX sets to zeros, are read when stored (the
port's `entry.save` writes them).
"""

from __future__ import annotations

import glob
import json
import math
import os
import re
import struct
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

# safetensors dtype tag -> (little-endian numpy dtype of the stored bytes,
# torch dtype the bytes are viewed as, if not the numpy dtype's own)
_DTYPES = {
    "F32": (np.dtype("<f4"), None),
    "F16": (np.dtype("<f2"), None),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), None),
    "I32": (np.dtype("<i4"), None),
    "U8": (np.dtype("u1"), None),
    "BOOL": (np.dtype("?"), None),
}
_TAGS = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.uint8: "U8", torch.bool: "BOOL",
}


def _t(v) -> torch.Tensor:
    """A state-dict value as a tensor: a tensor stays on its device, a
    numpy array becomes a CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach()
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: move the raw bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _read_header(f) -> tuple:
    """(header dict, byte offset of the data area) of an open file."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    return header, 8 + n


def _read_tensor(f, base: int, name: str, info: Dict[str, Any]) -> torch.Tensor:
    if info["dtype"] not in _DTYPES:
        raise ValueError(f"{name}: safetensors dtype {info['dtype']} is not supported")
    np_dtype, view = _DTYPES[info["dtype"]]
    shape = tuple(info["shape"])
    start, end = info["data_offsets"]
    count = math.prod(shape)
    if end - start != count * np_dtype.itemsize:
        raise ValueError(f"{name}: {end - start} bytes for shape {shape} {info['dtype']}")
    arr = np.empty(count, np_dtype)
    f.seek(base + start)
    got = f.readinto(memoryview(arr).cast("B")) if count else 0
    if got != end - start:
        raise ValueError(f"{name}: file ends after {got} of {end - start} bytes")
    t = torch.from_numpy(arr.reshape(shape))
    return t.view(view) if view is not None else t


def read_safetensors(filename: str, names: Optional[Iterable[str]] = None) -> Dict[str, torch.Tensor]:
    """The tensors of one safetensors file (only `names`, when given: each
    is read at its offset, the rest of the file is not touched)."""
    with open(filename, "rb") as f:
        header, base = _read_header(f)
        keys = [k for k in header if k != "__metadata__"]
        if names is not None:
            wanted = set(names)
            keys = [k for k in keys if k in wanted]
        return {k: _read_tensor(f, base, k, header[k]) for k in keys}


def save_safetensors(tensors: Dict[str, Any], filename: str) -> int:
    """Write `tensors` (torch tensors or numpy arrays, any device) in the
    safetensors layout; returns the bytes written. Each tensor is made
    contiguous first: a transposed view is written in its logical order."""
    arrays = {}
    header: Dict[str, Any] = {}
    offset = 0
    for name in sorted(tensors):
        t = _t(tensors[name]).cpu().contiguous()
        if t.dtype not in _TAGS:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors tag")
        tag = _TAGS[t.dtype]
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        header[name] = {"dtype": tag, "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays[name] = arr
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(filename, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(arrays):
            if arrays[name].size:
                f.write(memoryview(arrays[name]).cast("B"))
    return 8 + len(blob) + offset


def load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    """Load all *.safetensors (or pytorch_model*.bin) under `path`."""
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    state: Dict[str, torch.Tensor] = {}
    if files:
        for f in files:
            state.update(read_safetensors(f))
        return state
    files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if not files:
        raise FileNotFoundError(f"no weights found under {path}")
    for f in files:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        state.update({k: _t(v) for k, v in sd.items()})
    return state


def peek_safetensors(path: str, names) -> Dict[str, torch.Tensor]:
    """Load only the named tensors from *.safetensors under `path`."""
    out: Dict[str, torch.Tensor] = {}
    for f in sorted(glob.glob(os.path.join(path, "*.safetensors"))):
        out.update(read_safetensors(f, names))
    return out


def load_hf_config(path: str) -> dict:
    with open(os.path.join(path, "config.json")) as f:
        return json.load(f)


def _stack(sd: Dict[str, torch.Tensor], fmt: str, layers: int, transpose: bool = False):
    return torch.stack([sd[fmt.format(i)].T if transpose else sd[fmt.format(i)]
                        for i in range(layers)])


# --------------------------------------------------------------------------
# Qwen2 / Llama LLM
# --------------------------------------------------------------------------


def convert_llm_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """HF Qwen2/Llama `model.*` state dict -> `models.qwen2` tree."""
    sd = {k.removeprefix("model."): _t(v) for k, v in state.items()}
    L = cfg.num_hidden_layers

    def stack(fmt, transpose=False):
        return _stack(sd, fmt, L, transpose)

    layers = {
        "input_layernorm": {"scale": stack("layers.{}.input_layernorm.weight")},
        "q_proj": {"kernel": stack("layers.{}.self_attn.q_proj.weight", True)},
        "k_proj": {"kernel": stack("layers.{}.self_attn.k_proj.weight", True)},
        "v_proj": {"kernel": stack("layers.{}.self_attn.v_proj.weight", True)},
        "o_proj": {"kernel": stack("layers.{}.self_attn.o_proj.weight", True)},
        "post_attention_layernorm": {
            "scale": stack("layers.{}.post_attention_layernorm.weight")
        },
        "gate_proj": {"kernel": stack("layers.{}.mlp.gate_proj.weight", True)},
        "up_proj": {"kernel": stack("layers.{}.mlp.up_proj.weight", True)},
        "down_proj": {"kernel": stack("layers.{}.mlp.down_proj.weight", True)},
    }
    if cfg.qkv_bias and "layers.0.self_attn.q_proj.bias" in sd:
        for name in ("q_proj", "k_proj", "v_proj"):
            layers[name]["bias"] = stack(f"layers.{{}}.self_attn.{name}.bias")

    params = {
        "embed_tokens": {"embedding": sd["embed_tokens.weight"]},
        "layers": layers,
        "norm": {"scale": sd["norm.weight"]},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": sd["lm_head.weight"].T.contiguous()}
    return params


# --------------------------------------------------------------------------
# SigLIP vision tower
# --------------------------------------------------------------------------


def convert_siglip_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """HF `SiglipVisionModel` state dict -> `models.siglip` tree. The patch
    convolution (stride == kernel == patch) becomes a flat (P*P*3, D)
    matmul weight, pixels flattened as (row, column, channel)."""
    sd = {k.removeprefix("vision_model."): _t(v) for k, v in state.items()
          if not k.startswith("vision_model.head")}
    L = cfg.num_hidden_layers
    conv_w = sd["embeddings.patch_embedding.weight"]  # (D, 3, P, P)
    patch_kernel = conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])

    def stack(fmt, transpose=False):
        return _stack(sd, "encoder.layers.{}." + fmt, L, transpose)

    def ln(name):
        return {"scale": stack(f"{name}.weight"), "bias": stack(f"{name}.bias")}

    def linear(name):
        return {"kernel": stack(f"{name}.weight", True), "bias": stack(f"{name}.bias")}

    layers = {
        "layer_norm1": ln("layer_norm1"),
        "q_proj": linear("self_attn.q_proj"),
        "k_proj": linear("self_attn.k_proj"),
        "v_proj": linear("self_attn.v_proj"),
        "out_proj": linear("self_attn.out_proj"),
        "layer_norm2": ln("layer_norm2"),
        "fc1": linear("mlp.fc1"),
        "fc2": linear("mlp.fc2"),
    }
    return {
        "patch_embedding": {
            "kernel": patch_kernel.contiguous(),
            "bias": sd["embeddings.patch_embedding.bias"],
        },
        "position_embedding": {"embedding": sd["embeddings.position_embedding.weight"]},
        "layers": layers,
        "post_layernorm": {
            "scale": sd["post_layernorm.weight"],
            "bias": sd["post_layernorm.bias"],
        },
    }


# --------------------------------------------------------------------------
# CLIP / InternViT vision towers
# --------------------------------------------------------------------------


def _conv_kernel(conv_w: torch.Tensor) -> torch.Tensor:
    """A patch convolution (D, 3, P, P) -> the (P*P*3, D) matmul weight,
    pixels flattened as (row, column, channel)."""
    return conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0]).contiguous()


def _split_qkv(sd, fmt: str, layers: int, part: int, weight: bool) -> torch.Tensor:
    """Part `part` (q, k, v) of a fused qkv, stacked over layers; weights
    transposed to (din, dout)."""
    return torch.stack([sd[fmt.format(i)].chunk(3, dim=0)[part].T if weight
                        else sd[fmt.format(i)].chunk(3, dim=0)[part]
                        for i in range(layers)])


def _identity_norm(d: int, like: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=like.device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=like.device)}


def convert_vit_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """HF `CLIPVisionModel` or InternViT state dict -> `models.vit` tree
    (multimodal_encoder/{clip,intern}_encoder.py). CLIP names its block
    norms layer_norm1/2; InternViT norm1/2, with a fused attn.qkv, ls1/ls2
    and optional q/k norms, and no post-LayerNorm (an identity one here)."""
    sd = {k.removeprefix("vision_model."): _t(v) for k, v in state.items()}
    L = cfg.num_hidden_layers

    def stack(fmt, transpose=False):
        return _stack(sd, "encoder.layers.{}." + fmt, L, transpose)

    def ln(name):
        return {"scale": stack(f"{name}.weight"), "bias": stack(f"{name}.bias")}

    def linear(name):
        return {"kernel": stack(f"{name}.weight", True), "bias": stack(f"{name}.bias")}

    if "encoder.layers.0.layer_norm1.weight" in sd:  # CLIP
        params = {
            "patch_embedding": {"kernel": _conv_kernel(sd["embeddings.patch_embedding.weight"])},
            "position_embedding": {"embedding": sd["embeddings.position_embedding.weight"]},
            "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
            "layers": {
                "layer_norm1": ln("layer_norm1"),
                "q_proj": linear("self_attn.q_proj"),
                "k_proj": linear("self_attn.k_proj"),
                "v_proj": linear("self_attn.v_proj"),
                "out_proj": linear("self_attn.out_proj"),
                "layer_norm2": ln("layer_norm2"),
                "fc1": linear("mlp.fc1"),
                "fc2": linear("mlp.fc2"),
            },
            "post_layernorm": {"scale": sd["post_layernorm.weight"],
                               "bias": sd["post_layernorm.bias"]},
        }
        if "pre_layrnorm.weight" in sd:  # HF's spelling of CLIP's pre-LayerNorm
            params["pre_layernorm"] = {"scale": sd["pre_layrnorm.weight"],
                                       "bias": sd["pre_layrnorm.bias"]}
        return params

    conv_w = sd.get("embeddings.patch_embedding.weight", sd.get("patch_embed.proj.weight"))
    d = conv_w.shape[0]
    qkv = "encoder.layers.{}.attn.qkv."
    layers = {
        "layer_norm1": ln("norm1"),
        "q_proj": {"kernel": _split_qkv(sd, qkv + "weight", L, 0, True),
                   "bias": _split_qkv(sd, qkv + "bias", L, 0, False)},
        "k_proj": {"kernel": _split_qkv(sd, qkv + "weight", L, 1, True),
                   "bias": _split_qkv(sd, qkv + "bias", L, 1, False)},
        "v_proj": {"kernel": _split_qkv(sd, qkv + "weight", L, 2, True),
                   "bias": _split_qkv(sd, qkv + "bias", L, 2, False)},
        "out_proj": linear("attn.proj"),
        "layer_norm2": ln("norm2"),
        "fc1": linear("mlp.fc1"),
        "fc2": linear("mlp.fc2"),
        "ls1": {"scale": stack("ls1")},
        "ls2": {"scale": stack("ls2")},
    }
    if "encoder.layers.0.attn.q_norm.weight" in sd:
        layers["q_norm"] = {"scale": stack("attn.q_norm.weight")}
        layers["k_norm"] = {"scale": stack("attn.k_norm.weight")}
    return {
        "patch_embedding": {"kernel": _conv_kernel(conv_w)},
        "position_embedding": {
            "embedding": sd["embeddings.position_embedding"].reshape(-1, d)},
        "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
        "layers": layers,
        "post_layernorm": _identity_norm(d, conv_w),
    }


# --------------------------------------------------------------------------
# RADIO (timm ViT layout) and PS3 (SigLIP trunk in timm layout)
# --------------------------------------------------------------------------

_TIMM_PREFIX_CANDIDATES = (
    "radio_model.model.",  # HF-hub RADIO AutoModel (radio_encoder.py:141)
    "vision_model.trunk.",  # PS3VisionModel's trunk (ps3_encoder.py:35)
    "model.",  # torchhub RADIO (radio_torchhub_encoder.py)
    "trunk.",
    "",
)


def _find_timm_prefix(state: Dict[str, Any]) -> str:
    for pre in _TIMM_PREFIX_CANDIDATES:
        if (f"{pre}blocks.0.norm1.weight" in state
                or f"{pre}patch_embed.proj.weight" in state
                or f"{pre}patch_generator.embedder.weight" in state):
            return pre
    raise KeyError(
        "no timm-ViT key layout found (expected blocks.N.norm1.weight under "
        f"one of {_TIMM_PREFIX_CANDIDATES})")


def _timm_layers(sd: Dict[str, torch.Tensor], L: int) -> Dict[str, Any]:
    """timm's `blocks.{i}.*` (fused qkv, norm1/norm2, mlp.fc1/fc2, optional
    ls1/ls2 gammas) -> the stacked layers of `models.vit` and `siglip`."""

    def stack(fmt, transpose=False):
        return _stack(sd, "blocks.{}." + fmt, L, transpose)

    def ln(name):
        return {"scale": stack(f"{name}.weight"), "bias": stack(f"{name}.bias")}

    def linear(name):
        return {"kernel": stack(f"{name}.weight", True), "bias": stack(f"{name}.bias")}

    def qkv(part):
        return {"kernel": _split_qkv(sd, "blocks.{}.attn.qkv.weight", L, part, True),
                "bias": _split_qkv(sd, "blocks.{}.attn.qkv.bias", L, part, False)}

    layers = {
        "layer_norm1": ln("norm1"),
        "q_proj": qkv(0),
        "k_proj": qkv(1),
        "v_proj": qkv(2),
        "out_proj": linear("attn.proj"),
        "layer_norm2": ln("norm2"),
        "fc1": linear("mlp.fc1"),
        "fc2": linear("mlp.fc2"),
    }
    if "blocks.0.ls1.gamma" in sd:  # timm's layer-scale variant
        layers["ls1"] = {"scale": stack("ls1.gamma")}
        layers["ls2"] = {"scale": stack("ls2.gamma")}
    return layers


def _timm_state(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    pre = _find_timm_prefix(state)
    return {k.removeprefix(pre): _t(v) for k, v in state.items() if k.startswith(pre)}


def convert_radio_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A RADIO checkpoint (a timm VisionTransformer under
    `radio_model.model.`, or torchhub's `model.`: radio_encoder.py:141,
    radio_torchhub_encoder.py) -> `models.vit` tree. The standard patch
    convolution, or RADIO's Cropped Position Embedding patch generator
    (already a flat linear; its pos_embed covers the patches only, so a zero
    row is put first for the class token). One summary token only."""
    sd = _timm_state(state)
    if "patch_generator.embedder.weight" in sd:  # CPE
        w = sd["patch_generator.embedder.weight"]  # (D, P*P*3)
        d = w.shape[0]
        patch = {"kernel": w.T.contiguous()}
        if "patch_generator.embedder.bias" in sd:
            patch["bias"] = sd["patch_generator.embedder.bias"]
        pos = sd["patch_generator.pos_embed"].reshape(-1, d)
        cls_tok = sd["patch_generator.cls_token.token"].reshape(-1, d)
        if cls_tok.shape[0] != 1:
            raise ValueError(
                f"RADIO checkpoint has {cls_tok.shape[0]} summary/register "
                "tokens; only num_cls_tokens=1 is supported")
        cls = cls_tok[0]
        pos = torch.cat([pos.new_zeros((1, d)), pos])
    else:
        conv_w = sd["patch_embed.proj.weight"]
        d = conv_w.shape[0]
        patch = {"kernel": _conv_kernel(conv_w)}
        if "patch_embed.proj.bias" in sd:
            patch["bias"] = sd["patch_embed.proj.bias"]
        pos = sd["pos_embed"].reshape(-1, d)
        cls = sd["cls_token"].reshape(-1)
        if pos.shape[0] == cfg.num_patches:  # no class row stored
            pos = torch.cat([pos.new_zeros((1, d)), pos])
    return {
        "patch_embedding": patch,
        "position_embedding": {"embedding": pos},
        "class_embedding": cls,
        "layers": _timm_layers(sd, cfg.num_hidden_layers),
        # no final norm: skip_layer_norm / an Identity norm (radio_encoder.py:178)
        "post_layernorm": ({"scale": sd["norm.weight"], "bias": sd["norm.bias"]}
                           if "norm.weight" in sd else _identity_norm(d, pos)),
    }


def radio_image_stats(state: Dict[str, Any]):
    """(mean, std) of a RADIO checkpoint's input conditioner
    (`radio_model.input_conditioner.norm_{mean,std}`), or None."""
    for pre in ("radio_model.", "", "model."):
        mk, sk = f"{pre}input_conditioner.norm_mean", f"{pre}input_conditioner.norm_std"
        if mk in state:
            return (tuple(float(x) for x in _t(state[mk]).float().reshape(-1).tolist()),
                    tuple(float(x) for x in _t(state[sk]).float().reshape(-1).tolist()))
    return None


# where the PS3 scale embeddings may be stored, in the order searched
PS3_SCALE_KEYS = ("vision_model.scale_embed", "scale_embed", "scale_embedding")


def convert_ps3_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    """A PS3 checkpoint (the `ps3` package's PS3VisionModel,
    ps3_encoder.py:35) -> `models.ps3` tree. The SigLIP trunk (timm layout
    under `vision_model.trunk.`) converts one to one; the scale embeddings
    import when present. The reference's selection machinery (low-res-KV
    cross attention, per-scale prompts) has no counterpart in the static
    top-k design, so the selection and top-down heads are zeros (uniform
    selection), as in the JAX package, unless the state dict holds the
    port's own `select_head.*` / `top_down_prompt_head.*` (HF Linear
    layout), which `entry.save` writes."""
    sd = _timm_state(state)
    conv_w = sd["patch_embed.proj.weight"]
    d = conv_w.shape[0]
    zeros = conv_w.new_zeros((d,), dtype=torch.float32)
    trunk = {
        "patch_embedding": {"kernel": _conv_kernel(conv_w),
                            "bias": sd.get("patch_embed.proj.bias", zeros)},
        "position_embedding": {"embedding": sd["pos_embed"].reshape(-1, d)},
        "layers": _timm_layers(sd, cfg.vit.num_hidden_layers),
        "post_layernorm": {"scale": sd.get("norm.weight", zeros + 1.0),
                           "bias": sd.get("norm.bias", zeros)},
    }
    n_scales = len(cfg.s3_scales)
    scale_emb = conv_w.new_zeros((n_scales, d), dtype=torch.float32)
    for key in PS3_SCALE_KEYS:
        if key in state:
            se = _t(state[key]).reshape(-1, d)[:n_scales]
            scale_emb[:se.shape[0]] = se
            break

    def head(name, din, dout):
        if f"{name}.weight" in state:
            return {"kernel": _t(state[f"{name}.weight"]).T.contiguous(),
                    "bias": _t(state[f"{name}.bias"])}
        return {"kernel": conv_w.new_zeros((din, dout), dtype=torch.float32),
                "bias": conv_w.new_zeros((dout,), dtype=torch.float32)}

    params = {"vit": trunk, "scale_embedding": scale_emb,
              "select_head": head("select_head", d, 1)}
    if cfg.prompt_dim:
        params["top_down_prompt_head"] = head("top_down_prompt_head", cfg.prompt_dim, d)
    return params


# --------------------------------------------------------------------------
# Multimodal projector
# --------------------------------------------------------------------------


def convert_projector_state_dict(state: Dict[str, Any]) -> Dict[str, Any]:
    """HF `MultimodalProjector` state dict (`layers.{idx}.{weight,bias}` of
    an nn.Sequential) -> `models.projector` tree: the sequential indices
    stay, LayerNorms are told apart by their 1-D weights."""
    out: Dict[str, Any] = {}
    pat = re.compile(r"^(?:mm_projector\.)?layers\.(\d+)\.(weight|bias)$")
    for key, val in state.items():
        m = pat.match(key)
        if m is None:
            continue
        val = _t(val)
        slot = out.setdefault(str(int(m.group(1))), {})
        if m.group(2) == "bias":
            slot["bias"] = val
        elif val.ndim == 2:
            slot["kernel"] = val.T.contiguous()
        else:
            slot["scale"] = val
    return out
