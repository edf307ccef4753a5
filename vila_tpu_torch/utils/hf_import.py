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

The CLIP / InternViT, RADIO and PS3 towers are not ported yet: their
converters raise.
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
# Towers not ported yet
# --------------------------------------------------------------------------


def _not_ported(tower: str):
    raise NotImplementedError(
        f"the {tower} vision tower is not ported yet (its converter comes with "
        f"its model)")


def convert_vit_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    _not_ported("CLIP / InternViT")


def convert_radio_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    _not_ported("RADIO")


def radio_image_stats(state: Dict[str, Any]):
    _not_ported("RADIO")


def convert_ps3_state_dict(state: Dict[str, Any], cfg) -> Dict[str, Any]:
    _not_ported("PS3")


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
