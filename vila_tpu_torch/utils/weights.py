"""Parameter conversion between the JAX package's pytrees and the port.

`from_jax_params` takes a `vila_tpu` parameter tree whose leaves are numpy
arrays (bf16 leaves as `ml_dtypes.bfloat16`, as `np.asarray` gives them
from a JAX array) and returns the same tree of torch tensors on `device`,
bit for bit.

The port's CUDA kernels read the W4 slots in the JAX package's own layout,
so no re-layout is needed: packed bytes stay `(..., nj, din/2, bout)`
uint8 and the `scale_rows`-padded scales stay `(..., nj, s_rows, bout)`
bf16 (`ops/quant.py`, `csrc/w4_gemv_sm90.cu`, `csrc/w4_gemm_sm90.cu`). `cfg`, when
given, is checked against the W4 slot shapes so that a tree quantized for
another configuration (for example without the GQA-padded o layout) fails
here rather than inside a kernel.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from vila_tpu_torch.utils.device import resolve_device


def _leaf_to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16: move the raw bits
        t = torch.from_numpy(np.array(a).view(np.int16)).view(
            torch.bfloat16
        )
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    return t.to(device)


def to_torch_tree(tree: Any, device: torch.device) -> Any:
    """Every array or tensor leaf of a nested dict/list tree -> tensor on
    `device`; other leaves (ints, strings) pass through."""
    if isinstance(tree, dict):
        return {k: to_torch_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch_tree(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (np.ndarray, np.generic)) or hasattr(tree, "__array__"):
        return _leaf_to_torch(tree, device)
    return tree


def _check_llm(llm: dict, cfg) -> None:
    """Shape checks of the fused W4 slots against an LLMConfig."""
    layers = llm.get("layers", {})
    hd = cfg.head_dim_
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    grp = hq // hkv
    o_rows = {hq * hd, hkv * ((grp + 7) // 8) * 8 * hd}
    want_out = {
        "qkv_proj": {(hq + 2 * hkv) * hd},
        "gate_up_proj": {2 * cfg.intermediate_size},
        "down_proj": {cfg.hidden_size},
        "o_proj": {cfg.hidden_size},
    }
    want_in = {
        "qkv_proj": {cfg.hidden_size},
        "gate_up_proj": {cfg.hidden_size},
        "down_proj": {cfg.intermediate_size},
        "o_proj": o_rows,
    }
    for name, outs in want_out.items():
        slot = layers.get(name)
        if not isinstance(slot, dict) or "packed" not in slot:
            continue
        *_, nj, half, bout = slot["packed"].shape
        if nj * bout not in outs or 2 * half not in want_in[name]:
            raise ValueError(
                f"{name}: W4 slot ({2 * half} -> {nj * bout}) does not fit "
                f"the config ({sorted(want_in[name])} -> {sorted(outs)})"
            )


def from_jax_params(tree: Any, cfg=None, device="cuda") -> Any:
    """A `vila_tpu` param tree of numpy arrays -> the port's tensors.

    `cfg` may be a `qwen2.LLMConfig` (tree = LLM params) or a
    `vlm.VLMConfig` (tree = {"llm", "vision_tower", "mm_projector"}) of
    either package; its LLM part is checked against the W4 slots."""
    dev = resolve_device(device)
    out = to_torch_tree(tree, dev)
    if cfg is not None:
        llm_cfg = getattr(cfg, "llm", cfg)
        llm = out.get("llm", out) if isinstance(out, dict) else out
        _check_llm(llm, llm_cfg)
    return out


def to_numpy_tree(tree: Any, bf16_dtype: Optional[Any] = None) -> Any:
    """Inverse of `to_torch_tree`: tensors -> numpy. bf16 tensors come back
    as their raw 16-bit patterns viewed as `bf16_dtype` (for example
    `ml_dtypes.bfloat16`), or as uint16 when none is given."""
    if isinstance(tree, dict):
        return {k: to_numpy_tree(v, bf16_dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy_tree(v, bf16_dtype) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits if bf16_dtype is None else bits.view(bf16_dtype)
        return t.numpy()
    return tree
