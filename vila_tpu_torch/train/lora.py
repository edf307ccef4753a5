"""LoRA / DoRA low-rank adaptation, as `vila_tpu/train/lora.py`
(capability parity: the reference's peft integration, `lora_enable`,
llava/train/train.py:690-800, and its LoRA-merge tooling).

LoRA is a transform of the parameter tree, not a module wrapper: the base
tree stays frozen, a parallel tree of (A, B) factors over the stacked
`(L, din, dout)` kernels is the only trainable state, and `apply_lora`
builds `W + (alpha / r) · A @ B` inside the loss, so the model's forward
runs unchanged. DoRA adds a trainable per-column magnitude.
`merge_lora` gives the plain merged weights to save.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Sequence

import torch

Params = Dict[str, Any]

# the LLM's projections eligible for adaptation (stacked (L, din, dout))
DEFAULT_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    targets: Sequence[str] = DEFAULT_TARGETS
    use_dora: bool = False  # weight-norm decomposed variant

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _target_kernels(llm_params: Params, cfg: LoRAConfig):
    """(name, kernel) of each adapted stacked kernel (L, din, dout)."""
    for name in cfg.targets:
        slot = llm_params["layers"].get(name)
        if slot is not None and "kernel" in slot:
            yield name, slot["kernel"]


def init_lora(generator: torch.Generator, llm_params: Params, cfg: LoRAConfig,
              param_dtype=torch.float32) -> Params:
    """A ~ N(0, 1/r), B = 0 (the adapted model starts at the base model);
    DoRA's magnitudes start at the base kernels' column norms. Drawn on
    the generator's device."""
    dev = generator.device
    lora: Params = {}
    for name, k in _target_kernels(llm_params, cfg):
        L, din, dout = k.shape
        a = torch.randn((L, din, cfg.rank), generator=generator, device=dev)
        entry = {
            "a": (a / torch.full_like(a, math.sqrt(cfg.rank))).to(param_dtype),
            "b": torch.zeros((L, cfg.rank, dout), dtype=param_dtype, device=dev),
        }
        if cfg.use_dora:
            entry["magnitude"] = torch.linalg.vector_norm(
                k.detach().float(), dim=1).to(param_dtype).to(dev)
        lora[name] = entry
    return lora


def _merged_kernel(kernel: torch.Tensor, entry: Params, cfg: LoRAConfig) -> torch.Tensor:
    w = kernel.float()
    merged = w + cfg.scale * torch.bmm(entry["a"].float(), entry["b"].float())
    if cfg.use_dora and "magnitude" in entry:
        norm = torch.linalg.vector_norm(merged, dim=1, keepdim=True)
        merged = merged / norm.clamp(min=1e-6) * entry["magnitude"][:, None, :].float()
    return merged.to(kernel.dtype)


def apply_lora(params: Params, lora: Params, cfg: LoRAConfig) -> Params:
    """A parameter tree with the adapted kernels (the input is unchanged)."""
    layers = dict(params["llm"]["layers"])
    for name, entry in lora.items():
        slot = dict(layers[name])
        slot["kernel"] = _merged_kernel(slot["kernel"], entry, cfg)
        layers[name] = slot
    return dict(params, llm=dict(params["llm"], layers=layers))


# merge == apply; its own name for the save-time contract
merge_lora = apply_lora


def _detached(tree):
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


def lora_loss_fn(base_params: Params, cfg_vlm, lora_cfg: LoRAConfig):
    """The training loss (`step.loss_fn`) of the adapted model as a
    function of the factors alone: the base tree is detached, so only the
    LoRA tensors receive gradients."""
    from vila_tpu_torch.train.step import loss_fn

    base = _detached(base_params)

    def fn(lora: Params, batch, ce_chunk_size: Optional[int] = None):
        return loss_fn(apply_lora(base, lora, lora_cfg), cfg_vlm, batch, ce_chunk_size)

    return fn
