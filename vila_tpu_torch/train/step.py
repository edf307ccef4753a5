"""The training step on one device, as `vila_tpu/train/step.py`
(`loss_fn`, `train_step`). The JAX package's `make_sharded_train_step`
places the step on a mesh; its counterpart here, `make_train_step`, binds
it to one device (the mesh waits for `parallel/`). PS3's selection loss
comes with PS3.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vila_tpu_torch.models import vlm
from vila_tpu_torch.train.losses import causal_lm_loss, chunked_causal_lm_loss
from vila_tpu_torch.train.optimizer import Optimizer, OptState, global_norm, leaves
from vila_tpu_torch.utils.device import host_to_device


def loss_fn(params, cfg, batch, ce_chunk_size: Optional[int] = None,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch; the chunked cross entropy never
    materialises the (B, S, V) logits."""
    if ce_chunk_size:
        hidden = vlm.forward_batch(params, cfg, batch, attn_impl=attn_impl,
                                   return_hidden=True)
        loss, n_tokens = chunked_causal_lm_loss(
            hidden, params["llm"], cfg.llm, batch["labels"], chunk_size=ce_chunk_size)
    else:
        logits = vlm.forward_batch(params, cfg, batch, attn_impl=attn_impl)
        loss, n_tokens = causal_lm_loss(logits, batch["labels"])
    return loss, {"loss": loss.detach(), "n_tokens": n_tokens}


def train_step(params, opt_state: OptState, batch, *, cfg, optimizer: Optimizer,
               ce_chunk_size: Optional[int] = None, attn_impl: str = "auto"):
    """One step: gradients of every component (frozen ones included, as
    `jax.value_and_grad` over the whole tree), then the optimizer's update
    in place. `metrics["grad_norm"]` is the global norm of all of them
    before clipping. Returns (params, opt_state, metrics)."""
    ts = leaves(params)
    for t in ts:
        t.requires_grad_(True)
        t.grad = None
    loss, metrics = loss_fn(params, cfg, batch, ce_chunk_size, attn_impl)
    loss.backward()
    metrics["grad_norm"] = global_norm([t.grad for t in ts])
    opt_state = optimizer.update(opt_state, params)
    for t in ts:
        t.grad = None
    return params, opt_state, metrics


def batch_to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A collated numpy batch as tensors on `device` (asynchronous copies
    on the card)."""
    return {k: host_to_device(v, device) for k, v in batch.items()}


def make_train_step(cfg, params: Dict[str, Any], optimizer: Optimizer,
                    ce_chunk_size: Optional[int] = None):
    """(step_fn, params, opt_state) on the device the params live on;
    `step_fn(params, opt_state, batch)` takes a batch of tensors there."""
    opt_state = optimizer.init(params)
    step = functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                             ce_chunk_size=ce_chunk_size)
    return step, params, opt_state
