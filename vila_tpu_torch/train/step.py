"""The training step on one device, as `vila_tpu/train/step.py`
(`loss_fn`, `train_step`). The JAX package's `make_sharded_train_step`
places the step on a mesh; its counterpart here, `make_train_step`, binds
it to one device (the mesh waits for `parallel/`). A PS3 batch with gt
selection maps adds the BCE + DICE token-selection loss.

`apply_gradients` is the step of the other training modes (LoRA, DPO,
reward, PPO, SFT): the gradients of a loss over any tree of trainable
tensors, then one update of its optimizer.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vila_tpu_torch.models import vlm
from vila_tpu_torch.train.losses import (
    causal_lm_loss,
    chunked_causal_lm_loss,
    token_selection_loss,
)
from vila_tpu_torch.train.optimizer import Optimizer, OptState, global_norm, leaves
from vila_tpu_torch.utils.device import host_to_device


def loss_fn(params, cfg, batch, ce_chunk_size: Optional[int] = None,
            attn_impl: str = "auto", token_selection_loss_weight: float = 1.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch; the chunked cross entropy never
    materialises the (B, S, V) logits. A PS3 batch with gt selection maps
    adds `token_selection_loss_weight` x the selection loss (the reference's
    top-down trainer, llava_trainer.py:917-998), reported apart."""
    ps3 = cfg.vision_tower_type == "ps3"
    sel_probs = []
    if ps3:
        out, sel_probs = vlm.forward_batch_ps3(params, cfg, batch, attn_impl=attn_impl,
                                               return_hidden=bool(ce_chunk_size))
    else:
        out = vlm.forward_batch(params, cfg, batch, attn_impl=attn_impl,
                                return_hidden=bool(ce_chunk_size))
    if ce_chunk_size:
        loss, n_tokens = chunked_causal_lm_loss(
            out, params["llm"], cfg.llm, batch["labels"], chunk_size=ce_chunk_size)
    else:
        loss, n_tokens = causal_lm_loss(out, batch["labels"])
    metrics = {"n_tokens": n_tokens}
    if ps3 and sel_probs and batch.get("gt_selection_maps") is not None:
        gt = batch["gt_selection_maps"]
        sel = token_selection_loss(sel_probs, gt.reshape((-1,) + gt.shape[2:]))
        loss = loss + token_selection_loss_weight * sel
        metrics["token_selection_loss"] = sel.detach()
    metrics["loss"] = loss.detach()
    return loss, metrics


def train_step(params, opt_state: OptState, batch, *, cfg, optimizer: Optimizer,
               ce_chunk_size: Optional[int] = None, attn_impl: str = "auto"):
    """One step: gradients of every component (frozen ones included, as
    `jax.value_and_grad` over the whole tree), then the optimizer's update
    in place. `metrics["grad_norm"]` is the global norm of all of them
    before clipping. Returns (params, opt_state, metrics)."""
    _, metrics, grad_norm, opt_state = apply_gradients(
        params, lambda: loss_fn(params, cfg, batch, ce_chunk_size, attn_impl), optimizer,
        opt_state)
    metrics["grad_norm"] = grad_norm
    return params, opt_state, metrics


def apply_gradients(trainable: Any, compute_loss: Callable[[], Tuple[torch.Tensor, Any]],
                    optimizer, opt_state):
    """`jax.value_and_grad(has_aux=True)` then `optimizer.update` and
    `optax.apply_updates`: `compute_loss()` -> (loss, aux) is
    differentiated with respect to every tensor of `trainable`, and
    `optimizer` steps them in place from their gradients. Returns (loss,
    aux, the gradients' global norm, opt_state)."""
    ts = leaves(trainable)
    for t in ts:
        t.requires_grad_(True)
        t.grad = None
    loss, aux = compute_loss()
    loss.backward()
    grad_norm = global_norm([t.grad for t in ts])
    opt_state = optimizer.update(opt_state, trainable)
    for t in ts:
        t.grad = None
    return loss.detach(), aux, grad_norm, opt_state


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A collated numpy batch as tensors on `device` (asynchronous copies
    on the card); a list value (PS3's views, one array a high scale)
    becomes a list of tensors."""
    return {k: ([host_to_device(x, device) for x in v] if isinstance(v, list)
                else host_to_device(v, device)) for k, v in batch.items()}


def make_train_step(cfg, params: Dict[str, Any], optimizer: Optimizer,
                    ce_chunk_size: Optional[int] = None):
    """(step_fn, params, opt_state) on the device the params live on;
    `step_fn(params, opt_state, batch)` takes a batch of tensors there."""
    opt_state = optimizer.init(params)
    step = functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                             ce_chunk_size=ce_chunk_size)
    return step, params, opt_state
