"""The training step, as `vila_tpu/train/step.py` (`loss_fn`,
`train_step`, `make_sharded_train_step`). `make_train_step` binds it to one
device; `make_sharded_train_step` runs it on a (dp, sp, su) mesh as ZeRO-3
by hand, what GSPMD derives from the JAX package's FSDP specs:

  * each rank holds its shard of every parameter (`parallel/mesh.py`'s
    rules: rank r holds the slice JAX puts on device r) and the AdamW
    moments of that shard;
  * the forward all-gathers each decoder layer's weights when that layer
    runs (with remat, again in the backward), the rest once a step; the
    gather's backward reduce-scatters (sums) the gradient into the shard,
    and the replicated leaves' gradients are all-reduced;
  * every rank's loss is its tokens' summed cross entropy over the global
    token count, so the summed gradients are those of the global mean
    (dp averaging included); the optimizer clips by the norm of the whole
    gradients and steps the shards.

A PS3 batch with gt selection maps adds the BCE + DICE token-selection
loss (one device only).

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
from vila_tpu_torch.train.optimizer import (
    Optimizer,
    OptState,
    _fill_grads,
    global_norm,
    leaves,
)
from vila_tpu_torch.utils.device import host_to_device


def loss_fn(params, cfg, batch, ce_chunk_size: Optional[int] = None,
            attn_impl: str = "auto", token_selection_loss_weight: float = 1.0,
            sp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch; the chunked cross entropy never
    materialises the (B, S, V) logits. A PS3 batch with gt selection maps
    adds `token_selection_loss_weight` x the selection loss (the reference's
    top-down trainer, llava_trainer.py:917-998), reported apart. Under an
    active `sp` the batch is a sequence shard whose labels the host shifted
    (`parallel.sp.layout_batch`), so the loss takes them unshifted."""
    shift = not (sp is not None and sp.active)
    ps3 = cfg.vision_tower_type == "ps3"
    sel_probs = []
    if ps3:
        out, sel_probs = vlm.forward_batch_ps3(params, cfg, batch, attn_impl=attn_impl,
                                               return_hidden=bool(ce_chunk_size), sp=sp)
    else:
        out = vlm.forward_batch(params, cfg, batch, attn_impl=attn_impl,
                                return_hidden=bool(ce_chunk_size), sp=sp)
    if ce_chunk_size:
        loss, n_tokens = chunked_causal_lm_loss(
            out, params["llm"], cfg.llm, batch["labels"], chunk_size=ce_chunk_size,
            shift=shift)
    else:
        loss, n_tokens = causal_lm_loss(out, batch["labels"], shift=shift)
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


# --------------------------------------------------------------------------
# ZeRO-3 on a mesh
# --------------------------------------------------------------------------


class _GatherShard(torch.autograd.Function):
    """The whole tensor from every rank's chunk along `dim`; backward: the
    gradient reduce-scattered (summed) back into the chunk."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        from vila_tpu_torch.parallel.mesh import gather_tensor

        ctx.args = (dim, group)
        return gather_tensor(shard, dim, group)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        dim, group = ctx.args
        n = dist.get_world_size(group)
        chunks = torch.cat(g.chunk(n, dim), 0).contiguous()  # rank r's part r-th
        out = torch.empty((chunks.shape[0] // n,) + tuple(chunks.shape[1:]), dtype=g.dtype,
                          device=g.device)
        dist.reduce_scatter_tensor(out, chunks, op=dist.ReduceOp.SUM, group=group)
        return out, None, None


class _LazyLayers:
    """Layer l of a sharded stacked tensor, gathered when asked for."""

    def __init__(self, parts, dim, group):
        self.parts, self.dim, self.group = parts, dim, group

    def __getitem__(self, l):
        return _GatherShard.apply(self.parts[l], self.dim, self.group)


class _LazyStack:
    """A stacked (L, ...) decoder parameter of which this rank holds a
    shard along `dim` (> 0): `unbind(0)`, the cache-free forward's one
    unbind a tensor, gives whole layers, each gathered when the layer
    runs."""

    def __init__(self, shard, dim, group):
        self.shard, self.dim, self.group = shard, dim, group

    def unbind(self, dim=0):
        if dim != 0:
            raise ValueError("a stacked parameter unbinds its layer dim only")
        return _LazyLayers(self.shard.unbind(0), self.dim - 1, self.group)


def _pairs(tree, dims):
    """(tensor, split dim) of every leaf, in `leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], dims[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v, d in zip(tree, dims) for p in _pairs(v, d)]
    return [(tree, dims)] if isinstance(tree, torch.Tensor) else []


def _gathered(tree, dims, group, lazy):
    if isinstance(tree, dict):
        return {k: _gathered(v, dims[k], group, lazy) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_gathered(v, d, group, lazy) for v, d in zip(tree, dims))
    if dims is None or not isinstance(tree, torch.Tensor):
        return tree
    if lazy and dims > 0:
        return _LazyStack(tree, dims, group)
    return _GatherShard.apply(tree, dims, group)


def _materialise(shards, dims, group=None):
    """The forward's parameter tree: split leaves gathered (the LLM's
    decoder layers lazily, one layer when it runs), replicated ones as
    they are."""
    out = {k: _gathered(v, dims[k], group, False) for k, v in shards.items() if k != "llm"}
    out["llm"] = {k: _gathered(v, dims["llm"][k], group, k == "layers")
                  for k, v in shards["llm"].items()}
    return out


def sharded_norm(pairs, group=None) -> torch.Tensor:
    """Global norm of whole gradients from (shard grad, split dim) pairs:
    split ones summed over the group, replicated ones counted once."""
    import torch.distributed as dist

    split = [g.float().square().sum() for g, d in pairs if d is not None]
    rep = [g.float().square().sum() for g, d in pairs if d is None]
    dev = pairs[0][0].device
    total = torch.stack(split).sum() if split else torch.zeros((), device=dev)
    dist.all_reduce(total, group=group)
    if rep:
        total = total + torch.stack(rep).sum()
    return total.sqrt()


def sharded_train_step(shards, opt_state: OptState, batch, *, cfg, optimizer: Optimizer, dims,
                       ce_chunk_size: Optional[int] = None, sp=None, attn_impl: str = "auto"):
    """One ZeRO-3 step on this rank's shards and batch shard
    (`parallel.distributed.host_local_batch`). Returns (shards, opt_state,
    metrics); metrics are global (loss, token count, grad norm)."""
    import torch.distributed as dist

    pairs = _pairs(shards, dims)
    for t, _ in pairs:
        t.requires_grad_(True)
        t.grad = None
    loss, metrics = loss_fn(_materialise(shards, dims), cfg, batch, ce_chunk_size, attn_impl,
                            sp=sp)
    n_local = metrics["n_tokens"]
    n_global = n_local.detach().clone().to(torch.float32)
    dist.all_reduce(n_global)
    part = loss * n_local.to(torch.float32) / n_global.clamp(min=1)
    part.backward()
    grads = _fill_grads([t for t, _ in pairs])  # unused leaves: zeros, as JAX
    rep = [g for g, (_, d) in zip(grads, pairs) if d is None]
    if rep:  # replicated leaves: sum every rank's contribution
        flat = torch.cat([g.reshape(-1).float() for g in rep])
        dist.all_reduce(flat)
        for g, f in zip(rep, flat.split([g.numel() for g in rep])):
            g.copy_(f.view_as(g))
    grad_dims = [(g, d) for g, (_, d) in zip(grads, pairs)]
    grad_norm = sharded_norm(grad_dims)
    split_of = {id(t): d for t, d in pairs}

    def norm(name, gs):
        return sharded_norm([(g, split_of[id(t)]) for g, t in zip(gs, leaves(shards[name]))])

    opt_state = optimizer.update(opt_state, shards, norm=norm)
    for t, _ in pairs:
        t.grad = None
    total = part.detach().clone()
    dist.all_reduce(total)
    metrics = {"loss": total, "n_tokens": n_global.to(torch.int64), "grad_norm": grad_norm}
    return shards, opt_state, metrics


def make_sharded_train_step(cfg, params: Dict[str, Any], optimizer: Optimizer, mesh,
                            ce_chunk_size: Optional[int] = None, sp_attention: bool = False,
                            ring_layout: str = "zigzag", attn_impl: str = "auto"):
    """(step_fn, shards, opt_state, dims) on `mesh` (`parallel.mesh.make_mesh`):
    `params` (whole, on this rank's device) cut into this rank's shards by
    the JAX package's FSDP specs, `dims` the tree of each leaf's split dim
    (None: replicated), the optimizer state over the shards.
    `step_fn(shards, opt_state, batch)` takes this rank's batch shard.

    With `sp_attention` and sp x su > 1 every decoder attention runs MM-SP
    (ring / Ulysses / hybrid); feed batches through
    `parallel.sp.layout_batch` then `host_local_batch`."""
    from vila_tpu_torch.parallel import mesh as mesh_lib
    from vila_tpu_torch.parallel.sp import SPConfig

    if cfg.vision_tower_type == "ps3":
        raise NotImplementedError("PS3's selection loss is not sharded: train PS3 on one device")
    if getattr(optimizer, "cfg", None) is not None and optimizer.cfg.optimizer != "adamw":
        raise NotImplementedError("the sharded step takes optimizer='adamw'")
    dims = mesh_lib.shard_dims(params, mesh_lib.vlm_param_specs(cfg, params, mesh), mesh)
    shards = mesh_lib.shard_params(params, dims, mesh)
    opt_state = optimizer.init(shards)
    sp = SPConfig(mesh=mesh, ring_layout=ring_layout) if sp_attention else None
    if sp is not None and not sp.active:
        sp = None
    step = functools.partial(sharded_train_step, cfg=cfg, optimizer=optimizer, dims=dims,
                             ce_chunk_size=ce_chunk_size, sp=sp, attn_impl=attn_impl)
    return step, shards, opt_state, dims
