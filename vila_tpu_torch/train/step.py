"""The training step, as `vila_tpu/train/step.py` (`loss_fn`,
`train_step`, `make_sharded_train_step`). `make_train_step` binds it to one
device; `make_sharded_train_step` runs it on a (dp, sp, su, tp) mesh as
ZeRO-3 and Megatron tensor parallelism by hand, what GSPMD derives from the
JAX package's FSDP + tp specs:

  * each rank holds its shard of every parameter (`parallel/mesh.py`'s
    rules: rank r holds the slice JAX puts on device r) and the optimizer
    state of that shard;
  * the forward all-gathers each decoder layer's weights over the FSDP
    group (dp, sp, su) when that layer runs (with remat, again in the
    backward), the rest once a step, and keeps their tp chunks: the LLM's
    and a SigLIP tower's linears run tensor parallel
    (`parallel/tensor_parallel.py`); a leaf split over tp that runs whole
    (the projector's kernels) is gathered over tp too. The FSDP gather's
    backward reduce-scatters (sums) the gradient into the shard; leaves not
    split over FSDP have their gradients all-reduced over the FSDP group;
    the tp ranks' gradients of a leaf whole over tp are already equal (the
    column-parallel backward sums the partial input gradients);
  * every rank's loss is its tokens' summed cross entropy over the FSDP
    group's token count, so the summed gradients are those of the global
    mean (dp averaging included); a PS3 batch's selection loss counts each
    dp row once, weighted by its share of the rows with gt maps; the clip
    norm counts every element once over the mesh, and the optimizer steps
    the shards: `Optimizer` (AdamW, or fp8 AdamW whose blocks of 128 are
    those of the whole tensor, `train/fp8_adamw.py`) or a tree optimizer
    (`optimizer.adamw` / `adam`: no clipping, as optax's).

`apply_gradients` is the step of the other training modes (LoRA, DPO,
reward, PPO, SFT): the gradients of a loss over any tree of trainable
tensors, then one update of its optimizer.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vila_tpu_torch.models import vlm
from vila_tpu_torch.train.losses import chunked_causal_lm_loss, token_selection_loss
from vila_tpu_torch.train.optimizer import (
    Optimizer,
    OptState,
    _fill_grads,
    global_norm,
    leaves,
)
from vila_tpu_torch.utils import profiling
from vila_tpu_torch.utils.device import host_to_device


def _loss_parts(params, cfg, batch, ce_chunk_size, attn_impl, sp, tp):
    """(LM loss, its token count, the PS3 selection loss or None). The
    forward stops at the final hidden states; `chunked_causal_lm_loss`
    takes the LM head from there (fused on the card, chunked with
    `ce_chunk_size`, else over the whole logits)."""
    shift = not (sp is not None and sp.active)
    ps3 = cfg.vision_tower_type == "ps3"
    sel_probs = []
    if ps3:
        out, sel_probs = vlm.forward_batch_ps3(params, cfg, batch, attn_impl=attn_impl,
                                               return_hidden=True, sp=sp, tp=tp)
    else:
        out = vlm.forward_batch(params, cfg, batch, attn_impl=attn_impl, return_hidden=True,
                                sp=sp, tp=tp)
    loss, n_tokens = chunked_causal_lm_loss(out, params["llm"], cfg.llm, batch["labels"],
                                            chunk_size=ce_chunk_size or None, shift=shift,
                                            tp=tp)
    sel = None
    if ps3 and sel_probs and batch.get("gt_selection_maps") is not None:
        gt = batch["gt_selection_maps"]
        sel = token_selection_loss(sel_probs, gt.reshape((-1,) + gt.shape[2:]))
    return loss, n_tokens, sel


def loss_fn(params, cfg, batch, ce_chunk_size: Optional[int] = None,
            attn_impl: str = "auto", token_selection_loss_weight: float = 1.0,
            sp=None, tp=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of one batch; the chunked cross entropy never
    materialises the (B, S, V) logits. A PS3 batch with gt selection maps
    adds `token_selection_loss_weight` x the selection loss (the reference's
    top-down trainer, llava_trainer.py:917-998), reported apart. Under an
    active `sp` the batch is a sequence shard whose labels the host shifted
    (`parallel.sp.layout_batch`), so the loss takes them unshifted; under
    `tp` the parameters are this rank's tp chunks (`vlm.forward_batch`)."""
    loss, n_tokens, sel = _loss_parts(params, cfg, batch, ce_chunk_size, attn_impl, sp, tp)
    metrics = {"n_tokens": n_tokens}
    if sel is not None:
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
    aux, the gradients' global norm, opt_state). Spans: `train.step`
    (with the loss's `n_tokens` where `aux` has it) over `train.forward`,
    `train.backward` and `train.update`."""
    ts = leaves(trainable)
    with profiling.annotate("train.step") as step:
        for t in ts:
            t.requires_grad_(True)
            t.grad = None
        with profiling.annotate("train.forward"):
            loss, aux = compute_loss()
        if step and isinstance(aux, dict) and "n_tokens" in aux:
            step.set(tokens=aux["n_tokens"])
        with profiling.annotate("train.backward"):
            loss.backward()
        with profiling.annotate("train.update"):
            grad_norm = global_norm([t.grad for t in ts])
            opt_state = optimizer.update(opt_state, trainable)
            for t in ts:
                t.grad = None
    return loss.detach(), aux, grad_norm, opt_state


def batch_to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """A collated numpy batch as tensors on `device` (asynchronous copies
    on the card); a list value (PS3's views, one array a high scale)
    becomes a list of tensors. Span: `train.to_device`, with its bytes."""
    with profiling.annotate("train.to_device") as span:
        out = {k: ([host_to_device(x, device) for x in v] if isinstance(v, list)
                   else host_to_device(v, device)) for k, v in batch.items()}
        if span:
            span.set(bytes=sum(getattr(x, "nbytes", 0) for v in batch.values()
                               for x in (v if isinstance(v, list) else [v])))
    return out


def make_train_step(cfg, params: Dict[str, Any], optimizer: Optimizer,
                    ce_chunk_size: Optional[int] = None):
    """(step_fn, params, opt_state) on the device the params live on;
    `step_fn(params, opt_state, batch)` takes a batch of tensors there."""
    opt_state = optimizer.init(params)
    step = functools.partial(train_step, cfg=cfg, optimizer=optimizer,
                             ce_chunk_size=ce_chunk_size)
    return step, params, opt_state


# --------------------------------------------------------------------------
# ZeRO-3 and tensor parallelism on a mesh
# --------------------------------------------------------------------------


class _GatherShard(torch.autograd.Function):
    """The whole tensor from every rank's chunk along `dim`; backward: the
    gradient reduce-scattered (summed) back into the chunk. Spans:
    `parallel.zero_gather` and `parallel.zero_scatter`, with the bytes of
    the whole tensor."""

    @staticmethod
    def forward(ctx, shard, dim, group):
        from vila_tpu_torch.parallel.mesh import gather_tensor

        ctx.args = (dim, group)
        with profiling.annotate("parallel.zero_gather") as span:
            out = gather_tensor(shard, dim, group)
            if span:
                span.set(bytes=out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        dim, group = ctx.args
        n = dist.get_world_size(group)
        if n == 1:
            return g, None, None
        with profiling.annotate("parallel.zero_scatter") as span:
            chunks = torch.cat(g.chunk(n, dim), 0).contiguous()  # rank r's part r-th
            out = torch.empty((chunks.shape[0] // n,) + tuple(chunks.shape[1:]), dtype=g.dtype,
                              device=g.device)
            dist.reduce_scatter_tensor(out, chunks, op=dist.ReduceOp.SUM, group=group)
            if span:
                span.set(bytes=chunks.numel() * chunks.element_size())
        return out, None, None


def _use(shard, split, mesh, tp_local: bool, drop: int = 0):
    """The forward's view of a shard: its FSDP dim gathered (the backward
    reduce-scatters), its tp dim kept when the leaf runs tensor parallel,
    else gathered too; `drop` leading dims were indexed away."""
    from vila_tpu_torch.parallel import tensor_parallel as tpl
    from vila_tpu_torch.parallel.mesh import FSDP

    x = shard
    if split.fsdp is not None:
        x = _GatherShard.apply(x, split.fsdp - drop, mesh.group(FSDP))
    if split.tp is not None and not tp_local:
        x = tpl.gather_leaf(x, split.tp - drop, tpl.TPConfig(mesh))
    return x


class _LazyLayers:
    """Layer l of a sharded stacked tensor, gathered when asked for."""

    def __init__(self, parts, split, mesh, tp_local):
        self.parts, self.split, self.mesh, self.tp_local = parts, split, mesh, tp_local

    def __getitem__(self, l):
        return _use(self.parts[l], self.split, self.mesh, self.tp_local, drop=1)


class _LazyStack:
    """A stacked (L, ...) decoder parameter of which this rank holds a
    shard (its dims > 0): `unbind(0)`, the cache-free forward's one unbind
    a tensor, gives whole layers (but for their tp chunk), each gathered
    when the layer runs."""

    def __init__(self, shard, split, mesh, tp_local):
        self.shard, self.split, self.mesh, self.tp_local = shard, split, mesh, tp_local

    def unbind(self, dim=0):
        if dim != 0:
            raise ValueError("a stacked parameter unbinds its layer dim only")
        return _LazyLayers(self.shard.unbind(0), self.split, self.mesh, self.tp_local)


# the leaves each model runs tensor parallel (their tp chunks kept)
_TP_LLM = {("embed_tokens", "embedding"), ("lm_head", "kernel")} | {
    ("layers", n, k) for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                               "down_proj") for k in ("kernel", "bias")}
_TP_SIGLIP = {("layers", n, k) for n in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")
              for k in ("kernel", "bias")}


def tp_local_paths(cfg):
    """The paths of the leaves whose tp chunks the tensor-parallel forward
    consumes (`vlm.forward_batch`'s LLM, and a SigLIP or PS3 trunk)."""
    paths = {("llm",) + p for p in _TP_LLM}
    if cfg.vision_tower_type == "siglip":
        paths |= {("vision_tower",) + p for p in _TP_SIGLIP}
    elif cfg.vision_tower_type == "ps3":
        paths |= {("vision_tower", "vit") + p for p in _TP_SIGLIP}
    return paths


def _pairs(tree, dims):
    """(tensor, split) of every leaf, in `leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _pairs(tree[k], dims[k])]
    if isinstance(tree, (list, tuple)):
        return [p for v, d in zip(tree, dims) for p in _pairs(v, d)]
    return [(tree, dims)] if isinstance(tree, torch.Tensor) else []


def _materialise(shards, dims, mesh, local_paths=frozenset(), path=()):
    """The forward's parameter tree: split leaves gathered over FSDP (the
    LLM's decoder layers lazily, one layer when it runs) and over tp unless
    their path is in `local_paths`; whole leaves as they are."""
    if isinstance(shards, dict):
        return {k: _materialise(v, dims[k], mesh, local_paths, path + (k,))
                for k, v in shards.items()}
    if isinstance(shards, (list, tuple)):
        return type(shards)(_materialise(v, d, mesh, local_paths, path + (i,))
                            for i, (v, d) in enumerate(zip(shards, dims)))
    if dims is None or not isinstance(shards, torch.Tensor):
        return shards
    tp_local = path in local_paths
    if path[:2] == ("llm", "layers"):
        return _LazyStack(shards, dims, mesh, tp_local)
    return _use(shards, dims, mesh, tp_local)


def sharded_norm(pairs, mesh) -> torch.Tensor:
    """Global norm of whole gradients from (shard grad, split) pairs: each
    element counted once over the mesh (a shard summed over the ranks that
    split it, a copy counted once); `global_norm` when nothing is split."""
    import torch.distributed as dist

    from vila_tpu_torch.parallel.mesh import AXES, FSDP

    if all(d is None for _, d in pairs):  # nothing split: one device's norm, bit for bit
        return global_norm([g for g, _ in pairs])
    by_axes: Dict[Tuple[str, ...], list] = {}
    for g, d in pairs:
        axes = () if d is None else tuple(
            a for a in AXES if (d.fsdp is not None and a in FSDP) or (d.tp is not None
                                                                      and a == "tp"))
        by_axes.setdefault(axes, []).append(g.float().square().sum())
    dev = pairs[0][0].device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for axes in sorted(by_axes):
        part = torch.stack(by_axes[axes]).sum()
        if axes and mesh.axis_size(axes) > 1:
            dist.all_reduce(part, group=mesh.group(axes))
        total = total + part
    return total.sqrt()


def _shard_layouts(shards, dims, mesh):
    """The tree of each split leaf's place in the whole tensor (None for
    whole leaves): what fp8 AdamW needs for its blocks of the whole
    tensor."""
    from vila_tpu_torch.parallel.mesh import FSDP, map_tree
    from vila_tpu_torch.train.fp8_adamw import ShardLayout

    def one(t, d):
        if d is None:
            return None
        shape, starts = list(t.shape), [0] * t.ndim
        for dim, axes in ((d.fsdp, FSDP), (d.tp, "tp")):
            if dim is not None:
                starts[dim] = mesh.axis_index(axes) * t.shape[dim]
                shape[dim] = t.shape[dim] * mesh.axis_size(axes)
        return ShardLayout(tuple(shape), tuple(starts))

    return map_tree(one, shards, dims)


def _selection_weight(batch, mesh) -> torch.Tensor:
    """This rank's weight of its selection loss in the global one: its
    rows with a gt map over the mesh's (each dp row counted on the first
    rank of its sequence group only; tp ranks count their copies alike)."""
    import torch.distributed as dist

    from vila_tpu_torch.parallel.mesh import FSDP, SEQ

    gt = batch["gt_selection_maps"]
    gt = gt.reshape((-1,) + gt.shape[2:]).float()
    first = float(mesh.axis_index(SEQ) == 0)
    count = (gt.sum(dim=(-1, -2)) > 0).float().sum()  # token_selection_loss's divisor
    total = count * first
    dist.all_reduce(total, group=mesh.group(FSDP))
    return first * count.clamp(min=1.0) / total.clamp(min=1.0)


def sharded_train_step(shards, opt_state: OptState, batch, *, cfg, optimizer, dims, mesh,
                       ce_chunk_size: Optional[int] = None, sp=None, tp=None,
                       attn_impl: str = "auto", token_selection_loss_weight: float = 1.0):
    """One ZeRO-3 (and tensor-parallel) step on this rank's shards and
    batch shard (`parallel.distributed.host_local_batch`). Returns
    (shards, opt_state, metrics); metrics are global (loss, token count,
    grad norm, and a PS3 batch's selection loss). Spans as
    `apply_gradients`', the gradients' reduction inside `train.backward`."""
    import torch.distributed as dist

    from vila_tpu_torch.parallel.mesh import FSDP
    from vila_tpu_torch.parallel.tensor_parallel import active

    data = mesh.group(FSDP)
    pairs = _pairs(shards, dims)
    with profiling.annotate("train.step") as step:
        for t, _ in pairs:
            t.requires_grad_(True)
            t.grad = None
        with profiling.annotate("train.forward"):
            local = frozenset(tp_local_paths(cfg)) if active(tp) else frozenset()
            params = _materialise(shards, dims, mesh, local)
            loss, n_local, sel = _loss_parts(params, cfg, batch, ce_chunk_size, attn_impl, sp,
                                             tp)
            n_global = n_local.detach().clone().to(torch.float32)
            dist.all_reduce(n_global, group=data)
            part = loss * n_local.to(torch.float32) / n_global.clamp(min=1)
            sel_part = None
            if sel is not None:
                sel_part = sel * _selection_weight(batch, mesh)
                part = part + token_selection_loss_weight * sel_part
        if step:
            step.set(tokens=n_global)
        with profiling.annotate("train.backward"):
            part.backward()
            grads = _fill_grads([t for t, _ in pairs])  # unused leaves: zeros, as JAX
            rep = [g for g, (_, d) in zip(grads, pairs) if d is None or d.fsdp is None]
            if rep and mesh.axis_size(FSDP) > 1:  # sum every data rank's contribution
                flat = torch.cat([g.reshape(-1).float() for g in rep])
                dist.all_reduce(flat, group=data)
                for g, f in zip(rep, flat.split([g.numel() for g in rep])):
                    g.copy_(f.view_as(g))
        with profiling.annotate("train.update"):
            grad_norm = sharded_norm([(g, d) for g, (_, d) in zip(grads, pairs)], mesh)
            if isinstance(optimizer, Optimizer):
                split_of = {id(t): d for t, d in pairs}

                def norm(name, gs):
                    return sharded_norm([(g, split_of[id(t)])
                                         for g, t in zip(gs, leaves(shards[name]))], mesh)

                opt_state = optimizer.update(opt_state, shards, norm=norm)
            else:  # a tree optimizer: no clipping
                opt_state = optimizer.update(opt_state, shards)
            for t, _ in pairs:
                t.grad = None
    total = part.detach().clone()
    dist.all_reduce(total, group=data)
    metrics = {"loss": total, "n_tokens": n_global.to(torch.int64), "grad_norm": grad_norm}
    if sel_part is not None:
        sel_total = sel_part.detach().clone()
        dist.all_reduce(sel_total, group=data)
        metrics["token_selection_loss"] = sel_total
    return shards, opt_state, metrics


def make_sharded_train_step(cfg, params: Dict[str, Any], optimizer, mesh,
                            ce_chunk_size: Optional[int] = None, sp_attention: bool = False,
                            ring_layout: str = "zigzag", attn_impl: str = "auto",
                            token_selection_loss_weight: float = 1.0):
    """(step_fn, shards, opt_state, dims) on `mesh` (`parallel.mesh.make_mesh`):
    `params` (whole, on this rank's device) cut into this rank's shards by
    the JAX package's FSDP + tp specs, `dims` the tree of each leaf's
    `mesh.Split` (None: whole), the optimizer state over the shards.
    `optimizer` is `make_optimizer`'s (AdamW or fp8 AdamW, clipped per
    component) or a tree optimizer (`optimizer.adamw` / `adam`).
    `step_fn(shards, opt_state, batch)` takes this rank's batch shard.

    With tp > 1 the LLM and a SigLIP / PS3 trunk run tensor parallel; a tp
    degree that divides none of their dims raises. With `sp_attention` and
    sp x su > 1 every decoder attention runs MM-SP (ring / Ulysses /
    hybrid) over the rank's heads; feed batches through
    `parallel.sp.layout_batch` then `host_local_batch`."""
    from vila_tpu_torch.parallel import mesh as mesh_lib
    from vila_tpu_torch.parallel import tensor_parallel as tpl
    from vila_tpu_torch.parallel.sp import SPConfig

    tp = tpl.TPConfig(mesh)  # inactive at tp 1: the mesh for fp8's whole-tensor scales
    llm = cfg.llm
    tpl.check_divides((llm.vocab_size, llm.num_attention_heads * llm.head_dim_,
                       llm.num_key_value_heads * llm.head_dim_, llm.intermediate_size), tp)
    dims = mesh_lib.shard_dims(params, mesh_lib.vlm_param_specs(cfg, params, mesh), mesh)
    shards = mesh_lib.shard_params(params, dims, mesh)
    opt_state = optimizer.init(shards, layouts=_shard_layouts(shards, dims, mesh))
    sp = SPConfig(mesh=mesh, ring_layout=ring_layout) if sp_attention else None
    if sp is not None and not sp.active:
        sp = None
    step = functools.partial(sharded_train_step, cfg=cfg, optimizer=optimizer, dims=dims,
                             mesh=mesh, ce_chunk_size=ce_chunk_size, sp=sp, tp=tp,
                             attn_impl=attn_impl,
                             token_selection_loss_weight=token_selection_loss_weight)
    return step, shards, opt_state, dims
