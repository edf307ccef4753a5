"""LLM context extension, LongVILA stage 4, as
`vila_tpu/train/context_extend.py` (the reference's
`longvila/train/4_extend_llm_{64k,...}.sh` and
`llava/train/train_llm_to_long.py:85-111`): the LLM alone trains on long
text chunks with rope_theta raised (the 64k recipe's 15.3e6), optional
linear RoPE scaling and LoRA factors that are merged into the base weights
at the end.

With sp x su > 1 (a mesh over the default process group, world size sp x
su) every rank takes its sequence shard of each chunk (zigzag when the
layout applies) and the decoder's attention runs MM-SP
(`parallel/sp.py`); remat recomputes each layer in the backward and the
chunked cross entropy never materialises the (B, S, V) logits. The frozen
base and the LoRA factors are replicated on every rank (the JAX package
FSDP-shards the base through GSPMD): each rank's loss is its tokens'
summed cross entropy over the global count and the factors' gradients are
summed over the ranks, so every rank takes the same AdamW step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class ContextExtendArgs:
    target_context: int = 65536
    rope_theta: float = 15.3e6  # 4_extend_llm_64k.sh:16
    rope_linear_scaling: float = 1.0
    lora_rank: int = 16
    lora_alpha: float = 32.0
    learning_rate: float = 2e-5
    steps: int = 40  # ctx-64k = 40 steps in the reference recipe
    seq_len: int = 65536
    # mesh: ring degree x Ulysses degree (sp_degree = sp x su)
    sp: int = 1
    su: int = 1
    ring_layout: str = "zigzag"
    remat: bool = True
    ce_chunk_size: int = 1024


def extended_config(llm_cfg, args: ContextExtendArgs):
    """The LLM config with the recipe's RoPE and remat."""
    return dataclasses.replace(
        llm_cfg, rope_theta=args.rope_theta, rope_linear_scaling=args.rope_linear_scaling,
        max_position_embeddings=args.target_context, remat=args.remat)


def host_chunk(ids: np.ndarray, sp_plan=None, mesh=None):
    """(ids, positions, labels) of one (B, S) token chunk for this rank:
    labels shifted on the host (the loss takes them unshifted, whatever the
    layout), zigzag-permuted when the layout applies, then this rank's
    sequence slice."""
    from vila_tpu_torch.constants import IGNORE_INDEX
    from vila_tpu_torch.parallel.ring_attention import zigzag_order

    ids = np.asarray(ids, np.int32)
    s = ids.shape[1]
    positions = np.broadcast_to(np.arange(s, dtype=np.int32), ids.shape).copy()
    labels = np.full_like(ids, IGNORE_INDEX)
    labels[:, :-1] = np.where(ids[:, 1:] >= 0, ids[:, 1:], IGNORE_INDEX)
    arrs = [ids, positions, labels]
    if sp_plan is not None and sp_plan.layout_for(s) == "zigzag":
        order = zigzag_order(s, sp_plan.ring_degree)
        arrs = [np.ascontiguousarray(x[:, order]) for x in arrs]
    if mesh is not None:
        sl = mesh.seq_slice(s)
        arrs = [np.ascontiguousarray(x[:, sl]) for x in arrs]
    return tuple(arrs)


def extend_loss(lora, base, lora_cfg, ext_cfg, ids, positions, labels, ce_chunk_size=1024,
                sp_plan=None):
    """(mean loss over this rank's tokens, their count) of the adapted
    model on one (shard of a) chunk; labels pre-shifted."""
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.train import lora as lora_lib
    from vila_tpu_torch.train.losses import causal_lm_loss, chunked_causal_lm_loss

    merged = lora_lib.apply_lora(base, lora, lora_cfg)["llm"]
    if ce_chunk_size:
        hidden, _ = qwen2.forward(merged, ext_cfg, input_ids=ids, positions=positions,
                                  return_hidden=True, sp=sp_plan)
        return chunked_causal_lm_loss(hidden, merged, ext_cfg, labels,
                                      chunk_size=ce_chunk_size, shift=False)
    logits, _ = qwen2.forward(merged, ext_cfg, input_ids=ids, positions=positions, sp=sp_plan)
    return causal_lm_loss(logits, labels, shift=False)


def extend_llm(llm_params: Dict[str, Any], llm_cfg, text_batches, args: ContextExtendArgs,
               lora: Optional[Dict[str, Any]] = None, seed: int = 0):
    """Train LoRA factors on long chunks with the extended RoPE; return
    (merged_params, extended_cfg, losses). `lora` gives the initial
    factors (default `init_lora` from a generator seeded with `seed` on the
    parameters' device); the parameters' device is the step's."""
    import torch.distributed as dist

    from vila_tpu_torch.parallel import mesh as mesh_lib
    from vila_tpu_torch.parallel.sp import SPConfig
    from vila_tpu_torch.train import lora as lora_lib
    from vila_tpu_torch.train.optimizer import adamw, leaves
    from vila_tpu_torch.utils.device import host_to_device

    ext_cfg = extended_config(llm_cfg, args)
    sp_plan = mesh = None
    if args.sp * args.su > 1:
        mesh = mesh_lib.make_mesh(sp=args.sp, su=args.su)
        sp_plan = SPConfig(mesh=mesh, ring_layout=args.ring_layout)
    dev = llm_params["embed_tokens"]["embedding"].device
    lcfg = lora_lib.LoRAConfig(rank=args.lora_rank, alpha=args.lora_alpha)
    if lora is None:
        lora = lora_lib.init_lora(torch.Generator(dev).manual_seed(seed), llm_params, lcfg)
    opt = adamw(args.learning_rate)
    opt_state = opt.init(lora)
    base = {"llm": lora_lib._detached(llm_params)}
    ts = leaves(lora)

    losses = []
    for i, ids in enumerate(text_batches):
        if i >= args.steps:
            break
        arrs = [host_to_device(x, dev) for x in host_chunk(ids, sp_plan, mesh)]
        for t in ts:
            t.requires_grad_(True)
            t.grad = None
        loss, n = extend_loss(lora, base, lcfg, ext_cfg, *arrs, ce_chunk_size=args.ce_chunk_size,
                              sp_plan=sp_plan)
        if mesh is None:
            loss.backward()
            total = loss.detach()
        else:
            n_global = n.detach().clone().to(torch.float32)
            dist.all_reduce(n_global)
            part = loss * n.to(torch.float32) / n_global.clamp(min=1)
            part.backward()
            flat = torch.cat([t.grad.reshape(-1) for t in ts])
            dist.all_reduce(flat)
            for t, g in zip(ts, flat.split([t.numel() for t in ts])):
                t.grad.copy_(g.view_as(t))
            total = part.detach().clone()
            dist.all_reduce(total)
        opt_state = opt.update(opt_state, lora)
        for t in ts:
            t.grad = None
        losses.append(float(total))

    with torch.no_grad():
        merged = lora_lib.merge_lora(base, lora, lcfg)["llm"]
    return merged, ext_cfg, losses


def chunk_text_dataset(token_stream: np.ndarray, seq_len: int, batch: int = 1):
    """SlimPajama-style chunking: a flat token stream -> (B, S) batches
    (train_llm_to_long.py's chunked loader)."""
    n = (len(token_stream) // (seq_len * batch)) * seq_len * batch
    arr = np.asarray(token_stream[:n], np.int32).reshape(-1, batch, seq_len)
    for b in arr:
        yield b
