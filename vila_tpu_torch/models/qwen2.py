"""Qwen2/Llama-family decoder-only LM, as `vila_tpu/models/qwen2.py`.

Parameters are the JAX package's tree (plain dicts, decoder layers stacked
on a leading axis) holding torch tensors; the forward pass is a Python loop
over the layers. Numerics follow HF `modeling_qwen2`: RMSNorm and softmax
statistics in float32, rotate-half RoPE with float32 cos/sin, GQA, SwiGLU.

The KV cache keeps the JAX layout, flat `(L, B, S, Hkv*hd)` with a `(B, S)`
validity mask and a write cursor `fill`: a Python int shared by the rows,
or with `init_cache(per_slot_fill=True)` a `(B,)` int32 tensor on the
device plus its host copy `fill_host`, each row at its own depth (the
continuous batcher, `serving/batcher.py`). Per-slot writes past the cache
drop, as the JAX scatter's `mode="drop"`; every such decision is taken from
the host copy, so a step never reads the device back. Unlike the
functional JAX cache it is updated in place: `forward` writes the new rows
into the given tensors and returns a dict with the advanced cursor.

W4 decoder weights (`ops/quant.py`, stacked `(L, nj, din/2, bout)`) are
never sliced per layer: the kernels take the whole stacked slot and a layer
index. A decode step (s == 1, b <= 32) with the fused W4 slots takes the
JAX package's routes, chosen by the same conditions:

  * b == 1 with the GQA-padded o layout: `fused_decode.fused_layer` (K3,
    the mega path, `_mega_decode`);
  * 1 < b <= 16, padded o, group padded to 8: `fused_decode.
    fused_layer_batched` (K6, `_mega_b_decode`);
  * otherwise: plain attention, then `fused_o_gateup` (K4) and
    `fused_down_qkv` (K5) (`_fused_decode`).

Everything else runs each projection as one W4 matmul
(`w4_matmul_stacked_dispatch`).

The cache-free path is also the training forward: it differentiates with
f32 master weights and a bf16 compute dtype (weights cast inside the
graph; the tied embedding's two uses accumulate into one gradient), takes
each layer's dense weights as views of one `unbind` per stacked tensor (so
the backward stacks one gradient per tensor instead of summing a full-size
one per layer), and runs each layer under `torch.utils.checkpoint` with
`cfg.remat` (True: full recompute; "dots": matmul outputs kept, JAX's
`dots_with_no_batch_dims_saveable`). Its attention takes the flash kernels
on the card (`ops/attention.py`). With `cfg.fp8_matmul` every dense
projection runs through `ops/fp8.py` (per-tensor or per-group COAT fp8).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from vila_tpu_torch.ops.attention import multi_head_attention
from vila_tpu_torch.ops.norms import rms_norm
from vila_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from vila_tpu_torch.utils.device import host_to_device, resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 151936
    hidden_size: int = 1536
    intermediate_size: int = 8960
    num_hidden_layers: int = 28
    num_attention_heads: int = 12
    num_key_value_heads: int = 2
    head_dim: Optional[int] = None
    rope_theta: float = 1e6
    rope_linear_scaling: float = 1.0
    rms_norm_eps: float = 1e-6
    tie_word_embeddings: bool = True
    qkv_bias: bool = True  # Qwen2: q/k/v have bias, o_proj does not
    max_position_embeddings: int = 32768
    dtype: str = "float32"  # compute dtype
    # False | True (full recompute per layer) | "dots" (matmul outputs kept)
    remat: Any = False
    # FP8 decoder matmuls (ops/fp8.py): False | True / "tensor" (per-tensor
    # scales, `fp8_linear`) | "group" (COAT's per-group recipe,
    # `fp8_linear_grouped`)
    fp8_matmul: Any = False

    def __post_init__(self):
        if self.fp8_matmul not in (False, True, "tensor", "group"):
            raise ValueError(
                f"fp8_matmul must be False, True, 'tensor' or 'group', got {self.fp8_matmul!r}")
        if self.remat not in (False, True, "dots"):
            raise ValueError(f"remat must be False, True or 'dots', got {self.remat!r}")

    @classmethod
    def from_hf_config(cls, hf: dict, **overrides) -> "LLMConfig":
        """From an HF Qwen2/Llama config dict (config.json contents), as
        the JAX package's `LLMConfig.from_hf_config`."""
        rope_scaling = hf.get("rope_scaling") or {}
        linear = 1.0
        if rope_scaling.get("rope_type", rope_scaling.get("type")) == "linear":
            linear = float(rope_scaling.get("factor", 1.0))
        kw = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_linear_scaling=linear,
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            qkv_bias=hf.get("model_type", "qwen2") == "qwen2"
            or hf.get("attention_bias", False),
            max_position_embeddings=hf.get("max_position_embeddings", 32768),
        )
        kw.update(overrides)
        return cls(**kw)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


# --------------------------------------------------------------------------
# Parameters and cache
# --------------------------------------------------------------------------


def init_params(
    generator: torch.Generator, cfg: LLMConfig, param_dtype=torch.float32
) -> Params:
    """Random parameters (normal(0.02), as HF) on the generator's device,
    layers stacked on axis 0."""
    L, D, I = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim_
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    dev = generator.device

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=dev)
        return (0.02 * w).to(param_dtype)

    def ones(*shape):
        return torch.ones(shape, dtype=param_dtype, device=dev)

    layers = {
        "input_layernorm": {"scale": ones(L, D)},
        "q_proj": {"kernel": dense(L, D, Hq * hd)},
        "k_proj": {"kernel": dense(L, D, Hkv * hd)},
        "v_proj": {"kernel": dense(L, D, Hkv * hd)},
        "o_proj": {"kernel": dense(L, Hq * hd, D)},
        "post_attention_layernorm": {"scale": ones(L, D)},
        "gate_proj": {"kernel": dense(L, D, I)},
        "up_proj": {"kernel": dense(L, D, I)},
        "down_proj": {"kernel": dense(L, I, D)},
    }
    if cfg.qkv_bias:
        for name, width in (("q_proj", Hq * hd), ("k_proj", Hkv * hd),
                            ("v_proj", Hkv * hd)):
            layers[name]["bias"] = torch.zeros((L, width), dtype=param_dtype, device=dev)
    params: Params = {
        "embed_tokens": {"embedding": dense(cfg.vocab_size, D)},
        "layers": layers,
        "norm": {"scale": ones(D)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(D, cfg.vocab_size)}
    return params


def init_cache(
    cfg: LLMConfig, batch: int, max_len: int, dtype=None, device="cuda",
    per_slot_fill: bool = False,
) -> Params:
    """Pre-allocated decode cache (zeros); `valid` marks written,
    non-padding slots and `fill` is the shared write cursor.

    With `per_slot_fill` the cursor is a `(B,)` int32 tensor on the device
    and `fill_host` its host copy (int64 numpy): each batch row advances
    independently, as the continuous batcher needs. Whoever moves a cursor
    moves both."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.num_hidden_layers, batch, max_len,
             cfg.num_key_value_heads * cfg.head_dim_)
    cache = {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "valid": torch.zeros((batch, max_len), dtype=torch.bool, device=dev),
        "fill": 0,
    }
    if per_slot_fill:
        cache["fill"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        cache["fill_host"] = np.zeros((batch,), np.int64)
    return cache


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------


def _linear(x, p, dtype, fp8=False, groups=(None, None, None)):
    """x @ kernel (+ bias); `groups`: the process groups x, the kernel and
    the output are split over under tensor parallelism (per-tensor fp8
    scales of whole tensors)."""
    if "packed" in p:  # one layer's W4 slot
        from vila_tpu_torch.ops.quant import quantized_linear

        return quantized_linear(x, p, dtype)
    if fp8:  # COAT fp8 training (ops/fp8.py); the bias is added after
        from vila_tpu_torch.ops import fp8 as fp8_ops

        if fp8 == "group":
            y = fp8_ops.fp8_linear_grouped(x, p["kernel"].to(dtype))
        else:
            y = fp8_ops.fp8_linear(x, p["kernel"].to(dtype), groups)
    else:
        y = x @ p["kernel"].to(dtype)
    if "bias" in p:
        y = y + p["bias"].to(dtype)
    return y


def w4_matmul_stacked_dispatch(x2, packed, scales, layer_index):
    """Stacked W4 matmul: the GEMV kernel for M <= 32 rows, the GEMM kernel
    otherwise."""
    from vila_tpu_torch.ops.quant import w4_matmul_decode, w4_matmul_prefill

    if x2.shape[0] <= 32:
        return w4_matmul_decode(x2, packed, scales, layer_index=layer_index)
    return w4_matmul_prefill(x2, packed, scales, layer_index=layer_index)


def forward(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,  # (B, S)
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, D)
    positions: Optional[torch.Tensor] = None,  # (B, S) RoPE positions
    segment_ids: Optional[torch.Tensor] = None,  # (B, S) packing segments
    token_valid: Optional[torch.Tensor] = None,  # (B, S) False for padding
    cache: Optional[Params] = None,
    last_token_only: bool = False,
    gather_position: Optional[torch.Tensor] = None,  # (B,) per-sample index
    return_hidden: bool = False,
    attn_impl: Any = "auto",
    sp: Optional[Any] = None,  # parallel.sp.SPConfig: MM-SP attention
    cache_append: Optional[Any] = None,  # deferred (sharded-cache) append hook
    tp: Optional[Any] = None,  # parallel.tensor_parallel.TPConfig
) -> Tuple[torch.Tensor, Optional[Params]]:
    """Run the decoder. Returns (logits_or_hidden, updated_cache).

    With `cache`, the S new tokens are written at slots [fill, fill+S) and
    attend to every previously valid slot plus themselves (causally). A
    per-slot cursor (`init_cache(per_slot_fill=True)`) writes each row at
    its own depth and drops writes past the cache: the continuous-batching
    decode path. Without `cache`, standard causal (optionally packed)
    attention. `attn_impl` may be a callable with `multi_head_attention`'s
    signature (less `impl`) for the cache path.

    With `cache_append` (a cache with a shared cursor and a callable
    `attn_impl`), the layers never write the cache: each attends over the
    read-only cache through `attn_impl`, which also receives the chunk's
    own rows (`new_k`, `new_v`, `new_kv_positions`, `new_kv_seg`) to fold
    in, and after the last layer one `cache_append(k, v, valid, k_rows,
    v_rows, token_valid, fill)` call (k_rows / v_rows (L, B, S, Hkv*hd))
    writes every layer's rows and returns (k, v, valid): the
    sequence-sharded cache of `inference/long_context.py`, whose local
    shard starts at global slot `cache["offset"]`. The fused decode routes
    are off in this mode, as in JAX.

    With `sp` (an active `parallel.sp.SPConfig`) the cache-free attention
    runs sequence parallel (ring / Ulysses / hybrid) over this rank's
    shard; `positions` must be given (the shard's global positions, laid
    out as the batch).

    With `tp` (a `parallel.tensor_parallel.TPConfig`) the forward runs on
    a mesh: COAT's per-tensor fp8 scales are those of the whole activations
    and gradients (an all-reduce MAX over the ranks). With tp > 1 (the
    cache-free path only) the parameters are this rank's tp chunks
    (`parallel.mesh`'s specs): q, k, v, gate and up run column parallel, o
    and down row parallel, the embedding and the logits vocab parallel, so
    the logits are this rank's vocabulary columns (whole when tp does not
    divide the vocabulary); attention runs over the rank's heads when both
    head counts divide tp (and `sp.head_axis` names it), else over all of
    them, gathered."""
    from vila_tpu_torch.parallel import tensor_parallel as tpl

    dtype = cfg.compute_dtype
    fp8 = cfg.fp8_matmul
    fp8_group = tpl.amax_group(tp) if fp8 else None
    tp_on = tpl.active(tp)
    if tp_on and cache is not None:
        raise ValueError("tensor parallelism runs the cache-free forward only")
    tp = tp if tp_on else None
    sp_on = sp is not None and sp.active and cache is None
    if sp_on and positions is None:
        raise ValueError("a sequence-parallel forward needs the shard's positions")
    deferred = cache_append is not None
    if deferred and (cache is None or not callable(attn_impl) or "fill_host" in cache):
        raise ValueError("cache_append needs a cache with a shared cursor and a "
                         "callable attn_impl")
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, cfg, input_ids, tp=tp)
    h = inputs_embeds.to(dtype)
    b, s, _ = h.shape
    dev = h.device

    per_slot = cache is not None and "fill_host" in cache
    steps = torch.arange(s, dtype=torch.int32, device=dev)
    if per_slot:
        fill_host = np.asarray(cache["fill_host"], np.int64)
        start = cache["fill"][:, None] + steps  # (b, s) write rows, device
    else:
        fill = 0 if cache is None else int(cache["fill"])
        start = steps.expand(b, s) + fill
    if positions is None:
        positions = start
    cos, sin = rope_cos_sin(
        positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_linear_scaling
    )

    new_valid = q_slots = kv_slots = q_seg = kv_seg = writes = None
    if cache is not None:
        max_len = cache["k"].shape[2]
        if token_valid is None:
            token_valid = torch.ones((b, s), dtype=torch.bool, device=dev)
        new_valid = None if deferred else cache["valid"].clone()
        if per_slot:
            # (row, token, slot) of every write inside the cache, from the
            # host cursors; the rest drop (JAX: scatter mode="drop")
            rows = fill_host[:, None] + np.arange(s)
            w_b, w_t = np.nonzero(rows < max_len)
            writes = host_to_device(np.stack([w_b, w_t, rows[w_b, w_t]]), dev).long()
            new_valid[writes[0], writes[2]] = token_valid[writes[0], writes[1]]
            last = (fill_host + s - 1).tolist()  # each row's last written slot
        elif deferred:  # the hook appends; attention reads the old cache
            new_valid = cache["valid"]
        else:
            if fill + s > max_len:
                raise ValueError(f"cache of {max_len} slots cannot take {fill}+{s}")
            new_valid[:, fill:fill + s] = token_valid
            last = fill + s - 1
        q_slots = start
        kv_slots = (torch.arange(max_len, dtype=torch.int32, device=dev)
                    + cache.get("offset", 0)).expand(b, max_len)
        kv_seg = new_valid.to(torch.int32)
        q_seg = torch.ones((b, s), dtype=torch.int32, device=dev)

    def write_kv(l, kf, vf):
        """New (b, s, Hkv*hd) rows of layer l into the cache, in place."""
        ck, cv = cache["k"][l], cache["v"][l]  # (b, max_len, Hkv*hd) views
        if per_slot:
            ck.index_put_((writes[0], writes[2]), kf[writes[0], writes[1]].to(ck.dtype))
            cv.index_put_((writes[0], writes[2]), vf[writes[0], writes[1]].to(cv.dtype))
        else:
            ck[:, fill:fill + s] = kf.to(ck.dtype)
            cv[:, fill:fill + s] = vf.to(cv.dtype)

    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    nq, nkv = Hq * hd, Hkv * hd
    all_layers = params["layers"]
    q_stacked = {
        name: slot for name, slot in all_layers.items()
        if isinstance(slot, dict) and "packed" in slot and slot["packed"].ndim == 4
    }
    grp = Hq // max(Hkv, 1)
    grp_pad = ((grp + 7) // 8) * 8
    o_din = (2 * q_stacked["o_proj"]["packed"].shape[-2]
             if "o_proj" in q_stacked else None)
    padded_o = o_din == Hkv * grp_pad * hd and grp_pad != grp
    if tp_on and q_stacked:
        raise ValueError("tensor parallelism takes dense weights, not W4 slots")
    # the heads this rank's attention runs over
    tp_heads = tp_on and tp.heads_split(Hq, Hkv) and (not sp_on or sp.head_axis == "tp")
    hq_loc, hkv_loc = (Hq // tp.size, Hkv // tp.size) if tp_heads else (Hq, Hkv)

    # cache-free (training) path: one unbind per dense stacked tensor
    unbound = None if cache is not None else {
        name: {k: v.unbind(0) for k, v in slot.items()}
        for name, slot in all_layers.items() if name not in q_stacked
    }

    def layer_slot(name, l):
        """Layer l's tensors of a dense stacked slot."""
        if unbound is not None:
            return {k: v[l] for k, v in unbound[name].items()}
        return {k: v[l] for k, v in all_layers[name].items()}

    def lin(x, name, l):
        lp = all_layers[name]
        if name in q_stacked:
            lead = x.shape[:-1]
            y = w4_matmul_stacked_dispatch(
                x.reshape(-1, x.shape[-1]).to(torch.bfloat16),
                lp["packed"], lp["scales"], l,
            ).to(dtype)
            y = y.reshape(*lead, y.shape[-1])
            if "bias" in lp:
                y = y + lp["bias"][l].to(dtype)
            return y
        return _linear(x, layer_slot(name, l), dtype, fp8, (fp8_group, None, fp8_group))

    def pad_attn(attn):
        """(b, s, nq) -> (b, s, o_din): zero lanes for the GQA group pad."""
        if not padded_o:
            return attn
        a = attn.reshape(b, s, Hkv, grp, hd)
        a = torch.nn.functional.pad(a, (0, 0, 0, grp_pad - grp))
        return a.reshape(b, s, -1)

    new_rows = []  # deferred mode: each layer's (k, v) rows

    def attend(q, k, v, l):
        q = apply_rope(q.reshape(b, s, hq_loc, hd), cos, sin)
        k = apply_rope(k.reshape(b, s, hkv_loc, hd), cos, sin)
        v = v.reshape(b, s, hkv_loc, hd)
        if cache is not None:
            extra = {}
            if deferred:
                new_rows.append((k.reshape(b, s, -1), v.reshape(b, s, -1)))
                extra = dict(new_k=k.to(dtype), new_v=v.to(dtype), new_kv_positions=q_slots,
                             new_kv_seg=token_valid.to(torch.int32))
            else:
                write_kv(l, k.reshape(b, s, -1), v.reshape(b, s, -1))
            ck, cv = cache["k"][l], cache["v"][l]  # (b, max_len, Hkv*hd) views
            attend_fn = attn_impl if callable(attn_impl) else functools.partial(
                multi_head_attention, impl=attn_impl)
            attn = attend_fn(
                q, ck.reshape(b, -1, Hkv, hd).to(dtype),
                cv.reshape(b, -1, Hkv, hd).to(dtype),
                causal=True, q_positions=q_slots, kv_positions=kv_slots,
                q_segment_ids=q_seg, kv_segment_ids=kv_seg, **extra,
            )
        elif sp_on:
            from vila_tpu_torch.parallel.sp import sp_attention

            attn = sp_attention(q, k, v, sp, causal=True, segment_ids=segment_ids, layer=l)
        else:
            attn = multi_head_attention(
                q, k, v, causal=True, q_segment_ids=segment_ids,
                kv_segment_ids=segment_ids, impl=attn_impl,
            )
        return attn.reshape(b, s, hq_loc * hd)

    if tp_on and fp8 == "group":  # local 128-groups must be the whole tensor's
        for width in (nq, nkv, cfg.intermediate_size):
            if tp.splits(width) and (width // tp.size) % 128:
                raise ValueError(f"per-group fp8 under tp needs split widths in 128-groups: "
                                 f"{width} / {tp.size}")

    def col(x, xc, name, l, width):
        """A projection whose output columns tp splits when it divides
        `width` (column parallel: xc is x through `copy_to`), else `lin`."""
        if not (tp_on and tp.splits(width)):
            return lin(x, name, l)
        return _linear(xc, layer_slot(name, l), dtype, fp8, (fp8_group, tp.group, fp8_group))

    def row(x, name, l, width):
        """A projection whose input rows tp splits when it divides `width`
        (row parallel: summed over the ranks), else `lin`."""
        if not (tp_on and tp.splits(width)):
            return lin(x, name, l)
        y = _linear(x, layer_slot(name, l), dtype, fp8, (fp8_group, tp.group, fp8_group))
        return tpl.reduce_from(y, tp)

    def copy_for(x, *widths):
        """x through `copy_to` when tp splits one of `widths`."""
        return tpl.copy_to(x, tp) if tp_on and any(tp.splits(w) for w in widths) else x

    if tp_on and {"qkv_proj", "gate_up_proj"} & set(all_layers):
        raise ValueError("tensor parallelism takes the unfused q/k/v and gate/up projections")

    def layer_fn(h, l):
        """Layer l; under tp over this rank's chunks (Megatron's column /
        row split, `parallel/tensor_parallel.py`)."""
        scale = lambda n: layer_slot(n, l)["scale"]  # noqa: E731
        x = rms_norm(h, scale("input_layernorm"), cfg.rms_norm_eps)
        if "qkv_proj" in all_layers:
            qkv = lin(x, "qkv_proj", l)
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            xc = copy_for(x, nq, nkv)
            q, k, v = (col(x, xc, n, l, w)
                       for n, w in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)))
            if tp_on and not tp_heads:  # attention over every head
                q, k, v = (tpl.gather_from(y, tp) if tp.splits(w) else y
                           for y, w in ((q, nq), (k, nkv), (v, nkv)))
        attn = attend(q, k, v, l)
        if tp_on and not tp_heads and tp.splits(nq):
            attn = tpl.scatter_to(attn, tp)
        h = h + row(pad_attn(attn), "o_proj", l, nq)
        x = rms_norm(h, scale("post_attention_layernorm"), cfg.rms_norm_eps)
        inter = cfg.intermediate_size
        if "gate_up_proj" in all_layers:
            gu = lin(x, "gate_up_proj", l)
            gate, up = gu[..., :inter], gu[..., inter:]
        else:
            xc = copy_for(x, inter)
            gate, up = col(x, xc, "gate_proj", l, inter), col(x, xc, "up_proj", l, inter)
        return h + row(torch.nn.functional.silu(gate) * up, "down_proj", l, inter)

    use_fused = (
        cache is not None
        and not deferred
        and s == 1
        and b * s <= 32
        and {"qkv_proj", "o_proj", "gate_up_proj", "down_proj"} <= set(q_stacked)
        and all_layers["input_layernorm"]["scale"].ndim == 2
        and not os.environ.get("VILA_TPU_NO_FUSED_DECODE")
    )
    # the JAX package's route selection off a TPU (qwen2.py use_mega /
    # use_mega_b), so that both take the same route for the same b
    use_mega = (
        use_fused and b == 1 and padded_o
        and not os.environ.get("VILA_TPU_NO_MEGA_DECODE")
    )
    use_mega_b = (
        use_fused and 1 < b <= 16 and padded_o and grp_pad == 8
        and not os.environ.get("VILA_TPU_NO_MEGA_DECODE")
        and not os.environ.get("VILA_TPU_NO_MEGA_BATCHED")
    )

    if use_mega:
        h = _mega_decode(params, cfg, h, cos, sin, cache, new_valid,
                         last[0] if per_slot else last, write_kv, lin)
    elif use_mega_b:
        h = _mega_b_decode(params, cfg, h, cos, sin, cache, new_valid, last,
                           write_kv, lin)
    elif use_fused:
        h = _fused_decode(params, cfg, h, attend, pad_attn, lin)
    else:
        body = _checkpointed(layer_fn, cfg.remat) if cache is None and cfg.remat else layer_fn
        for l in range(cfg.num_hidden_layers):
            h = body(h, l)

    new_cache = None
    if cache is not None:
        new_k, new_v = cache["k"], cache["v"]
        if deferred:
            new_k, new_v, new_valid = cache_append(
                new_k, new_v, cache["valid"], torch.stack([r[0] for r in new_rows]),
                torch.stack([r[1] for r in new_rows]), token_valid, fill)
        new_cache = dict(cache, k=new_k, v=new_v, valid=new_valid, fill=cache["fill"] + s)
        if per_slot:
            new_cache["fill_host"] = fill_host + s

    h = rms_norm(h, params["norm"]["scale"], cfg.rms_norm_eps)
    if gather_position is not None:
        h = h[torch.arange(b, device=dev), gather_position.to(dev).long()][:, None]
    elif last_token_only:
        h = h[:, -1:]
    if return_hidden:
        return h, new_cache
    return compute_logits(params, cfg, h, tp=tp), new_cache


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat="dots": keep the outputs of
    matmuls without batch dimensions (the projections), recompute the
    rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _checkpointed(fn, remat):
    """fn(h, l) under `torch.utils.checkpoint`: full recompute for
    remat=True, the matmul outputs kept for "dots"."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_dots)
    return lambda h, l: checkpoint(fn, h, l, use_reentrant=False, **kw)


def _mega_decode(params, cfg, h, cos, sin, cache, new_valid, fill, write_kv, lin):
    """bs=1 decode step through `fused_decode.fused_layer` (K3): the loop
    carries (h, qkv of the current layer) as 8 broadcast rows; layer l emits
    layer l+1's qkv. RoPE and the cache write stay here, before each call;
    `fill` is the slot written this step (host int)."""
    from vila_tpu_torch.ops import fused_decode

    dtype = cfg.compute_dtype
    layers = params["layers"]
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    nq, nkv = Hq * hd, Hkv * hd
    grp = Hq // Hkv
    grp_pad = ((grp + 7) // 8) * 8
    d_model = h.shape[-1]

    x0 = rms_norm(h, layers["input_layernorm"]["scale"][0], cfg.rms_norm_eps)
    qkv0 = lin(x0, "qkv_proj", 0)  # layer 0's qkv (+ bias), one GEMV
    mask = torch.where(new_valid[0], 0.0, -1e30)[None].float()
    h8 = h.reshape(1, d_model).expand(8, d_model)
    qkv8 = qkv0.reshape(1, -1).to(torch.bfloat16).expand(8, qkv0.shape[-1])
    # group-padded q; the pad rows stay zero, each layer fills the real ones
    q32 = torch.zeros((Hkv, grp_pad, hd), dtype=torch.bfloat16, device=h.device)
    for l in range(cfg.num_hidden_layers):
        qk = qkv8[0, :nq + nkv].to(dtype).reshape(1, 1, Hq + Hkv, hd)
        qk = apply_rope(qk, cos, sin)[0, 0]  # q and k heads in one call
        write_kv(l, qk[Hq:].reshape(1, 1, nkv), qkv8[0:1, None, nq + nkv:])
        q32[:, :grp] = (qk[:Hq].float() * hd ** -0.5).reshape(Hkv, grp, hd)
        h8, qkv8 = fused_decode.fused_layer(
            q32.reshape(Hkv * grp_pad, hd), mask, h8, l, cache["k"], cache["v"],
            layers["o_proj"], layers["gate_up_proj"], layers["down_proj"],
            layers["qkv_proj"],
            layers["post_attention_layernorm"]["scale"],
            layers["input_layernorm"]["scale"],
            hkv=Hkv, hd=hd, eps=cfg.rms_norm_eps, fill=fill, num_q_heads=Hq,
        )
    return h8[0:1].reshape(1, 1, d_model).to(dtype)


def _mega_b_decode(params, cfg, h, cos, sin, cache, new_valid, fill, write_kv,
                   lin):
    """1 < b <= 16 decode step through `fused_decode.fused_layer_batched`
    (K6), as the JAX `mega_b_layer_fn`: the loop carries (h, qkv of the
    current layer) with rows = batch rows. RoPE on q and k and each row's
    cache write stay here; `fill` is each row's last written slot (host
    ints, or one int for a shared cursor)."""
    from vila_tpu_torch.ops import fused_decode

    dtype = cfg.compute_dtype
    layers = params["layers"]
    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    nq, nkv = Hq * hd, Hkv * hd
    grp = Hq // Hkv
    b, _, d_model = h.shape

    x0 = rms_norm(h, layers["input_layernorm"]["scale"][0], cfg.rms_norm_eps)
    qkv = lin(x0, "qkv_proj", 0).reshape(b, -1).to(torch.bfloat16)
    mask = torch.where(new_valid, 0.0, -1e30).float()  # (b, S)
    hb = h.reshape(b, d_model)
    # group-padded q (the group pads to 8); pad rows stay zero
    q32 = torch.zeros((b, Hkv, 8, hd), dtype=torch.bfloat16, device=h.device)
    for l in range(cfg.num_hidden_layers):
        qk = qkv[:, :nq + nkv].to(dtype).reshape(b, 1, Hq + Hkv, hd)
        qk = apply_rope(qk, cos, sin)[:, 0]  # q and k heads in one call
        write_kv(l, qk[:, Hq:].reshape(b, 1, nkv), qkv[:, None, nq + nkv:])
        q32[:, :, :grp] = (qk[:, :Hq].float() * hd ** -0.5).reshape(b, Hkv, grp, hd)
        hb, qkv = fused_decode.fused_layer_batched(
            q32.reshape(b, Hkv * 8, hd), mask, hb, l, cache["k"], cache["v"],
            layers["o_proj"], layers["gate_up_proj"], layers["down_proj"],
            layers["qkv_proj"],
            layers["post_attention_layernorm"]["scale"],
            layers["input_layernorm"]["scale"],
            hkv=Hkv, hd=hd, eps=cfg.rms_norm_eps, fill=fill, num_q_heads=Hq,
        )
    return hb.reshape(b, 1, d_model).to(dtype)


def _fused_decode(params, cfg, h, attend, pad_attn, lin):
    """Decode step through the two-kernel layer, as the JAX
    `fused_layer_fn`: attention (RoPE, cache write and plain attention in
    `attend`), then `fused_o_gateup` (K4) and `fused_down_qkv` (K5), which
    emits the next layer's qkv."""
    from vila_tpu_torch.ops import fused_decode

    dtype = cfg.compute_dtype
    layers = params["layers"]
    nq = cfg.num_attention_heads * cfg.head_dim_
    nkv = cfg.num_key_value_heads * cfg.head_dim_
    b, s, d_model = h.shape

    x0 = rms_norm(h, layers["input_layernorm"]["scale"][0], cfg.rms_norm_eps)
    qkv_flat = lin(x0, "qkv_proj", 0).reshape(b * s, -1).to(torch.bfloat16)
    for l in range(cfg.num_hidden_layers):
        qkv = qkv_flat.reshape(b, s, -1).to(dtype)
        attn = attend(qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:], l)
        h2, gu = fused_decode.fused_o_gateup(
            pad_attn(attn).reshape(b * s, -1).to(torch.bfloat16),
            h.reshape(b * s, d_model), l, layers["o_proj"], layers["gate_up_proj"],
            layers["post_attention_layernorm"]["scale"], eps=cfg.rms_norm_eps,
        )
        h2, qkv_flat = fused_decode.fused_down_qkv(
            gu, h2, l, layers["down_proj"], layers["qkv_proj"],
            layers["input_layernorm"]["scale"], eps=cfg.rms_norm_eps,
        )
        h = h2.reshape(b, s, d_model).to(dtype)
    return h


def embed_tokens(params: Params, cfg: LLMConfig, input_ids: torch.Tensor, tp=None):
    """The token embeddings; under a tp plan that splits the vocabulary,
    from this rank's rows of the table (vocab parallel)."""
    from vila_tpu_torch.parallel import tensor_parallel as tpl

    emb = params["embed_tokens"]["embedding"]
    ids = input_ids.to(emb.device)
    vp = tpl.vocab_plan(tp, cfg.vocab_size)
    if vp is not None:
        return tpl.vocab_embedding(ids, emb, vp).to(cfg.compute_dtype)
    return emb[ids.long()].to(cfg.compute_dtype)


def head_weight(params: Params, cfg: LLMConfig) -> torch.Tensor:
    """The dense output projection (D, V) in the compute dtype: the tied
    embedding's transpose or the untied lm_head kernel."""
    if cfg.tie_word_embeddings:
        w = params["embed_tokens"]["embedding"].T
    else:
        w = params["lm_head"]["kernel"]
    return w.to(cfg.compute_dtype)


def compute_logits(params: Params, cfg: LLMConfig, hidden: torch.Tensor, tp=None):
    """Vocabulary logits in float32 (products in the compute dtype,
    accumulated in float32); the untied lm_head may be a W4 slot. On the
    card a bf16 head is one tensor-core product with f32 output
    (`ops.cross_entropy.head_logits`), elsewhere the f32 product of the
    compute-dtype values. Under a tp plan that splits the vocabulary, this
    rank's columns of them (vocab parallel; `hidden` replicated)."""
    from vila_tpu_torch.parallel import tensor_parallel as tpl

    vp = tpl.vocab_plan(tp, cfg.vocab_size)
    if vp is not None:
        hidden = tpl.copy_to(hidden, vp)
    if not cfg.tie_word_embeddings and "packed" in params["lm_head"]:
        from vila_tpu_torch.ops.quant import quantized_linear

        return quantized_linear(hidden, params["lm_head"], cfg.compute_dtype).float()
    from vila_tpu_torch.ops.cross_entropy import head_logits, tensor_core_head

    w = head_weight(params, cfg)
    if tensor_core_head(hidden.device, w.dtype, vp):
        return head_logits(hidden.to(w.dtype), w)
    return hidden.to(w.dtype).float() @ w.float()
