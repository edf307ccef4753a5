"""AWQ: activation-aware weight quantization for the W4A16 deployment
path, as `vila_tpu/ops/awq.py`.

Plain round-to-nearest int4 loses accuracy because ~1% of input channels
carry activation outliers; AWQ searches a per-input-channel scale s (from
calibration activations) that multiplies weight rows up (protecting
salient channels) and divides the activation side down, folded into the
preceding op so that the inference kernels are unchanged. The algorithm is
the AWQ paper's (arXiv:2306.00978), as the JAX package derives it for
stacked (L, din, dout) parameters.

Scale-fold pairs (llm-awq's `auto_scale` set for LLaMA-family models):
  * input_layernorm      -> q/k/v rows       (s divides the ln scale)
  * v_proj columns       -> o_proj rows      (GQA: s is group-constant, the
                                              geometric mean over each KV
                                              group)
  * post_attention_ln    -> gate/up rows
  * up_proj columns      -> down_proj rows   (silu(g)*u / s == silu(g)*(u/s))

Calibration: `collect_act_stats` walks the decoder with the port's own ops
(`rms_norm`, `apply_rope`, `multi_head_attention`) and keeps, for each
linear family, a row subsample of its inputs for the search, drawn with an
explicit `torch.Generator` (the JAX package draws with `jax.random.choice`,
which no torch generator reproduces: with `sample_rows` >= B*S both keep
every row, in another order, and the search does not depend on row order
beyond summation order).

Every step works one layer at a time: the JAX package casts whole stacks
to f32, which at NVILA-8B width would hold 15.2 GB for gate/up and 7.6 GB
for down beside the bf16 tree. The numbers are the same: each layer's
search, fold and casts are the JAX expressions for that layer. The search's
products run in full f32 (TF32 off while it runs): its losses are sums of
squares, and TF32 would move the argmin. Divisions by a Python scalar go
through `quant._div` (IEEE on the card too).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import torch

from vila_tpu_torch.ops.quant import DEFAULT_GROUP, _div

Params = Dict[str, Any]


@contextlib.contextmanager
def _full_f32():
    """f32 matmuls in full precision (no TF32) while the block runs."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


# --------------------------------------------------------------------------
# Core scale search
# --------------------------------------------------------------------------


def _rtn_dequant(w: torch.Tensor, group_size: int) -> torch.Tensor:
    """Round-to-nearest int4 quantize + dequantize along the input dim, as
    `quantize_w4`'s numbers (symmetric [-8, 7], per (group, output) scale
    amax / 7) without the tiled packing."""
    din, dout = w.shape[-2:]
    g = w.reshape(*w.shape[:-2], din // group_size, group_size, dout)
    amax = g.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(_div(amax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(g / scale), -8, 7)
    return (q * scale).reshape(w.shape)


def _alpha_grid(n_grid: int, device) -> torch.Tensor:
    """`jnp.linspace(0, 1, n_grid)` in f32, value for value: i * f32(1 / (n - 1))."""
    if n_grid == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = _div(torch.ones((), dtype=torch.float32, device=device), float(n_grid - 1))
    return torch.arange(n_grid, dtype=torch.float32, device=device) * step


def search_awq_scales(
    w: torch.Tensor,  # (din, dout) f32/bf16
    x_sample: torch.Tensor,  # (m, din) calibration input rows
    act_amax: Optional[torch.Tensor] = None,  # (din,) mean |x| per channel
    n_grid: int = 20,
    group_size: int = DEFAULT_GROUP,
    return_losses: bool = False,
):
    """AWQ grid search: s = normalize(act_amax ** alpha), alpha on a grid of
    `n_grid` points in [0, 1], the loss the true reconstruction error on
    the calibration rows, || x @ w - (x / s) @ rtn(w * s) ||^2. The grid
    runs in order, one candidate at a time (one dequantized copy of the
    weight alive); the first minimum wins. Returns (s (din,), best loss
    ()), and with `return_losses` also (index of the best, every loss).
    alpha = 0 (s = 1) is on the grid, so AWQ is never worse than RTN on the
    calibration rows."""
    with _full_f32():
        w32 = w.float()
        x32 = x_sample.float()
        if act_amax is None:
            act_amax = x32.abs().mean(dim=0)
        a = torch.clamp(act_amax.float(), min=1e-8)
        ref = x32 @ w32
        losses, scales = [], []
        for alpha in _alpha_grid(n_grid, w32.device):
            s = a ** alpha
            # geometric mean 1: only the relative per-channel factor matters
            s = s / torch.exp(torch.log(s).mean())
            wq = _rtn_dequant(w32 * s[:, None], group_size)
            out = (x32 / s[None, :]) @ wq
            losses.append(((out - ref) ** 2).sum())
            scales.append(s)
            del wq, out
        losses = torch.stack(losses)
        best = int(torch.argmin(losses))  # the first minimum, as jnp.argmin
    if return_losses:
        return scales[best], losses[best], best, losses
    return scales[best], losses[best]


def fit_group(din: int, group_size: int = DEFAULT_GROUP) -> int:
    """Largest group <= group_size under `quantize_llm_params`' rule (the
    group divides half the contraction: the packed-nibble layout)."""
    half = din // 2
    g = min(group_size, max(half, 1))
    while half % g != 0:
        g -= 1
    return g


def search_awq_scales_stacked(
    w: torch.Tensor,  # (L, din, dout)
    x_sample: torch.Tensor,  # (L, m, din)
    n_grid: int = 20,
    group_size: int = DEFAULT_GROUP,
) -> torch.Tensor:
    """Per-layer AWQ search over stacked weights -> (L, din) scales, one
    layer at a time (one layer's f32 reconstruction alive)."""
    g = fit_group(w.shape[-2], group_size)
    return torch.stack([search_awq_scales(w[l], x_sample[l], n_grid=n_grid, group_size=g)[0]
                        for l in range(w.shape[0])])


# --------------------------------------------------------------------------
# Calibration walk (bf16 params, before quantization)
# --------------------------------------------------------------------------


def sample_row_indices(n_rows: int, sample_rows: int,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The calibration rows kept: min(sample_rows, n_rows) distinct rows of
    n_rows, in the order of a permutation drawn from `generator` (seed 0
    when none is given; on the CPU)."""
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    return torch.randperm(n_rows, generator=gen, device=gen.device)[:min(sample_rows, n_rows)]


def collect_act_stats(
    params: Params,
    cfg,  # qwen2.LLMConfig
    input_ids: torch.Tensor,  # (B, S) calibration token ids
    sample_rows: int = 128,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, torch.Tensor]:
    """Run the decoder (unquantized params) over calibration ids, keeping
    each linear family's input rows: {'qkv': (L, m, D), 'o': (L, m,
    Hq*hd), 'gate_up': (L, m, D), 'down': (L, m, I)} f32 and 'hidden' (B,
    S, D), the final rms-normed hidden state (tests pin it against
    `qwen2.forward(return_hidden=True)`, so the walk cannot drift from the
    model). The same m rows of every layer (`sample_row_indices`)."""
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.ops.attention import multi_head_attention
    from vila_tpu_torch.ops.norms import rms_norm
    from vila_tpu_torch.ops.rope import apply_rope, rope_cos_sin

    dtype = cfg.compute_dtype
    lp_all = params["layers"]
    dev = lp_all["input_layernorm"]["scale"].device
    input_ids = input_ids.to(dev)
    b, s = input_ids.shape
    h = qwen2.embed_tokens(params, cfg, input_ids)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)
    cos, sin = rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta, cfg.rope_linear_scaling)
    row_idx = sample_row_indices(b * s, sample_rows, generator).to(dev)

    def take(x3):  # (B, S, C) -> (m, C) f32 subsample
        return x3.reshape(b * s, -1).float()[row_idx]

    Hq, Hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim_
    nq, nkv = Hq * hd, Hkv * hd
    caps = {"qkv": [], "o": [], "gate_up": [], "down": []}
    for l in range(cfg.num_hidden_layers):
        def lin(x, name):
            y = x @ lp_all[name]["kernel"][l].to(dtype)
            if "bias" in lp_all[name]:
                y = y + lp_all[name]["bias"][l].to(dtype)
            return y

        x = rms_norm(h, lp_all["input_layernorm"]["scale"][l], cfg.rms_norm_eps)
        caps["qkv"].append(take(x))
        if "qkv_proj" in lp_all:
            qkv = lin(x, "qkv_proj")
            q, k, v = qkv[..., :nq], qkv[..., nq:nq + nkv], qkv[..., nq + nkv:]
        else:
            q, k, v = lin(x, "q_proj"), lin(x, "k_proj"), lin(x, "v_proj")
        q = apply_rope(q.reshape(b, s, Hq, hd), cos, sin)
        k = apply_rope(k.reshape(b, s, Hkv, hd), cos, sin)
        v = v.reshape(b, s, Hkv, hd)
        attn = multi_head_attention(q, k, v, causal=True).reshape(b, s, nq)
        caps["o"].append(take(attn))
        h = h + lin(attn, "o_proj")
        x = rms_norm(h, lp_all["post_attention_layernorm"]["scale"][l], cfg.rms_norm_eps)
        caps["gate_up"].append(take(x))
        if "gate_up_proj" in lp_all:
            gu = lin(x, "gate_up_proj")
            gate, up = gu[..., :cfg.intermediate_size], gu[..., cfg.intermediate_size:]
        else:
            gate, up = lin(x, "gate_proj"), lin(x, "up_proj")
        mid = torch.nn.functional.silu(gate) * up
        caps["down"].append(take(mid))
        h = h + lin(mid, "down_proj")
    out = {k: torch.stack(v) for k, v in caps.items()}
    out["hidden"] = rms_norm(h, params["norm"]["scale"], cfg.rms_norm_eps)
    return out


# --------------------------------------------------------------------------
# Scale folding (stacked (L, ...) param trees, before quantization)
# --------------------------------------------------------------------------


def layer_scales(src: Params, cfg, act_stats: Dict[str, torch.Tensor], l: int,
                 n_grid: int = 20, group_size: int = DEFAULT_GROUP):
    """Layer l's four searches, on the unfolded weights (as the JAX package
    searches every pair on the original stacks): {pair: (s, best loss,
    index of the best, every loss)} for 'qkv' (D,), 'o' (Hq*hd,), 'gate_up'
    (D,) and 'down' (I,)."""
    def kern(name):
        return src[name]["kernel"][l].float()

    def search(w, rows):
        return search_awq_scales(w, rows, n_grid=n_grid,
                                 group_size=fit_group(w.shape[-2], group_size),
                                 return_losses=True)

    return {
        "qkv": search(torch.cat([kern("q_proj"), kern("k_proj"), kern("v_proj")], dim=-1),
                      act_stats["qkv"][l]),
        "o": search(kern("o_proj"), act_stats["o"][l]),
        "gate_up": search(torch.cat([kern("gate_proj"), kern("up_proj")], dim=-1),
                          act_stats["gate_up"][l]),
        "down": search(kern("down_proj"), act_stats["down"][l]),
    }


def apply_awq(
    llm_params: Params,
    cfg,
    act_stats: Dict[str, torch.Tensor],
    n_grid: int = 20,
    group_size: int = DEFAULT_GROUP,
    searches: Optional[list] = None,
) -> Params:
    """Fold AWQ scales into a qwen2 param tree with per-layer kernels
    q/k/v/o/gate/up/down stacked on L. Returns a new tree (the input is not
    changed) whose unquantized forward is the same up to rounding (the
    scales cancel in pairs) but whose `quantize_llm_params` output is
    activation-aware. Layer by layer: the stacks of the new tree are
    allocated once and each layer's f32 work is freed before the next.
    `searches`, when a list, receives each layer's `layer_scales`.

    Call order: collect_act_stats -> apply_awq -> quantize_llm_params."""
    src = llm_params["layers"]
    out_layers = {k: dict(v) for k, v in src.items()}
    changed = ["q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"]
    for name in changed:
        out_layers[name]["kernel"] = torch.empty_like(src[name]["kernel"])
    for name in ("v_proj", "up_proj"):
        if "bias" in src[name]:
            out_layers[name]["bias"] = torch.empty_like(src[name]["bias"])
    for name in ("input_layernorm", "post_attention_layernorm"):
        out_layers[name]["scale"] = torch.empty_like(src[name]["scale"])
    grp = cfg.num_attention_heads // max(cfg.num_key_value_heads, 1)
    Hkv, hd = cfg.num_key_value_heads, cfg.head_dim_
    L = src["o_proj"]["kernel"].shape[0]

    for l in range(L):
        def kern(name):
            return src[name]["kernel"][l].float()

        def put(name, key, value):
            dst = out_layers[name][key]
            dst[l] = value.to(dst.dtype)

        sc = layer_scales(src, cfg, act_stats, l, n_grid, group_size)
        if searches is not None:
            searches.append(sc)
        # pair 1: input_layernorm -> q/k/v rows
        s_qkv = sc["qkv"][0]
        for name in ("q_proj", "k_proj", "v_proj"):
            put(name, "kernel", kern(name) * s_qkv[:, None])
        put("input_layernorm", "scale", src["input_layernorm"]["scale"][l].float() / s_qkv)
        # pair 2: v columns -> o rows, one factor per (kv head, dim): the
        # geometric mean of the searched scales over the head's group
        s_g = torch.exp(torch.log(torch.clamp(sc["o"][0].reshape(Hkv, grp, hd), min=1e-8))
                        .mean(dim=1))  # (Hkv, hd)
        s_o = s_g.repeat_interleave(grp, dim=0).reshape(Hkv * grp * hd)
        put("o_proj", "kernel", kern("o_proj") * s_o[:, None])
        vk = out_layers["v_proj"]["kernel"][l].float()  # pair 1's fold, in the stored dtype
        put("v_proj", "kernel", vk / s_g.reshape(1, Hkv * hd))
        if "bias" in src["v_proj"]:
            put("v_proj", "bias", src["v_proj"]["bias"][l].float() / s_g.reshape(Hkv * hd))
        # pair 3: post_attention_layernorm -> gate/up rows
        s_gu = sc["gate_up"][0]
        for name in ("gate_proj", "up_proj"):
            put(name, "kernel", kern(name) * s_gu[:, None])
        put("post_attention_layernorm", "scale",
            src["post_attention_layernorm"]["scale"][l].float() / s_gu)
        # pair 4: up columns -> down rows
        s_dn = sc["down"][0]
        put("down_proj", "kernel", kern("down_proj") * s_dn[:, None])
        upk = out_layers["up_proj"]["kernel"][l].float()  # pair 3's fold, stored dtype
        put("up_proj", "kernel", upk / s_dn[None, :])
        if "bias" in src["up_proj"]:
            put("up_proj", "bias", src["up_proj"]["bias"][l].float() / s_dn)
        del sc
    out = dict(llm_params)
    out["layers"] = out_layers
    return out


def awq_quantize_llm(
    llm_params: Params,
    cfg,
    calib_ids: torch.Tensor,  # (B, S) calibration token ids
    n_grid: int = 20,
    group_size: int = DEFAULT_GROUP,
    fuse: bool = True,
    sample_rows: int = 128,
    generator: Optional[torch.Generator] = None,
) -> Params:
    """Calibrate, fold the scales, quantize to W4 (`quantize_llm_params`
    with the GQA-padded o layout): a drop-in for `quantize_llm_params` when
    calibration ids are at hand. The folded tree is freed once quantized."""
    from vila_tpu_torch.ops.quant import quantize_llm_params

    stats = collect_act_stats(llm_params, cfg, calib_ids, sample_rows=sample_rows,
                              generator=generator)
    folded = apply_awq(llm_params, cfg, stats, n_grid=n_grid, group_size=group_size)
    del stats
    return quantize_llm_params(folded, bits=4, group_size=group_size, fuse=fuse, cfg=cfg)


def search_summary(searches) -> Tuple[list, list]:
    """(chosen grid index, best loss) of every (layer, pair) of `apply_awq`'s
    `searches`, layer-major, pairs in the order qkv, o, gate_up, down."""
    idx = [[sc[p][2] for p in ("qkv", "o", "gate_up", "down")] for sc in searches]
    loss = [[float(sc[p][1]) for p in ("qkv", "o", "gate_up", "down")] for sc in searches]
    return idx, loss
