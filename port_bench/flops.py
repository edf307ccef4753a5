"""Operations and bytes the work needs, from shapes alone: the yardstick
of the roofline and model-FLOPs metrics. Counts are of what the inputs
need (a matmul's 2 M K N, each weight byte read once, attention over the
(q, k) pairs the masks allow), not of what a kernel happens to do, so a
kernel that skips waste moves its share up and none can pass 100 %.

Sizes come from the configuration file (`configs/*.json`), not from the
program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

from port_bench.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

BF16 = 2


def w4_bytes(din: int, dout: int, group: int = 128) -> int:
    """A W4 weight's packed nibbles and its bf16 scale per (group, column)."""
    return din * dout // 2 + (din // group) * dout * BF16


def least_s(flops: float, nbytes: float) -> float:
    """The least time on the card: the larger of the operations at the
    bf16 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def llm_dims(llm: Dict) -> Dict[str, int]:
    D, hq, hkv = llm["hidden_size"], llm["num_attention_heads"], llm["num_key_value_heads"]
    hd = D // hq
    return dict(D=D, I=llm["intermediate_size"], L=llm["num_hidden_layers"], hq=hq,
                hkv=hkv, hd=hd, V=llm["vocab_size"], qkv=(hq + 2 * hkv) * hd)


def llm_linears(llm: Dict):
    """(din, dout) of one decoder layer's projections: fused qkv, o,
    fused gate_up, down (the work is the same fused or not)."""
    d = llm_dims(llm)
    return ((d["D"], d["qkv"]), (d["hq"] * d["hd"], d["D"]), (d["D"], 2 * d["I"]),
            (d["I"], d["D"]))


def llm_layer_params(llm: Dict) -> int:
    return sum(a * b for a, b in llm_linears(llm))


def kv_row_bytes(llm: Dict) -> int:
    """One cache row of every layer: K and V, bf16."""
    d = llm_dims(llm)
    return d["L"] * 2 * d["hkv"] * d["hd"] * BF16


def decode_step_least_s(llm: Dict, rows: Sequence[int], group: int = 128) -> Dict[str, float]:
    """The least time of one batched decode step over the active slots,
    `rows` the cache rows each reads (its prompt and tokens so far, the
    new one included): {"layers": the decoder layers (K6 or K4/K5),
    "lm_head": the output projection (K1)}. Idle slots need nothing."""
    d = llm_dims(llm)
    b = len(rows)
    w = d["L"] * (sum(w4_bytes(i, o, group) for i, o in llm_linears(llm))
                  + d["qkv"] * BF16 + 2 * d["D"] * BF16)
    kv = sum(rows) * kv_row_bytes(llm)
    flops = 2 * b * d["L"] * llm_layer_params(llm) + 4 * d["L"] * d["hq"] * d["hd"] * sum(rows)
    head_bytes = (w4_bytes(d["D"], d["V"], group) + b * d["V"] * BF16)
    return {"layers": least_s(flops, w + kv),
            "lm_head": least_s(2 * b * d["D"] * d["V"], head_bytes)}


def prefill_w4_least_s(llm: Dict, m: int, group: int = 128) -> float:
    """The least time of a prefill's W4 products (K2: four a layer) at
    `m` real rows: weights read once, activations in and out in bf16."""
    d = llm_dims(llm)
    return d["L"] * sum(least_s(2 * m * i * o, w4_bytes(i, o, group) + m * (i + o) * BF16)
                        for i, o in llm_linears(llm))


def llm_forward_flops(llm: Dict, tokens: int, context_pairs: int, logits: int) -> float:
    """Forward operations over `tokens` tokens whose attention covers
    `context_pairs` (q, k) pairs, with `logits` rows through the output
    projection."""
    d = llm_dims(llm)
    return (2 * tokens * d["L"] * llm_layer_params(llm)
            + 4 * d["L"] * d["hq"] * d["hd"] * context_pairs
            + 2 * logits * d["D"] * d["V"])


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def segment_pairs(segment_ids: Iterable[int]) -> int:
    """(q, k) pairs a causal, segment-masked row allows: each segment
    (id > 0; 0 is padding) attends within itself."""
    counts: Dict[int, int] = {}
    for s in segment_ids:
        s = int(s)
        if s > 0:
            counts[s] = counts.get(s, 0) + 1
    return sum(causal_pairs(n) for n in counts.values())


def tower_forward_flops(vis: Dict, images: int, layers_run: int) -> float:
    """SigLIP over `images` tiles: the patch matmul, `layers_run` encoder
    layers (attention over all patch pairs)."""
    D, I, p = vis["hidden_size"], vis["intermediate_size"], vis["patch_size"]
    n = (vis["image_size"] // p) ** 2
    per = (2 * n * p * p * 3 * D
           + layers_run * (2 * n * (4 * D * D + 2 * D * I) + 4 * n * n * D))
    return images * per


def projector_forward_flops(vis: Dict, llm_hidden: int, images: int) -> float:
    """`mlp_downsample`: 2x2 unshuffle, then (4C -> H) and (H -> H)."""
    n = (vis["image_size"] // vis["patch_size"]) ** 2
    c = vis["hidden_size"]
    tokens = ((int(round(n ** 0.5)) + 1) // 2) ** 2
    return images * 2 * tokens * (4 * c * llm_hidden + llm_hidden * llm_hidden)


def tower_layers_run(vis: Dict) -> int:
    """Encoder layers run up to `feature_layer` (-2: all but the last)."""
    fl = vis["feature_layer"]
    return fl + vis["num_hidden_layers"] + 1 if fl < 0 else fl


def media_flops(config: Dict, images: int) -> float:
    vis = config["vision"]
    return (tower_forward_flops(vis, images, tower_layers_run(vis))
            + projector_forward_flops(vis, config["llm"]["hidden_size"], images))


def flash_least_s(llm: Dict, pairs: int, tokens: int) -> float:
    """The least time of one layer's attention forward and backward over a
    row (K7, K8 + K9): 4 operations per (q, k) pair and head dim forward,
    10 backward (the scores once recomputed), q, k, v, out, its gradient
    and dq, dk, dv each moved once."""
    d = llm_dims(llm)
    hdim = d["hq"] * d["hd"]
    kv = 2 * d["hkv"] * d["hd"]
    fwd = least_s(4 * hdim * pairs, tokens * (2 * hdim + kv) * BF16)
    bwd = least_s(10 * hdim * pairs, tokens * (4 * hdim + 2 * kv) * BF16)
    return fwd + bwd


def train_step_flops(config: Dict, tokens: int, pairs: int, images: int) -> float:
    """Forward and backward (3 x forward) of one step: the LLM over the
    row's `tokens` non-padding tokens with `pairs` attention pairs and the
    output projection on each, the tower and projector over `images`."""
    return 3 * (llm_forward_flops(config["llm"], tokens, pairs, tokens)
                + media_flops(config, images))
