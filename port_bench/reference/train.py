"""The plain float32 reference of NVILA supervised fine-tuning: the first
steps of the `sft` stage on packed rows, from weights drawn again from the
seed.

Per step: the rows packed from the same samples (`pack`: the samples in
order, positions restarting at each, the first label of each masked, media
positions shifted by the sample's offset), the SigLIP tower up to its
feature layer over the row's tiles, the `mlp_downsample` projector, the
splice, the Qwen2 LLM with causal attention inside each packed sample, the
tied output projection and the mean cross entropy of the labelled next
tokens; the gradients of every leaf by autograd, each component clipped by
its own global norm, then AdamW with bias-corrected moments and the
warm-up schedule (the update count before it is incremented sets the
rate, so the first update has rate 0). Everything is float32 with TF32
off.

`act="fp8"` is the control: every linear's input and weight rounded to
float8 e4m3 (a scale a row and a column; the rounding passed straight
through in the backward). `fault="half"` leaves the second half of the
labelled tokens out of the loss, the mean taken over the rest.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from port_bench import weights
from port_bench.reference.vlm import E4M3_MAX, layer_norm, no_tf32, rms_norm

IGNORE = -100
COMPONENTS = ("llm", "vision_tower", "mm_projector")


def pack(samples: List[Dict[str, Any]], seq_len: int, pad_id: int) -> Dict[str, np.ndarray]:
    """One row of `seq_len` tokens from samples that fit in it."""
    ids = np.full(seq_len, pad_id, np.int64)
    labels = np.full(seq_len, IGNORE, np.int64)
    pos = np.zeros(seq_len, np.int64)
    seg = np.zeros(seq_len, np.int64)
    tiles, media = [], []
    off = 0
    for k, s in enumerate(samples, start=1):
        n = len(s["input_ids"])
        if off + n > seq_len:
            raise ValueError("the samples do not fit in the row")
        ids[off:off + n] = s["input_ids"]
        labels[off:off + n] = s["labels"]
        labels[off] = IGNORE
        pos[off:off + n] = np.arange(n)
        seg[off:off + n] = k
        if len(s["tiles"]):
            tiles.append(s["tiles"])
            media.append(np.asarray(s["media_positions"]) + off)
        off += n
    return {"input_ids": ids, "labels": labels, "positions": pos, "segment_ids": seg,
            "tiles": np.concatenate(tiles) if tiles else None,
            "media_positions": np.concatenate(media) if media else None}


def _fp8(torch, x, dim):
    """x rounded to e4m3 with one scale along `dim`'s slices, passed
    straight through in the backward."""
    s = torch.clamp(x.detach().abs().amax(dim=dim, keepdim=True), min=1e-12) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def linear(torch, x, w, b=None, act="f32"):
    if act == "fp8":
        x, w = _fp8(torch, x, -1), _fp8(torch, w, 0)
    y = x @ w
    return y if b is None else y + b


def rope(torch, x, positions, theta):
    """Rotate-half RoPE; x (S, H, hd), positions (S,)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd))
    f = positions.float()[:, None] * inv
    emb = torch.cat([f, f], dim=-1)
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
    return x * torch.cos(emb)[:, None] + rot * torch.sin(emb)[:, None]


def tower(torch, config, vt, pj, tiles, act):
    vis = config["vision"]
    p, D, nh = vis["patch_size"], vis["hidden_size"], vis["num_attention_heads"]
    hd, eps = D // nh, vis["layer_norm_eps"]
    x = (tiles.float() / 255.0 - 0.5) / 0.5
    n, hgt, wid, c = x.shape
    x = x.reshape(n, hgt // p, p, wid // p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(
        n, -1, p * p * c)
    h = linear(torch, x, vt["patch_embedding"]["kernel"], vt["patch_embedding"]["bias"], act)
    h = h + vt["position_embedding"]["embedding"][None]
    lay = vt["layers"]
    fl = vis["feature_layer"]
    for l in range(fl + vis["num_hidden_layers"] + 1 if fl < 0 else fl):
        def lin(name, y):
            return linear(torch, y, lay[name]["kernel"][l], lay[name]["bias"][l], act)

        y = layer_norm(torch, h, lay["layer_norm1"]["scale"][l], lay["layer_norm1"]["bias"][l], eps)
        q, k, v = (lin(nm, y).reshape(n, -1, nh, hd).transpose(1, 2)
                   for nm in ("q_proj", "k_proj", "v_proj"))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1) @ v
        h = h + lin("out_proj", att.transpose(1, 2).reshape(n, -1, D))
        y = layer_norm(torch, h, lay["layer_norm2"]["scale"][l], lay["layer_norm2"]["bias"][l], eps)
        h = h + lin("fc2", torch.nn.functional.gelu(lin("fc1", y), approximate="tanh"))
    side = int(round(h.shape[1] ** 0.5))
    x = h.reshape(n, side, side // 2, 2 * D).permute(0, 2, 1, 3)
    x = x.reshape(n, side // 2, side // 2, 4 * D).permute(0, 2, 1, 3).reshape(n, -1, 4 * D)
    x = layer_norm(torch, x, pj["1"]["scale"], pj["1"]["bias"], config["projector"]["layer_norm_eps"])
    x = torch.nn.functional.gelu(linear(torch, x, pj["2"]["kernel"], pj["2"]["bias"], act))
    return linear(torch, x, pj["4"]["kernel"], pj["4"]["bias"], act)


def loss_of(torch, config, params, batch, device, act="f32", fault=None):
    llm = config["llm"]
    lw = params["llm"]
    D, hq, hkv = llm["hidden_size"], llm["num_attention_heads"], llm["num_key_value_heads"]
    hd, eps = D // hq, llm["rms_norm_eps"]
    ids = torch.tensor(batch["input_ids"], device=device)
    pos = torch.tensor(batch["positions"], device=device)
    seg = torch.tensor(batch["segment_ids"], device=device)
    emb = lw["embed_tokens"]["embedding"]
    h = emb[ids]
    if batch["tiles"] is not None:
        media = tower(torch, config, params["vision_tower"], params["mm_projector"],
                      torch.tensor(batch["tiles"], device=device), act)
        mp = torch.tensor(batch["media_positions"], device=device)
        h = h.index_put((mp,), media.reshape(-1, D))
    s = h.shape[0]
    idx = torch.arange(s, device=device)
    mask = (seg[:, None] == seg[None, :]) & (idx[None, :] <= idx[:, None])
    lay = lw["layers"]
    for l in range(llm["num_hidden_layers"]):
        x = rms_norm(torch, h, lay["input_layernorm"]["scale"][l], eps)
        q = linear(torch, x, lay["q_proj"]["kernel"][l], lay["q_proj"]["bias"][l], act)
        k = linear(torch, x, lay["k_proj"]["kernel"][l], lay["k_proj"]["bias"][l], act)
        v = linear(torch, x, lay["v_proj"]["kernel"][l], lay["v_proj"]["bias"][l], act)
        q = rope(torch, q.reshape(s, hq, hd), pos, llm["rope_theta"])
        k = rope(torch, k.reshape(s, hkv, hd), pos, llm["rope_theta"]).repeat_interleave(
            hq // hkv, dim=1)
        v = v.reshape(s, hkv, hd).repeat_interleave(hq // hkv, dim=1)
        sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        att = torch.einsum("hqk,khd->qhd", p, v).reshape(s, hq * hd)
        h = h + linear(torch, att, lay["o_proj"]["kernel"][l], None, act)
        x = rms_norm(torch, h, lay["post_attention_layernorm"]["scale"][l], eps)
        y = (torch.nn.functional.silu(linear(torch, x, lay["gate_proj"]["kernel"][l], None, act))
             * linear(torch, x, lay["up_proj"]["kernel"][l], None, act))
        h = h + linear(torch, y, lay["down_proj"]["kernel"][l], None, act)
    h = rms_norm(torch, h, lw["norm"]["scale"], eps)
    head = lw["lm_head"]["kernel"] if "lm_head" in lw else emb.t()
    logits = linear(torch, h[:-1], head, None, act)
    targets = torch.tensor(batch["labels"][1:], device=device)
    if fault == "half":
        keep = (targets != IGNORE).nonzero()[:, 0]
        targets = targets.clone()
        targets[keep[len(keep) // 2:]] = IGNORE
    valid = targets != IGNORE
    nll = torch.nn.functional.cross_entropy(logits[valid], targets[valid], reduction="sum")
    return nll / valid.sum().clamp(min=1)


def leaf_paths(config) -> Dict[str, List]:
    return {c: [p for p, _, _ in weights.vlm_spec(config)[c]] for c in COMPONENTS}


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def lr_at(tc: Dict[str, Any], peak: float, count: int) -> float:
    """The warm-up cosine schedule at update `count` (0 for the first)."""
    warm = max(int(tc["warmup_ratio"] * tc["total_steps"]), 1)
    if count < warm:
        return peak * count / warm
    decay = max(tc["total_steps"], warm + 1)
    frac = min(count - warm, decay - warm) / (decay - warm)
    return peak * 0.5 * (1.0 + math.cos(math.pi * frac))


def steps(torch, config, seed, rows: List[List[Dict]], device, act="f32", fault=None):
    """Run len(rows) steps from the seed's weights. Returns {"losses":
    [...], "grad": {leaf: norm of its first clipped gradient}, "change":
    {leaf: norm of its change after the last step}, "batches": the packed
    rows}."""
    no_tf32(torch)
    tc = config["training"]
    seq, pad = tc["seq_len"], 256  # the byte tokenizer's <|endoftext|>
    params = {c: weights.component(torch, config, seed, c, device, torch.float32)
              for c in COMPONENTS}
    paths = leaf_paths(config)
    peaks = {"llm": tc["learning_rate"],
             "vision_tower": tc["vision_tower_lr"] or tc["learning_rate"],
             "mm_projector": tc["mm_projector_lr"] or tc["learning_rate"]}
    ts = {c: [get(params[c], p).requires_grad_(True) for p in paths[c]] for c in COMPONENTS}
    m = {c: [torch.zeros_like(t) for t in ts[c]] for c in COMPONENTS}
    v = {c: [torch.zeros_like(t) for t in ts[c]] for c in COMPONENTS}
    losses, grad, batches = [], {}, []
    b1, b2, eps = tc["b1"], tc["b2"], tc["eps"]
    for count, row in enumerate(rows):
        batch = pack(row, seq, pad)
        batches.append(batch)
        loss = loss_of(torch, config, params, batch, device, act, fault)
        flat = [t for c in COMPONENTS for t in ts[c]]
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        losses.append(float(loss.detach()))
        del loss
        gs = [torch.zeros_like(t) if g is None else g for t, g in zip(flat, gs)]
        i = 0
        with torch.no_grad():
            for c in COMPONENTS:
                g = gs[i:i + len(ts[c])]
                i += len(ts[c])
                norm = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(x) for x in g]))
                clip = tc["max_grad_norm"] / torch.clamp(norm, min=tc["max_grad_norm"])
                g = [x * clip for x in g]
                if count == 0:
                    grad.update({"/".join((c,) + tuple(p)): float(torch.linalg.vector_norm(x))
                                 for p, x in zip(paths[c], g)})
                lr = lr_at(tc, peaks[c], count)
                for t, gx, mx, vx in zip(ts[c], g, m[c], v[c]):
                    mx.mul_(b1).add_(gx, alpha=1 - b1)
                    vx.mul_(b2).addcmul_(gx, gx, value=1 - b2)
                    t.mul_(1 - lr * tc["weight_decay"])
                    mh = mx / (1 - b1 ** (count + 1))
                    vh = vx / (1 - b2 ** (count + 1))
                    t.sub_(lr * mh / (vh.sqrt() + eps))
        del gs
    change = {}
    with torch.no_grad():
        for c in COMPONENTS:
            spec = {p: (shape, kind) for p, shape, kind in weights.vlm_spec(config)[c]}
            for p, t in zip(paths[c], ts[c]):
                t0 = weights.draw(torch, seed, c, p, *spec[p], config["weights"], device,
                                  torch.float32)
                change["/".join((c,) + tuple(p))] = float(torch.linalg.vector_norm(t - t0))
    return {"losses": losses, "grad": grad, "change": change, "batches": batches}
