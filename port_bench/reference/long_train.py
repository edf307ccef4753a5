"""The plain float32 reference of long-context VLM fine-tuning: the check's
two steps of the `sft` stage on one packed row of long videos (a
131072-token row of several videos), computed in blocks so that it fits on
the cards.

The mathematics is `reference/train.py`'s (its `pack`, `tower`, `linear`,
`rope` and `lr_at` are used as they are): the SigLIP tower up to its
feature layer over each frame, the `mlp_downsample` projector, the splice,
the Qwen2 LLM with causal attention inside each packed sample, the untied
output projection and the mean cross entropy of the labelled next tokens;
the gradient of every leaf, each component clipped by its own global norm.
Rows are in causal order (the program's zigzag layout is its own). The
two steps train on the same row. The first update has rate 0 (the warm-up
starts at 0), so the second step sees the drawn weights and the same
gradient, and AdamW's second update follows from that gradient alone
(`steps`): each leaf's step along its gradient is compared.

How it fits (`devices`: one or more; the cards after the program's ranks
have exited). Each decoder layer's weights live on one device; each device
runs the layer on a copy of its own, whose gradient is summed into the
weights once the layer's backward is done (`_sum_grads`). The row's real tokens are split into one contiguous
part a device, the parts of equal work (`_row_layout`); padding rows are
left out (nothing reads them). The forward keeps each layer's input (no
graph); attention takes each part's queries of a sample against that
sample's keys up to them (`_attention`, PyTorch's
scaled_dot_product_attention in float32). The backward recomputes one
layer at a time from its kept input, over every device at once, then the
frames' features: the tower is run with no graph for the forward and
again, a few frames at a time, for its backward, each device on its own
share of the frames (`_media`).
Everything is float32 with TF32 off. Every gradient stays on its
tensor's device until its component's clipping norm is known (4 bytes a
parameter over the cards).

`act="fp8"` is the control: every linear's input and weight rounded to
float8 e4m3 (`reference/train.py`'s `linear`).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Dict, List, Optional

import numpy as np

from port_bench import weights
from port_bench.reference.train import COMPONENTS, IGNORE, leaf_paths, linear, lr_at, pack, rope, tower
from port_bench.reference.vlm import no_tf32, rms_norm

FRAME_CHUNK = 4  # frames the tower's backward runs at a time (its activations: ~4.4 GB a frame)
FORWARD_CHUNK = 16  # frames its forward, with no graph, runs at a time
ROW_CHUNK = 4096  # rows the output projection runs at a time
# a query this far into its sample costs as much in attention as in its
# dense work, over a layer's forward and backward (f32 on the card)
ATTENTION_TOKENS = 24000


def _parallel(fn, items) -> list:
    """fn(i, item) for each item, one thread each (one a device: each
    keeps its card busy while the others launch)."""
    out = [None] * len(items)
    errors = []

    def one(i, item):
        try:
            out[i] = fn(i, item)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i, x)) for i, x in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _copies(tree, device, grad: bool):
    """The tree's tensors on `device`; each a leaf of its own when `grad`."""
    if isinstance(tree, dict):
        return {k: _copies(v, device, grad) for k, v in tree.items()}
    return tree.detach().to(device).requires_grad_(grad)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    return [tree]


def _sum_grads(tree, copies) -> None:
    """Add every copy's gradient into its tensor's `.grad` in the tree.
    Each device holds a leaf copy of the weights it runs, so that a
    device's backward never waits on another's (a gradient copied across
    cards inside the graph makes the sending card wait for the receiving
    card's queued work), and the sums are taken once the backward is done."""
    for t, *cs in zip(_leaves(tree), *(_leaves(c) for c in copies)):
        for c in cs:
            if c.grad is not None:
                g = c.grad.to(t.device)
                t.grad = g if t.grad is None else t.grad + g


def _pieces(seg: np.ndarray, start: np.ndarray, a: int, b: int, c: int):
    """(query start, stop, key start, stop) of each sample's queries among
    the row's [a, b): queries counted from a, keys from the part's key
    context's first row c. A sample's queries attend its keys from its
    start up to the last of them; padding rows (segment 0) are left out."""
    s = seg[a:b]
    cut = np.r_[0, np.nonzero(s[1:] != s[:-1])[0] + 1, len(s)]
    return [(int(r0), int(r1), int(start[a + r0]) - c, int(r1) + a - c)
            for r0, r1 in zip(cut[:-1], cut[1:]) if s[r0] > 0]


def _attention(torch, q, k, v, pieces):
    """Causal attention inside packed samples for one part's queries q
    (Sq, Hq, hd) against its key context k, v (Sk, Hkv, hd): each piece's
    queries against their sample's keys up to them (the causal mask
    aligned to the piece's last key), other rows 0. PyTorch's
    scaled_dot_product_attention in float32: on the card its
    memory-efficient kernel (2.0e-6 from a float64 truth over a 43k-token
    sample on an H100), on the CPU the plain one."""
    from torch.nn.attention.bias import causal_lower_right

    group = q.shape[1] // k.shape[1]

    def heads(x):
        return x.permute(1, 0, 2)[None]

    out, at = [], 0
    for q0, q1, k0, k1 in pieces:
        if q0 > at:
            out.append(q.new_zeros((q0 - at,) + q.shape[1:]))
        o = torch.nn.functional.scaled_dot_product_attention(
            heads(q[q0:q1]), heads(k[k0:k1].repeat_interleave(group, 1)),
            heads(v[k0:k1].repeat_interleave(group, 1)),
            attn_mask=causal_lower_right(q1 - q0, k1 - k0))
        out.append(o[0].permute(1, 0, 2))
        at = q1
    if at < q.shape[0]:
        out.append(q.new_zeros((q.shape[0] - at,) + q.shape[1:]))
    return torch.cat(out)


class _Model:
    """The drawn weights spread over `devices`, and one row's layout."""

    def __init__(self, torch, config, seed, devices):
        self.torch, self.config, self.devices = torch, config, devices
        llm = config["llm"]
        self.L = llm["num_hidden_layers"]
        n = len(devices)
        self.layer_dev = [devices[l * n // self.L] for l in range(self.L)]
        spec = {p: (shape, kind) for p, shape, kind in weights.vlm_spec(config)["llm"]}

        def draw(path, device):
            return weights.draw(torch, seed, "llm", path, *spec[path], config["weights"], device,
                                torch.float32)

        self.layers = [dict() for _ in range(self.L)]
        for path in spec:
            if path[0] != "layers":
                continue
            whole = draw(path, devices[0])
            for l in range(self.L):
                self.layers[l].setdefault(path[1], {})[path[2]] = (
                    whole[l].to(self.layer_dev[l]).clone())
            del whole
        self.embed = draw(("embed_tokens", "embedding"), devices[0])
        self.norm = draw(("norm", "scale"), devices[-1])
        self.head = (draw(("lm_head", "kernel"), devices[-1]) if not llm["tie_word_embeddings"]
                     else None)
        self.vt = weights.component(torch, config, seed, "vision_tower", devices[0],
                                    torch.float32)
        self.pj = weights.component(torch, config, seed, "mm_projector", devices[0],
                                    torch.float32)

    def trainable(self):
        """(component, path, tensors) of every leaf: a decoder leaf's
        tensors are its layers'."""
        out = []
        for c, path in ((c, p) for c in COMPONENTS for p in leaf_paths(self.config)[c]):
            if c == "llm" and path[0] == "layers":
                ts = [self.layers[l][path[1]][path[2]] for l in range(self.L)]
            elif c == "llm":
                ts = [{"embed_tokens": self.embed, "norm": self.norm,
                       "lm_head": self.head}[path[0]]]
            else:
                t = self.vt if c == "vision_tower" else self.pj
                for k in path:
                    t = t[k]
                ts = [t]
            out.append((c, path, ts))
        return out


def _media(torch, model, tiles, act, grad_out=None):
    """The frames' projected features (frames * tokens, D) on devices[0]
    with no graph; or, given their gradient, the tower's backward (its
    gradients summed into the weights' `.grad`). Each device takes an even
    share of the frames, a few at a time, on its own copy of the weights,
    from a thread of its own."""
    devs = model.devices
    per = -(-len(tiles) // len(devs))
    grad = grad_out is not None
    chunk = FRAME_CHUNK if grad else FORWARD_CHUNK
    shares = [(d, tiles[i * per:(i + 1) * per]) for i, d in enumerate(devs)]
    shares = [(i, d, f) for i, (d, f) in enumerate(shares) if len(f)]
    weights = [(_copies(model.vt, d, grad), _copies(model.pj, d, grad)) for _, d, _ in shares]

    def one(k, share):
        i, dev, frames = share
        vt, pj = weights[k]
        x = torch.as_tensor(frames, device=dev)
        g = grad_out[i * per:(i + 1) * per].to(dev) if grad else None
        out = []
        with torch.set_grad_enabled(grad):  # per thread
            for j in range(0, len(x), chunk):
                y = tower(torch, model.config, vt, pj, x[j:j + chunk], act)
                if grad:
                    torch.autograd.backward(y, g[j:j + chunk])
                else:
                    out.append(y)
        return torch.cat(out).to(devs[0]) if out else None

    feats = _parallel(one, shares)
    if grad:
        with torch.no_grad():
            _sum_grads(model.vt, [vt for vt, _ in weights])
            _sum_grads(model.pj, [pj for _, pj in weights])
        return None
    return torch.cat(feats).reshape(-1, model.embed.shape[1])


def _layer(torch, model, ws, hs, row, act, grad: bool):
    """A layer over every part (a list of (rows, D) on their devices), with
    each device's copy of its weights (`ws`, `_copies`); a graph across the
    devices when `grad`."""
    llm = model.config["llm"]
    D, hq, hkv = llm["hidden_size"], llm["num_attention_heads"], llm["num_key_value_heads"]
    hd, eps = D // hq, llm["rms_norm_eps"]
    devs = model.devices

    def qkv(i, h):
        with torch.set_grad_enabled(grad):  # per thread
            return _qkv(i, h)

    def _qkv(i, h):
        wd = ws[i]
        x = rms_norm(torch, h, wd["input_layernorm"]["scale"], eps)
        pos = row["pos"][i]
        q = rope(torch, linear(torch, x, wd["q_proj"]["kernel"], wd["q_proj"].get("bias"), act)
                 .reshape(-1, hq, hd), pos, llm["rope_theta"])
        k = rope(torch, linear(torch, x, wd["k_proj"]["kernel"], wd["k_proj"].get("bias"), act)
                 .reshape(-1, hkv, hd), pos, llm["rope_theta"])
        v = linear(torch, x, wd["v_proj"]["kernel"], wd["v_proj"].get("bias"), act).reshape(
            -1, hkv, hd)
        return q, k, v

    with torch.set_grad_enabled(grad):
        parts = _parallel(qkv, hs)

        def rest(i, h):
            with torch.set_grad_enabled(grad):  # per thread
                return _rest(i, h)

        def _rest(i, h):
            dev, wd = devs[i], ws[i]
            lo = row["ctx"][i]
            k = torch.cat([p[1].to(dev) for p in parts])[lo:]
            v = torch.cat([p[2].to(dev) for p in parts])[lo:]
            att = _attention(torch, parts[i][0], k, v, row["pieces"][i])
            h = h + linear(torch, att.reshape(-1, hq * hd), wd["o_proj"]["kernel"], None, act)
            x = rms_norm(torch, h, wd["post_attention_layernorm"]["scale"], eps)
            y = (torch.nn.functional.silu(linear(torch, x, wd["gate_proj"]["kernel"], None, act))
                 * linear(torch, x, wd["up_proj"]["kernel"], None, act))
            return h + linear(torch, y, wd["down_proj"]["kernel"], None, act)

        return _parallel(rest, hs)


def _row_layout(torch, batch, devices):
    """Each device's part of the row's tokens, padding rows left out
    (nothing reads them): contiguous parts of the same work, a token
    weighing 1 + its place in its sample / ATTENTION_TOKENS. Per part: its
    positions, its key context's first row and its attention pieces
    (`_pieces`)."""
    seg = np.asarray(batch["segment_ids"])
    s = int(np.nonzero(seg > 0)[0][-1]) + 1
    n = len(devices)
    start = np.zeros(len(seg), np.int64)
    new = np.r_[True, seg[1:] != seg[:-1]]
    start[new] = np.nonzero(new)[0]
    start = np.maximum.accumulate(start)
    work = np.cumsum(1.0 + (np.arange(s) - start[:s]) / ATTENTION_TOKENS)
    bounds = [0] + [int(np.searchsorted(work, work[-1] * i / n)) for i in range(1, n)] + [s]
    out = {"bounds": bounds, "pos": [], "ctx": [], "pieces": []}
    for i, d in enumerate(devices):
        a, b = bounds[i], bounds[i + 1]
        c = int(start[a])
        out["pos"].append(torch.as_tensor(batch["positions"][a:b], device=d))
        out["ctx"].append(c)
        out["pieces"].append(_pieces(seg, start, a, b, c))
    return out


def _head_loss(torch, model, h_parts, batch, act, grad: bool):
    """(the summed NLL of the labelled next tokens, their count, the
    gradient of the mean with respect to each part when `grad`)."""
    llm = model.config["llm"]
    devs = model.devices
    labels = np.asarray(batch["labels"])
    targets = np.r_[labels[1:], IGNORE]  # row i predicts token i + 1
    count = int((targets != IGNORE).sum())
    head = model.head if model.head is not None else model.embed.t()
    bounds = np.cumsum([0] + [h.shape[0] for h in h_parts])

    def one(i, h):
        dev = devs[i]
        hw, nw = head.to(dev), model.norm.to(dev)
        tg = torch.as_tensor(targets[bounds[i]:bounds[i + 1]], device=dev)
        total = torch.zeros((), device=dev)
        g = torch.zeros_like(h) if grad else None
        for r in range(0, h.shape[0], ROW_CHUNK):
            t = tg[r:r + ROW_CHUNK]
            valid = t != IGNORE
            with torch.set_grad_enabled(grad):
                x = h[r:r + ROW_CHUNK].detach().requires_grad_(grad)
                logits = linear(torch, rms_norm(torch, x, nw, llm["rms_norm_eps"]), hw, None, act)
                nll = torch.nn.functional.cross_entropy(logits[valid], t[valid], reduction="sum")
            if grad:
                (nll / count).backward()
                g[r:r + ROW_CHUNK] = x.grad
            total = total + nll.detach()
        return total.to(devs[0]), g

    out = _parallel(one, h_parts)
    return sum(o[0] for o in out), count, [o[1] for o in out]


def _forward(torch, model, batch, act, keep: bool):
    """(loss, count, each layer's input parts when `keep`, the last
    hidden parts) with no graph."""
    devs = model.devices
    row = _row_layout(torch, batch, devs)
    ids = torch.as_tensor(batch["input_ids"], device=devs[0])
    with torch.no_grad():
        h = model.embed[ids]
        if batch["tiles"] is not None:
            media = _media(torch, model, batch["tiles"], act)
            h = h.index_put((torch.as_tensor(batch["media_positions"], device=devs[0]),), media)
        b = row["bounds"]
        hs = [h[b[i]:b[i + 1]].to(d) for i, d in enumerate(devs)]
        del h
        kept = []
        for l in range(model.L):
            if keep:
                kept.append(hs)
            ws = [_copies(model.layers[l], d, False) for d in devs]
            hs = _layer(torch, model, ws, hs, row, act, grad=False)
    return row, hs, kept


def _gradients(torch, model, batch, row, hs, kept, act) -> tuple:
    """(loss, {id(leaf tensor): its gradient}) of the row's mean loss, the
    backward recomputing one layer at a time; every gradient stays on its
    tensor's device."""
    for _, _, ts in model.trainable():
        for t in ts:
            t.requires_grad_(True)
            t.grad = None
    grads: Dict[int, Any] = {}

    def take(ts):
        for t in ts:
            if t.grad is not None:
                grads[id(t)] = t.grad
            t.grad = None

    total, count, gs = _head_loss(torch, model, hs, batch, act, grad=True)
    take([model.norm] + ([model.head] if model.head is not None else []))
    for l in reversed(range(model.L)):
        ins = [h.detach().requires_grad_(True) for h in kept[l]]
        kept[l] = None
        ws = [_copies(model.layers[l], d, True) for d in model.devices]
        outs = _layer(torch, model, ws, ins, row, act, grad=True)
        torch.autograd.backward(outs, gs)
        gs = [x.grad for x in ins]
        del outs, ins
        with torch.no_grad():
            _sum_grads(model.layers[l], ws)
        del ws
        take([t for slot in model.layers[l].values() for t in slot.values()])
    devs = model.devices
    g0 = torch.cat([g.to(devs[0]) for g in gs])  # the real rows'
    ids = torch.as_tensor(batch["input_ids"][:len(g0)], device=devs[0])
    text = torch.ones(len(ids), dtype=torch.bool, device=devs[0])
    if batch["tiles"] is not None:
        mp = torch.as_tensor(batch["media_positions"], device=devs[0])
        text[mp] = False
        _media(torch, model, batch["tiles"], act,
               grad_out=g0[mp].reshape(len(batch["tiles"]), -1, g0.shape[1]))
    with torch.no_grad():
        grads[id(model.embed)] = torch.zeros_like(model.embed).index_add_(0, ids[text], g0[text])
    del g0
    for c, _, ts in model.trainable():
        if c != "llm":
            take(ts)
        for t in ts:
            t.requires_grad_(False)
    return float(total) / max(count, 1), grads


def steps(torch, config, seed, samples: List[Dict], devices, act: str = "f32",
          seq_len: Optional[int] = None) -> Dict[str, Any]:
    """The check's two steps, each on the same packed row (`samples`), from
    the seed's weights. The first update's rate is 0 (the warm-up starts at
    0), so both steps see the drawn weights and take the same gradient g;
    AdamW's bias-corrected moments after them are g and g^2, so the second
    update is lr(1) g / (|g| + eps), with the decay lr(1) wd p. Returns
    {"losses": the two steps', "grad": {leaf: norm of its clipped
    gradient}, "step": {leaf: its step along its gradient, -<change, g>
    over the second update (lr(1) |g|_1 where |g| >> eps)}, "batches": the
    packed row, once a step}."""
    no_tf32(torch)
    tc = config["training"]
    if tc["warmup_ratio"] <= 0:
        raise ValueError("the reference takes the first update's rate to be 0 (a warm-up)")
    model = _Model(torch, config, seed, devices)
    batch = pack(samples, seq_len or tc["seq_len"], 256)  # the byte tokenizer's <|endoftext|>
    row, hs, kept = _forward(torch, model, batch, act, keep=True)
    loss, grads = _gradients(torch, model, batch, row, hs, kept, act)
    del row, hs, kept
    peaks = {"llm": tc["learning_rate"],
             "vision_tower": tc["vision_tower_lr"] or tc["learning_rate"],
             "mm_projector": tc["mm_projector_lr"] or tc["learning_rate"]}
    leaves = model.trainable()
    grad, along = {}, {}
    with torch.no_grad():
        for c in COMPONENTS:
            mine = [(("/".join((c,) + tuple(p))), ts) for cc, p, ts in leaves if cc == c]
            sq = {k: sum(float(grads[id(t)].double().square().sum()) for t in ts
                         if id(t) in grads) for k, ts in mine}
            norm = math.sqrt(sum(sq.values()))
            clip = tc["max_grad_norm"] / max(norm, tc["max_grad_norm"])
            lr = lr_at(tc, peaks[c], 1)
            for k, ts in mine:
                grad[k] = math.sqrt(sq[k]) * clip
                along[k] = 0.0
                for t in ts:
                    g = grads.pop(id(t), None)
                    step = t * (lr * tc["weight_decay"])
                    if g is not None:
                        g.mul_(clip)
                        step.add_(g / (g.abs() + tc["eps"]), alpha=lr)
                        along[k] += float((step * g).sum(dtype=torch.float64))
                    del g, step
    return {"losses": [loss, loss], "grad": grad, "step": along, "batches": [batch] * 2}


def loss(torch, config, seed, samples: List[Dict], devices, act: str = "f32",
         seq_len: Optional[int] = None) -> float:
    """The first step's loss alone (a forward from the seed's weights), as
    `steps` takes it."""
    no_tf32(torch)
    model = _Model(torch, config, seed, devices)
    batch = pack(samples, seq_len or config["training"]["seq_len"], 256)
    _, hs, _ = _forward(torch, model, batch, act, keep=False)
    total, n, _ = _head_loss(torch, model, hs, batch, act, grad=False)
    return float(total) / max(n, 1)
