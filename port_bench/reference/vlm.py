"""The plain float32 reference of NVILA serving: preprocessing, the W8A8
SigLIP tower, the `mlp_downsample` projector, the media splice and the
W4A16 Qwen2 LLM, teacher-forced over a prompt and the tokens that were
served, one full forward a request (no cache).

Quantized values are worked out again from the seeded bf16 weights, as the
deployment states them: W4 (symmetric, groups of 128 input rows, scale
amax / 7 stored in bf16) for every LLM projection and the output head, W8
per output channel with dynamic per-token int8 activations for the
tower's encoder linears. Everything else, and every activation, is
float32, with TF32 off.

`act="fp8"` is the control: the LLM computing in float8 e4m3 where the
deployment computes in bf16 (the nearest precision below it): each
projection's input, each cached key and value row and the residual stream
after each sub-layer rounded to e4m3, with a scale a row (a head for the
cache).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from port_bench import weights
from port_bench.tokenizer import ByteTokenizer, chat_prompt_ids

W4_GROUP = 128
E4M3_MAX = 448.0


def no_tf32(torch) -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def w4_dequant(torch, w):
    """(din, dout) bf16 -> the W4 values in f32: per group of 128 input
    rows and output column, q = clamp(round(w / s), -8, 7), s = amax / 7,
    stored in bf16."""
    din, dout = w.shape
    if din % (2 * W4_GROUP):
        raise ValueError(f"W4 groups of {W4_GROUP} need din % {2 * W4_GROUP} == 0, got {din}")
    g = w.float().reshape(din // W4_GROUP, W4_GROUP, dout)
    amax = g.abs().amax(dim=1, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, 7.0), min=1e-8)
    q = torch.clamp(torch.round(g / s), -8, 7)
    return (q * s.to(torch.bfloat16).float()).reshape(din, dout)


def w8_weights(torch, w):
    """(din, dout) bf16 -> (int8 values as f64, per-column f32 scale)."""
    w32 = w.float()
    amax = w32.abs().amax(dim=0, keepdim=True)
    s = torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-8)
    q = torch.clamp(torch.round(w32 / s), -127, 127)
    return q.double(), s[0]


def w8a8_linear(torch, x, q, s, bias):
    """Per-token int8 activations (row amax / 127) times the int8 weights,
    the integer sum exact (f64), scaled in f32."""
    a = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8)
    xq = torch.clamp(torch.round(x * (torch.full_like(a, 127.0) / a)), -127, 127)
    acc = (xq.double() @ q).float()
    return acc * (a * (1.0 / 127.0)) * s + bias.float()


def fp8_rows(torch, x):
    """x rounded to float8 e4m3 with one scale a row (amax / 448)."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-12) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def layer_norm(torch, x, scale, bias, eps):
    m = x.mean(-1, keepdim=True)
    v = (x - m).square().mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale.float() + bias.float()


def rms_norm(torch, x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale.float()


def resize(pixels: np.ndarray, size: int) -> np.ndarray:
    """NVILA's "resize" preprocessing: PIL's default (bicubic) resample
    to a size x size tile."""
    from PIL import Image

    if pixels.shape[:2] == (size, size):
        return pixels
    return np.asarray(Image.fromarray(pixels).resize((size, size)).convert("RGB"))


def tower(torch, config, seed, tiles: np.ndarray, device, chunk: int = 8):
    """(N, S, S, 3) uint8 tiles -> (N, tokens, llm hidden) f32 media
    embeddings: SigLIP up to its feature layer, W8A8 encoder linears, then
    the projector; `chunk` tiles at a time."""
    bf16 = torch.bfloat16
    vt = weights.component(torch, config, seed, "vision_tower", device, bf16)
    pj = weights.component(torch, config, seed, "mm_projector", device, bf16)
    return torch.cat([_tower(torch, config, vt, pj, tiles[i:i + chunk], device)
                      for i in range(0, len(tiles), chunk)])


def _tower(torch, config, vt, pj, tiles, device):
    vis = config["vision"]
    p, D = vis["patch_size"], vis["hidden_size"]
    nh = vis["num_attention_heads"]
    hd = D // nh
    eps = vis["layer_norm_eps"]
    x = torch.tensor(tiles, device=device).float() / 255.0
    x = (x - 0.5) / 0.5
    n, hgt, wid, c = x.shape
    gh, gw = hgt // p, wid // p
    x = x.reshape(n, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5).reshape(n, gh * gw, p * p * c)
    h = (x @ vt["patch_embedding"]["kernel"].float() + vt["patch_embedding"]["bias"].float()
         + vt["position_embedding"]["embedding"].float()[None])
    lay = vt["layers"]
    fl = vis["feature_layer"]
    for l in range(fl + vis["num_hidden_layers"] + 1 if fl < 0 else fl):
        lin = {k: w8_weights(torch, lay[k]["kernel"][l]) + (lay[k]["bias"][l],)
               for k in ("q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2")}
        y = layer_norm(torch, h, lay["layer_norm1"]["scale"][l], lay["layer_norm1"]["bias"][l],
                       eps)
        q, k, v = (w8a8_linear(torch, y, *lin[k]).reshape(n, -1, nh, hd).transpose(1, 2)
                   for k in ("q_proj", "k_proj", "v_proj"))
        att = torch.softmax((q @ k.transpose(-1, -2)) / math.sqrt(hd), dim=-1) @ v
        h = h + w8a8_linear(torch, att.transpose(1, 2).reshape(n, -1, D), *lin["out_proj"])
        y = layer_norm(torch, h, lay["layer_norm2"]["scale"][l], lay["layer_norm2"]["bias"][l],
                       eps)
        y = torch.nn.functional.gelu(w8a8_linear(torch, y, *lin["fc1"]), approximate="tanh")
        h = h + w8a8_linear(torch, y, *lin["fc2"])
    if fl == -1 or fl == vis["num_hidden_layers"]:
        h = layer_norm(torch, h, vt["post_layernorm"]["scale"], vt["post_layernorm"]["bias"], eps)
    # mlp_downsample: 2x2 unshuffle in the reference's channel order, then
    # LayerNorm, linear, GELU, linear
    side = int(round(h.shape[1] ** 0.5))
    x = h.reshape(n, side, side, D)
    if side % 2:
        x = torch.nn.functional.pad(x, (0, 0, 0, 1, 0, 1))
        side += 1
    x = x.reshape(n, side, side // 2, 2 * D).permute(0, 2, 1, 3)
    x = x.reshape(n, side // 2, side // 2, 4 * D).permute(0, 2, 1, 3).reshape(n, -1, 4 * D)
    x = layer_norm(torch, x, pj["1"]["scale"], pj["1"]["bias"], config["projector"]["layer_norm_eps"])
    x = torch.nn.functional.gelu(x @ pj["2"]["kernel"].float() + pj["2"]["bias"].float())
    return x @ pj["4"]["kernel"].float() + pj["4"]["bias"].float()


def rope(torch, x, theta):
    """Rotate-half RoPE over positions 0..S-1; x (S, H, hd) f32."""
    s, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device).float() / hd))
    f = torch.arange(s, device=x.device).float()[:, None] * inv
    emb = torch.cat([f, f], dim=-1)
    cos, sin = torch.cos(emb)[:, None], torch.sin(emb)[:, None]
    rot = torch.cat([-x[..., hd // 2:], x[..., :hd // 2]], dim=-1)
    return x * cos + rot * sin


def served_logits(torch, config, seed, items: List[Dict[str, Any]], device,
                  act: str = "f32") -> List[Any]:
    """The reference's logits (n, V) f32 at each served position of each
    item {"pixels": the request's image, "question": str, "tokens": the
    served ids}: position i predicts tokens[i] from the prompt and
    tokens[:i]."""
    if act not in ("f32", "fp8"):
        raise ValueError(f"act must be 'f32' or 'fp8', got {act!r}")
    no_tf32(torch)
    llm = config["llm"]
    size = config["vision"]["image_size"]
    tok = ByteTokenizer()
    media = tower(torch, config, seed, np.stack([resize(it["pixels"], size) for it in items]),
                  device)
    per_image = media.shape[1]
    image_id = tok.media_token_ids["image"]
    seqs, starts = [], []
    for i, it in enumerate(items):
        prompt = chat_prompt_ids(tok, it["question"], per_image)
        ids = torch.tensor(prompt + list(it["tokens"][:-1]), device=device)
        seqs.append(ids)
        starts.append(len(prompt) - 1)
    lw = weights.component(torch, config, seed, "llm", device, torch.bfloat16)
    hs = []
    for i, ids in enumerate(seqs):
        h = lw["embed_tokens"]["embedding"][ids].float()
        pos = (ids[:starts[i] + 1] == image_id).nonzero()[:, 0]
        h[pos] = media[i]
        hs.append(h)
    del lw["embed_tokens"]
    D, hq, hkv = llm["hidden_size"], llm["num_attention_heads"], llm["num_key_value_heads"]
    hd = D // hq
    eps = llm["rms_norm_eps"]
    lay = lw["layers"]
    cast = (lambda x: fp8_rows(torch, x)) if act == "fp8" else (lambda x: x)

    for l in range(llm["num_hidden_layers"]):
        w = {k: w4_dequant(torch, lay[k]["kernel"][l])
             for k in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                       "down_proj")}
        b = {k: lay[k]["bias"][l].float() for k in ("q_proj", "k_proj", "v_proj")}
        for i, h in enumerate(hs):
            s = h.shape[0]
            x = cast(rms_norm(torch, h, lay["input_layernorm"]["scale"][l], eps))
            q = rope(torch, (x @ w["q_proj"] + b["q_proj"]).reshape(s, hq, hd), llm["rope_theta"])
            k = rope(torch, (x @ w["k_proj"] + b["k_proj"]).reshape(s, hkv, hd),
                     llm["rope_theta"])
            v = (x @ w["v_proj"] + b["v_proj"]).reshape(s, hkv, hd)
            k, v = cast(k), cast(v)  # the cache's rows
            k = k.repeat_interleave(hq // hkv, dim=1)
            v = v.repeat_interleave(hq // hkv, dim=1)
            sc = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            mask = torch.ones(s, s, dtype=torch.bool, device=device).tril()
            p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
            att = torch.einsum("hqk,khd->qhd", p, v).reshape(s, hq * hd)
            h = cast(h + cast(att) @ w["o_proj"])
            x = cast(rms_norm(torch, h, lay["post_attention_layernorm"]["scale"][l], eps))
            y = torch.nn.functional.silu(x @ w["gate_proj"]) * (x @ w["up_proj"])
            hs[i] = cast(h + cast(y) @ w["down_proj"])
        del w
    head = w4_dequant(torch, lw["lm_head"]["kernel"]) if "lm_head" in lw else None
    if head is None:
        raise ValueError("the serving reference takes an untied W4 lm_head")
    out = []
    for i, h in enumerate(hs):
        rows = h[starts[i]:]
        out.append(cast(rms_norm(torch, rows, lw["norm"]["scale"], eps)) @ head)
    return out


def gaps(torch, ref_rows, picks) -> List[float]:
    """How far each pick's logit lies below the reference's best, per row."""
    best = ref_rows.max(dim=-1).values
    got = ref_rows.gather(-1, torch.as_tensor(picks, device=ref_rows.device)[:, None])[:, 0]
    return (best - got).tolist()
