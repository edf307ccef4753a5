#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vila_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, as a check
    python3 chip_smoke.py --phases build,kernels

Phases:
  build        compile every CUDA kernel of the served path from
               `vila_tpu_torch/csrc/` (one nvcc per source, in parallel);
  kernels      hold each kernel against its plain PyTorch version on the
               card at the NVILA-8B main-path shapes, and time kernel, plain
               version and the nearest PyTorch library call (and cuBLAS
               bf16 `x @ w` over the dequantised weights beside each W4
               GEMM / GEMV); K2's products alone (the dots-only variant, X1)
               over those weights; K6's digit pass (prologue values, digits,
               scales and sums bit for bit) and rows GEMV also on their own;
               K3's stage times from inside its one launch and K6's
               launches one by one; K2 at M = 1536 and 8192 (the media
               prompts' buckets) and K3 at cache 8192 / fill 4141 (the
               video's cache); K4/K5's product-1 digits bit for bit,
               a repeat launch bit for bit, stage times from inside the
               launch and the same products through K6's rows route; K1
               (the `k1` phase) on the lm_head at M = 1, 2, 8, 16, 17, 24
               and 32, a stacked qkv at M = 1, 8 and 24 and one layer's
               four projections at M = 24, its wgmma form's digits and
               both forms' repeat launches bit for bit and the stream probe
               (128- and 256-byte boxes, 16-byte loads); then K1-K6 at Qwen2-0.5B widths (head dim 64, W4
               groups of 112 and 128, then every product in groups of 64);
  k1           (only when named) K1 alone through its public wrapper, as
               in `kernels`: it runs on an earlier tree of the port as well
               (old-against-new calls);
  k1_forms     (only when named) K1's digit, repeat and probe checks, as
               in `kernels`;
  e2e          serve 3 image+prompt requests through `GenerationEngine` at
               the full NVILA-8B width (Qwen2-7B W4A16 LLM, 28 layers;
               SigLIP-SO400M-448 bf16; mlp_downsample projector), weights
               synthesised on the card from a seed; reports TTFT, decode
               tok/s and the launch count of every kernel;
  consistency  at full width and 4 layers, the kernel decode path's
               per-step logits against one cache-free forward over prefix
               plus generated tokens run through the plain versions on the
               CPU;
  batched_consistency  the same for the batched routes: B = 3 (K6) and
               B = 20 (K4/K5);
  small_consistency  every decode route (bs=1 K3, B = 3 K6, B = 20 K4/K5)
               at Qwen2-0.5B widths (head dim 64, W4 groups of 112), 4
               layers, text only, against the plain CPU forward;
  s2           NVILA-8B with dynamic-S2 (scales 448, 896, 1344, max 12 tiles,
               s2_resize_output_to_scale_idx -1, mlp_downsample_3x3_fix over
               3 x 1152) through `entry.build_config`: one seeded 1344 x 1008
               image gives 17 tiles and a 3 x 4 block grid, 1452 media tokens
               (bucket 1536); the W4 LLM of `e2e`, the W8A8 tower; 2 requests
               x 16 tokens with exact K1-K3 launches; the media embeddings
               against the reference's formulation, layer 0's int8 products
               exact, request 0's greedy tokens against the plain versions
               on the card; the tower's time over the 17 tiles, bf16 and W8A8;
  video        the NVILA-Video-8B TinyChat condition the same way: a TSP video
               encoder (pool (4, 1, 1)) over 64 seeded 720 x 1280 frames
               resized by the native library, ≈ 4.1k prompt tokens (bucket
               8192: K2 at M = 8192, K3 over a cache of 8192 rows with ≈ 4.1k
               live); 2 requests x 32 tokens;
  media_profile  (only when named) torch.profiler traces of the s2 and
               video requests' media encode and prefill: device busy time
               and the operations by device time;
  load         the loader at full NVILA-8B width, LLM depth 4: unquantized
               bf16 weights synthesised on the card from a seed of their
               own, written with `entry.save` (≈ 9.9 GB of f32 safetensors
               under `runs/`, removed at the end) and read back with
               `entry.build_config` / `entry.load_params` (config equal,
               every leaf bit for bit); `quantize_llm_params` on the card
               (layer 0's slots and the lm_head bit for bit against the
               CPU); the SigLIP tower to W8A8 (layer 0's six int8 products:
               activations, int32 sums and outputs equal to the plain
               version on the CPU; one image through the tower, bf16
               against W8A8, timed); 2 image + prompt requests x 16 tokens
               through the engine over the loaded W4 LLM and W8A8 tower
               (exact K1-K3 launches, TTFT, decode tok/s; the first 8
               greedy tokens against the argmax of a plain CPU forward);
               then the quantizer's peak memory on a 28-layer bf16 LLM;
  train_kernels  hold the flash-attention kernels K7 (forward), K8 (dQ)
               and K9 (dK/dV) against their plain versions at the
               NVILA-Lite-2B training shape (B 1, S 2048, 12/2 heads of 128,
               causal, three packed segments and a padding tail), at
               S 2000 (ragged tiles), causal alone, on the `train` phase's
               first packed row, on shuffled segment ids, and at Sq 1024
               against Skv 2048 without causality; times kernel, plain
               version and scaled_dot_product_attention forward / backward,
               counts the tile pairs each kernel walks, and checks that a
               second launch of K8 repeats its dQ bit for bit;
  train        NVILA-Lite-2B SFT at full width (Qwen2-1.5B LLM, 28 layers;
               SigLIP-SO400M-448; mlp_downsample), f32 master weights
               synthesised on the card from a seed, bf16 compute: 6 steps of
               `Trainer` over `DummyDataset` images packed into one 2048-token
               row, checkpoints at 3 and 6; then a fresh `Trainer` resumes
               from step 3 and must reproduce steps 4-6 exactly; exact K7-K9 launch
               counts, step wall, tokens/s, model-FLOPs share, peak memory;
  train_consistency  one `train_step` at full widths with 2 LLM and 2 SigLIP
               layers at seq 512 on the card (kernels) against the same
               step on the CPU (plain versions);
  profile      (only when named) torch.profiler trace of one request:
               device busy time and idle share of a decode step; then one
               max_batch=8 decode step (K6): host issue time per layer and
               the device's busy share of the step;
  train_profile  (only when named) one full-width training step traced:
               device busy time and the ops by device time;

The second-to-last line is the kernels JSON, the last line
`{"ok": true, "device": {...}}`. The script exits nonzero, and prints no
result, without CUDA or without the package beside it. Long reports (ptxas
output, per-shape numbers) go to `chiprun_out/`.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
OUT_DIR = "chiprun_out"

KERNELS = {
    "w4_gemv": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_gemv_sm90.cu",
        replaces="vila_tpu/ops/quant.py:384 (_w4_decode_manual_kernel; "
                 "grid form quant.py:349)"),
    "w4_gemm": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_gemm_sm90.cu",
        replaces="vila_tpu/ops/quant.py:796 (_w4_prefill_kernel; stacked "
                 "closure quant.py:914)"),
    # X1-X3, TPU timing prototypes of K2's body on no path: the dequant's
    # overlap and the single K loop live in K2; this is X1's products alone
    "w4_gemm_dots": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_gemm_sm90.cu (DOTS variant)",
        replaces="experiments/chip_prefill_pipeline.py:46 (dots_only_kernel; "
                 "pallas_call chip_prefill_pipeline.py:189)"),
    "fused_layer": dict(
        route="cuda", source="vila_tpu_torch/csrc/decode_layer_sm90.cu",
        replaces="vila_tpu/ops/fused_decode.py:550 (_fused_layer_kernel)"),
    "fused_o_gateup": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_pair_sm90.cu",
        replaces="vila_tpu/ops/fused_decode.py:108 (_fused_o_gateup_kernel; pallas_call "
                 "fused_decode.py:390)"),
    "fused_down_qkv": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_pair_sm90.cu",
        replaces="vila_tpu/ops/fused_decode.py:212 (_fused_down_qkv_kernel; pallas_call "
                 "fused_decode.py:484)"),
    "fused_layer_batched": dict(
        route="cuda",
        source="vila_tpu_torch/csrc/decode_attn.cu + "
               "vila_tpu_torch/csrc/w4_gemv_mma.cu",
        replaces="vila_tpu/ops/fused_decode.py:1014 (_fused_layer_b_kernel)"),
    "flash_fwd": dict(
        route="cuda", source="vila_tpu_torch/csrc/flash_attn_sm90.cu",
        replaces="vila_tpu/ops/flash_attention.py:50 (_fwd_kernel; pallas_call "
                 "flash_attention.py:229)"),
    "flash_bwd_dq": dict(
        route="cuda", source="vila_tpu_torch/csrc/flash_attn_sm90.cu",
        replaces="vila_tpu/ops/flash_attention.py:306 (_bwd_dq_kernel; pallas_call "
                 "flash_attention.py:436)"),
    "flash_bwd_dkv": dict(
        route="cuda", source="vila_tpu_torch/csrc/flash_attn_sm90.cu",
        replaces="vila_tpu/ops/flash_attention.py:356 (_bwd_dkv_kernel; pallas_call "
                 "flash_attention.py:465)"),
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# K1's lm_head work on the batched routes, reported inside its entry:
# (rows, the path that runs it)
K1_BATCHED = ((8, "serve b8"), (24, "serve b24"))
# the kernels the serial (bs=1) path must launch (e2e, load, s2, video)
E2E_KERNELS = ("w4_gemv", "w4_gemm", "fused_layer")
# (max_batch, requests, new tokens) of each serve run: K6, then K4/K5
SERVE_RUNS = ((8, 12, 32), (24, 24, 16))
DEFAULT_PHASES = ("build,kernels,e2e,serve,consistency,batched_consistency,"
                  "small_consistency,http,s2,video,load,train_kernels,train,"
                  "train_consistency")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# Tokenizer (defined here so that the script needs no `transformers`)
# --------------------------------------------------------------------------


class ByteTokenizer:
    """Byte-level tokenizer with a ChatML template: ids 0-255 are the
    UTF-8 bytes, special tokens follow. Implements what `GenerationEngine`
    and the training data path (`preprocess_conversation`: special tokens
    added on the fly, the sentinel among them; the collators' pad id)
    call."""

    def __init__(self):
        self.vocab = {}
        self.add_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                        special_tokens=True)
        self.eos_token = "<|im_end|>"
        self.pad_token_id = self.vocab["<|endoftext|>"]
        from vila_tpu_torch.data.tokenizer_utils import add_media_tokens

        add_media_tokens(self)

    def __len__(self):
        return 256 + len(self.vocab)

    def add_tokens(self, tokens, special_tokens=True):
        for t in tokens:
            if t not in self.vocab:
                self.vocab[t] = 256 + len(self.vocab)
        self._inv = {i: t for t, i in self.vocab.items()}

    def convert_tokens_to_ids(self, token):
        return self.vocab.get(token)

    def __call__(self, text, add_special_tokens=False):
        ids = []
        specials = sorted(self.vocab, key=len, reverse=True)
        i = 0
        while i < len(text):
            for s in specials:
                if text.startswith(s, i):
                    ids.append(self.vocab[s])
                    i += len(s)
                    break
            else:
                j = i + 1
                while j < len(text) and not any(text.startswith(s, j) for s in specials):
                    j += 1
                ids.extend(text[i:j].encode("utf-8"))
                i = j
        return argparse.Namespace(input_ids=ids)

    def apply_chat_template(self, chat, add_generation_prompt=False, tokenize=False):
        text = "".join(
            f"<|im_start|>{m['role']}\n{m['content']}<|im_end|>\n" for m in chat
        )
        if add_generation_prompt:
            text += "<|im_start|>assistant\n"
        return text

    def decode(self, ids, skip_special_tokens=False):
        if not hasattr(ids, "__iter__"):
            ids = [ids]
        out, buf = [], bytearray()
        for i in (int(x) for x in ids):
            if i < 256:
                buf.append(i)
                continue
            out.append(buf.decode("utf-8", errors="replace"))
            buf = bytearray()
            if not skip_special_tokens:
                out.append(self._inv.get(i, ""))
        out.append(buf.decode("utf-8", errors="replace"))
        return "".join(out)


# --------------------------------------------------------------------------
# Timing and bounds
# --------------------------------------------------------------------------


def time_ms(torch, fn, reps, flush=None):
    """Median device time of one call, CUDA events around each call; the
    L2 (50 MB) is overwritten before each call, as a caller streaming a new
    layer's weights finds it. A device-side wait before each call lets the
    host queue all of the call's launches first, so host time between them
    does not count."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms of device clock cycles
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(bytes_moved, ops, op_rate):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / op_rate * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def w4_bytes(din, dout, group=128):
    """Packed bytes plus the scale rows the function uses (2 per 128-row
    group pair, bf16)."""
    return din // 2 * dout + (din // group) * dout * 2


def rel_err(torch, got, want):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    return err, want.abs().max().item()


# --------------------------------------------------------------------------
# Configuration and synthetic weights
# --------------------------------------------------------------------------


def nvila_8b_config(layers=28):
    """NVILA-8B shape (bench.py:30-48): Qwen2-7B LLM, W4A16, untied
    lm_head; SigLIP-SO400M-448; mlp_downsample projector; bf16."""
    from vila_tpu_torch.models import projector, qwen2, siglip, vlm

    llm = qwen2.LLMConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=layers, num_attention_heads=28,
        num_key_value_heads=4, rope_theta=1e6, tie_word_embeddings=False,
        dtype="bfloat16",
    )
    vis = siglip.SigLIPConfig(dtype="bfloat16")
    proj = projector.ProjectorConfig(
        projector_type="mlp_downsample", mm_hidden_size=1152,
        hidden_size=3584, dtype="bfloat16",
    )
    return vlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def synth_w4_slot(torch, gen, lead, din, dout, bout_budget=None):
    """Random W4 slot straight in the tiled layout (as bench.py:60-72):
    uniform nibbles, per-group scales drawn around 2e-3; the group is the
    quantizer's (`quant.group_for`: 128 at the NVILA widths, 112 where D =
    896)."""
    from vila_tpu_torch.ops import quant

    bout = quant.pick_bout(din, dout, budget=bout_budget or quant._BLOCK_BUDGET)
    nj = dout // bout
    ngh = din // 2 // quant.group_for(din // 2)
    s_rows = quant.scale_rows(ngh)
    dev = gen.device
    packed = torch.randint(0, 256, lead + (nj, din // 2, bout), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.uint8)
    scales = torch.zeros(lead + (nj, s_rows, bout), device=dev, dtype=torch.bfloat16)
    scales[..., : 2 * ngh, :] = (
        0.002 * (0.5 + torch.rand(lead + (nj, 2 * ngh, bout), generator=gen, device=dev))
    ).to(torch.bfloat16)
    return {"packed": packed, "scales": scales}


def qwen2_0_5b_config(layers=24):
    """Qwen2-0.5B's published widths (Qwen/Qwen2-0.5B config.json: hidden
    896, intermediate 4864, 24 layers, 14 query and 2 KV heads of 64, vocab
    151936, tied embeddings), W4A16, bf16: the widths where the quantizer
    takes groups of 112 (D / 2 = 448)."""
    from vila_tpu_torch.models import qwen2

    return qwen2.LLMConfig(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_hidden_layers=layers, num_attention_heads=14, num_key_value_heads=2,
        rope_theta=1e6, tie_word_embeddings=True, dtype="bfloat16",
    )


# (D, I, head_dim, q heads, kv heads, vocab) of the two serving widths
DIMS_8B = (3584, 18944, 128, 28, 4, 152064)
DIMS_0_5B = (896, 4864, 64, 14, 2, 151936)


def synth_llm_params(torch, llm, gen, device):
    """W4 LLM params at `llm`'s widths on `device`: slots in the fused,
    GQA-padded layout of `quantize_llm_params(fuse=True, cfg=...)`."""
    L, D, I = llm.num_hidden_layers, llm.hidden_size, llm.intermediate_size
    hd, Hq, Hkv = llm.head_dim_, llm.num_attention_heads, llm.num_key_value_heads
    pad = ((Hq // Hkv + 7) // 8) * 8
    bf16 = torch.bfloat16
    qkv = synth_w4_slot(torch, gen, (L,), D, (Hq + 2 * Hkv) * hd)
    qkv["bias"] = (0.02 * torch.randn((L, (Hq + 2 * Hkv) * hd), generator=gen,
                                      device=device)).to(bf16)
    llm_params = {
        "embed_tokens": {"embedding": (0.02 * torch.randn(
            (llm.vocab_size, D), generator=gen, device=device)).to(bf16)},
        "layers": {
            "input_layernorm": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "qkv_proj": qkv,
            "o_proj": synth_w4_slot(torch, gen, (L,), Hkv * pad * hd, D),
            "post_attention_layernorm": {"scale": torch.ones((L, D), dtype=bf16, device=device)},
            "gate_up_proj": synth_w4_slot(torch, gen, (L,), D, 2 * I),
            "down_proj": synth_w4_slot(torch, gen, (L,), I, D, bout_budget=5 << 20),
        },
        "norm": {"scale": torch.ones((D,), dtype=bf16, device=device)},
    }
    if not llm.tie_word_embeddings:
        llm_params["lm_head"] = synth_w4_slot(torch, gen, (), D, llm.vocab_size)
    return llm_params


def synth_params(torch, cfg, seed, device):
    """Full-width VLM params on `device`: W4 LLM slots in the fused,
    GQA-padded layout of `quantize_llm_params(fuse=True, cfg=...)`, bf16
    vision tower and projector."""
    from vila_tpu_torch.models import projector, siglip

    gen = torch.Generator(device=device).manual_seed(seed)
    llm_params = synth_llm_params(torch, cfg.llm, gen, device)
    bf16 = torch.bfloat16
    return {
        "llm": llm_params,
        "vision_tower": siglip.init_params(gen, cfg.vision, bf16),
        "mm_projector": projector.init_params(gen, cfg.projector, bf16),
    }


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------


def phase_build():
    from vila_tpu_torch.ops import _build

    t0 = time.time()
    reports = _build.build_all()
    secs = time.time() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.txt"), "w") as f:
        for src, rep in reports.items():
            f.write(f"==== {src}\n{rep}\n")
    log(f"[build] {len(reports)} sources compiled in {secs:.1f} s "
        f"(ptxas report: {OUT_DIR}/ptxas.txt)")
    # the Hopper kernels' registers, spills and shared memory (K7-K9, K6, K2, K3, K4/K5, K1)
    for src in ("flash_attn_sm90.cu", "w4_gemv_mma.cu", "decode_attn.cu",
                "w4_gemm_sm90.cu", "decode_layer_sm90.cu", "w4_pair_sm90.cu",
                "w4_gemv_sm90.cu"):
        lines = reports.get(src, "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line:
                log("[build] " + line.strip())
                for follow in lines[i + 1:i + 5]:
                    if any(w in follow for w in ("registers", "spill", "stack frame")):
                        log("[build]   " + follow.strip())
        for line in lines:  # e.g. wgmma serialization (C7510, C7515)
            if "warning" in line.lower():
                log(f"[build] {src}: " + line.strip()[:200])
    return secs


def phase_kernels(torch, seed, dev="cuda", dims=DIMS_8B, m_prefill=320, cache=(2048, 1300)):
    """Each kernel against its plain version at the 8B main-path shapes
    (`dims` = D, I, head_dim, q heads, kv heads, vocab)."""
    from vila_tpu_torch.ops import fused_decode, quant

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    D, I, hd, Hq, Hkv, V = dims
    shapes = {  # name: (din, dout, bout budget)
        "qkv": (D, (Hq + 2 * Hkv) * hd, None),
        "o": (Hkv * 8 * hd, D, None),
        "gate_up": (D, 2 * I, None),
        "down": (I, D, 5 << 20),
        "lm_head": (D, V, None),
    }
    results = {name: [] for name in KERNELS}
    slots = {}
    ok = True
    for name, (din, dout, budget) in shapes.items():
        lead = () if name == "lm_head" else (2,)
        w = 0.02 * torch.randn(lead + (din, dout), generator=gen, device=dev)
        bout = quant.pick_bout(din, dout, budget) if budget else None
        q = quant.quantize_w4(w, bout=bout)
        del w
        packed, scales = q["packed"], q["scales"]
        slots[name] = {"packed": packed, "scales": scales}
        li = None if name == "lm_head" else 1
        w_l = quant.dequantize({"packed": packed[li] if li is not None else packed,
                                "scales": scales[li] if li is not None else scales})
        for m in ((1, 8, m_prefill) if name != "lm_head" else (1, 8)):
            x = (torch.randn((m, din), generator=gen, device=dev)).to(torch.bfloat16)
            kern = "w4_gemv" if m <= 32 else "w4_gemm"
            if kern == "w4_gemv":
                fn = lambda: quant.w4_matmul_decode(x, packed, scales, layer_index=li)
                ref = lambda: quant._w4_gemv_ref(x, packed, scales, li)
                ops, rate = 2 * 2 * m * din * dout, INT8_OPS
            else:
                fn = lambda: quant.w4_matmul_prefill(x, packed, scales, layer_index=li)
                ref = lambda: quant._w4_gemm_ref(x, packed, scales, li)
                ops, rate = 2 * m * din * dout, BF16_FLOPS
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err, scale = rel_err(torch, got, want)
            tol = 2.0 ** -7 * scale  # one bf16 ulp of the largest output
            good = bool(torch.isfinite(got.float()).all()) and err <= tol
            ok &= good
            t = time_ms(torch, fn, 30, flush)
            t_plain = time_ms(torch, ref, 5, flush)
            t_lib = time_ms(torch, lambda: x @ quant.dequantize(
                {"packed": packed[li] if li is not None else packed,
                 "scales": scales[li] if li is not None else scales}), 5, flush)
            t_bf16 = time_ms(torch, lambda: x @ w_l, 30, flush)
            b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout) + m * dout * 2, ops, rate)
            rec = dict(shape=name, m=m, din=din, dout=dout, max_abs_err=err,
                       tol=tol, ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=t_lib, bf16_matmul_ms=t_bf16)
            results[kern].append(rec)
            log(f"[kernels] {kern:8s} {name:8s} M={m:<4d} err {err:.3e} "
                f"(tol {tol:.3e}) {'OK' if good else 'FAIL'}  "
                f"kernel {t:.4f} ms  plain {t_plain:.3f} ms  "
                f"dequant+matmul {t_lib:.3f} ms  bf16 matmul {t_bf16:.4f} ms  "
                f"bound {b_ms:.4f} ms ({b_by})")
            if kern == "w4_gemm":  # X1: K2's ring and products alone, over w_l
                dots = lambda: quant.bf16_matmul_dots(x, w_l)  # noqa: E731
                got_d = dots()
                torch.cuda.synchronize()
                err_d, _ = rel_err(torch, got_d, want)
                good_d = bool(torch.isfinite(got_d.float()).all()) and err_d <= tol
                ok &= good_d
                t_d = time_ms(torch, dots, 30, flush)
                t_dp = time_ms(torch, lambda: (x.float() @ w_l.float()).to(torch.bfloat16),
                               5, flush)
                bd_ms, bd_by = bound(m * din * 2 + din * dout * 2 + m * dout * 2,
                                     2 * m * din * dout, BF16_FLOPS)
                results["w4_gemm_dots"].append(dict(
                    shape=name, m=m, din=din, dout=dout, max_abs_err=err_d, tol=tol,
                    ok=good_d, ms=t_d, plain_ms=t_dp, bound_ms=bd_ms, bound_by=bd_by,
                    library_ms=t_bf16, bf16_matmul_ms=t_bf16))
                log(f"[kernels] w4_gemm_dots {name:8s} M={m:<4d} err {err_d:.3e} "
                    f"(tol {tol:.3e}) {'OK' if good_d else 'FAIL'}  kernel {t_d:.4f} ms  "
                    f"W4 - dots {t - t_d:.4f} ms  bf16 matmul {t_bf16:.4f} ms  "
                    f"bound {bd_ms:.4f} ms ({bd_by})")
        del w_l

    # K3: one decode layer at cache 2048, fill 1300 (live prefix 1301 rows)
    S, fill = cache
    kv_ld = Hkv * hd
    kc = (0.5 * torch.randn((2, 1, S, kv_ld), generator=gen, device=dev)).to(torch.bfloat16)
    vc = torch.randn((2, 1, S, kv_ld), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.full((1, S), -1e30, device=dev)
    mask[:, : fill + 1] = 0.0
    q32 = (hd ** -0.5 * torch.randn((Hkv, 8, hd), generator=gen, device=dev))
    q32[:, Hq // Hkv:] = 0.0
    q32 = q32.reshape(Hkv * 8, hd).to(torch.bfloat16)
    h = torch.randn((1, D), generator=gen, device=dev).to(torch.bfloat16).expand(8, D)
    gpost = 1.0 + 0.1 * torch.randn((2, D), generator=gen, device=dev)
    gin = 1.0 + 0.1 * torch.randn((2, D), generator=gen, device=dev)
    qkv_slot = dict(slots["qkv"])
    qkv_slot["bias"] = 0.02 * torch.randn((2, (Hq + 2 * Hkv) * hd), generator=gen, device=dev)
    args = (q32, mask, h, 0, kc, vc, slots["o"], slots["gate_up"], slots["down"],
            qkv_slot, gpost, gin)
    ok &= _run_k3(torch, fused_decode, results, args, fill, flush, dims)
    if dims == DIMS_8B:
        ok &= _check_media_shapes(torch, quant, fused_decode, results, slots, args, seed,
                                  flush, dims)
    layer_w = (w4_bytes(Hkv * 8 * hd, D) + w4_bytes(D, 2 * I) + w4_bytes(I, D)
               + w4_bytes(D, (Hq + 2 * Hkv) * hd))
    layer_macs = Hkv * 8 * hd * D + D * 2 * I + I * D + D * (Hq + 2 * Hkv) * hd
    ok &= _check_gemm_plans(torch, quant, slots, seed, flush)
    ok &= _check_rows(torch, quant, results, slots, seed, flush, dims)
    ok &= _check_k6(torch, quant, fused_decode, results, slots, qkv_slot, gpost, gin,
                    gen, flush, dims, S, layer_w, layer_macs)
    ok &= _check_k4_k5(torch, quant, fused_decode, results, slots, qkv_slot, gpost,
                       gin, gen, flush, dims)
    if dims == DIMS_8B:
        good, k1 = phase_k1(torch, seed, dev)
        ok &= good
        results.update(k1)
        good, results["k1_forms"] = _check_k1_forms(torch, quant, seed, flush)
        ok &= good
        ok &= _check_small(torch, quant, fused_decode, results, seed, flush)
        ok &= _check_small(torch, quant, fused_decode, results, seed, flush, group=64)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return ok, results


# The media phases' new shapes: K2 at the prompt buckets of a dynamic-S2
# image (1452 media tokens -> 1536) and of a 64-frame TSP video (≈ 4.1k ->
# 8192); K3 over the video's cache (8192 rows, ≈ 4.1k live)
MEDIA_PREFILL = ((1536, "s2"), (8192, "video"))
MEDIA_CACHE = (8192, 4141)


def _check_media_shapes(torch, quant, fused_decode, results, slots, k3_args, seed, flush,
                        dims):
    """K2 over one layer's four projections at M = 1536 and 8192 against
    the plain version (one bf16 ulp of the largest output), timed beside
    its bound, the plain version and `dequantize` + `torch.matmul`; K3 at
    cache 8192 / fill 4141 (65 attention chunks a KV head: each CTA loops
    over several units) against its plain version. Inputs from a generator
    of their own; the weights are the `kernels` phase's."""
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    D, I, hd, Hq, Hkv, V = dims
    shapes = {"qkv": (D, (Hq + 2 * Hkv) * hd), "o": (Hkv * 8 * hd, D),
              "gate_up": (D, 2 * I), "down": (I, D)}
    ok = True
    for m, path in MEDIA_PREFILL:
        for name, (din, dout) in shapes.items():
            packed, scales = slots[name]["packed"], slots[name]["scales"]
            x = torch.randn((m, din), generator=gen, device=dev).to(torch.bfloat16)
            fn = lambda: quant.w4_matmul_prefill(x, packed, scales, layer_index=1)  # noqa: E731
            ref = lambda: quant._w4_gemm_ref(x, packed, scales, 1)  # noqa: E731
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err, scale = rel_err(torch, got, want)
            tol = 2.0 ** -7 * scale
            good = bool(torch.isfinite(got.float()).all()) and err <= tol
            ok &= good
            del got, want
            t = time_ms(torch, fn, 10, flush)
            t_plain = time_ms(torch, ref, 3, flush)
            t_lib = time_ms(torch, lambda: x @ quant.dequantize(
                {"packed": packed[1], "scales": scales[1]}), 3, flush)
            b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout) + m * dout * 2,
                               2 * m * din * dout, BF16_FLOPS)
            plan = (quant.gemm_plan(m, dout, din // 2, quant._device_state(dev)[0])
                    if dev.type == "cuda" else "-")
            results["w4_gemm"].append(dict(
                shape=name, m=m, din=din, dout=dout, max_abs_err=err, tol=tol, ok=good,
                ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
                media=path, plan=str(plan)))
            log(f"[kernels] w4_gemm {path} {name:8s} M={m:<5d} plan {plan} err {err:.3e} "
                f"(tol {tol:.3e}) {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  plain "
                f"{t_plain:.3f} ms  dequant+matmul {t_lib:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
            del x
    S, fill = MEDIA_CACHE
    kv_ld = Hkv * hd
    kc = (0.5 * torch.randn((2, 1, S, kv_ld), generator=gen, device=dev)).to(torch.bfloat16)
    vc = torch.randn((2, 1, S, kv_ld), generator=gen, device=dev).to(torch.bfloat16)
    mask = torch.full((1, S), -1e30, device=dev)
    mask[:, : fill + 1] = 0.0
    q32 = hd ** -0.5 * torch.randn((Hkv, 8, hd), generator=gen, device=dev)
    q32[:, Hq // Hkv:] = 0.0
    q32 = q32.reshape(Hkv * 8, hd).to(torch.bfloat16)
    args = (q32, mask) + tuple(k3_args[2:4]) + (kc, vc) + tuple(k3_args[6:])
    if dev.type == "cuda":
        nsplit = fused_decode.attn_plan(fill + 1, Hkv, quant._device_state(dev)[0])
        log(f"[kernels] fused_layer video: attention plan at fill {fill}: {nsplit}")
    ok &= _run_k3(torch, fused_decode, results, args, fill, flush, dims, media="video")
    return ok


def _run_k3(torch, fused_decode, results, args, fill, flush, dims, model="NVILA-8B",
            media=None):
    """K3 (one bs=1 layer) on prepared inputs against its plain version,
    within 1e-2 x max|ref| (the one launch read 0.35 % on h and 0.71 % on
    qkv at NVILA-8B; NVIDIA H100 80GB HBM3, 700.00 W); timed beside its bound
    and, at NVILA-8B, its stage times from inside the launch."""
    D, I, hd, Hq, Hkv, V = dims
    q32, mask, h, _, kc, vc = args[:6]
    kv_ld, S = Hkv * hd, kc.shape[2]
    kw = dict(hkv=Hkv, hd=hd, eps=1e-6, fill=fill, num_q_heads=Hq)
    fn = lambda: fused_decode.fused_layer(*args, **kw)  # noqa: E731
    ref = lambda: fused_decode._fused_layer_ref(*args, **kw)  # noqa: E731
    (h_k, qkv_k), (h_r, qkv_r) = fn(), ref()
    torch.cuda.synchronize()
    err_h, sc_h = rel_err(torch, h_k[0], h_r[0])
    err_q, sc_q = rel_err(torch, qkv_k[0], qkv_r[0])
    good = (err_h <= 1e-2 * sc_h and err_q <= 1e-2 * sc_q
            and bool(torch.isfinite(qkv_k.float()).all()))
    t = time_ms(torch, fn, 30, flush)
    t_plain = time_ms(torch, ref, 5, flush)
    n_rows = fill + 1
    dq = (Hq + 2 * Hkv) * hd
    byts = (w4_bytes(Hkv * 8 * hd, D) + w4_bytes(D, 2 * I) + w4_bytes(I, D)
            + w4_bytes(D, dq) + 2 * n_rows * kv_ld * 2
            + n_rows * 4 + q32.numel() * 2 + 4 * D * 2 + dq * 4 + D * 2)
    ops = 2 * 2 * (Hkv * 8 * hd * D + D * 2 * I + I * D + D * dq)
    b_ms, b_by = bound(byts, ops, INT8_OPS)
    results["fused_layer"].append(dict(
        model=model, shape=f"decode layer, cache {S}, fill {fill}", m=1,
        max_abs_err=max(err_h, err_q),
        tol=f"1e-2 x max|ref| (h {1e-2 * sc_h:.3e}, qkv {1e-2 * sc_q:.3e})",
        ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
        **({"media": media} if media else {})))
    log(f"[kernels] fused_layer {model}{' ' + media if media else ''} cache {S} fill {fill} h err {err_h:.3e} (max {sc_h:.3e}) qkv err "
        f"{err_q:.3e} (max {sc_q:.3e}) {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  "
        f"plain {t_plain:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
    if flush.device.type == "cuda" and model == "NVILA-8B":
        results["fused_layer"][-1]["stages_ms"] = stages = _layer_stamps(
            torch, fused_decode, args, kw, flush)
        log("[kernels] fused_layer stages inside the launch (ms, median of 20, "
            "%globaltimer of CTA 0): " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()))
    return good


K1_LM_ROWS = (1, 2, 8, 16, 17, 24, 32)  # the lm_head: bs=1, the batched routes, short prompts
K1_QKV_ROWS = (1, 8, 24)


def bf16_ulps(torch, got, want):
    """The largest difference in bf16 ulps of the largest reference value
    (2^(e - 7) for max|want| in [2^e, 2^(e+1))): the unit of the check's
    tolerance, 2^-7 max|want|, rounded down to a power of two."""
    w = want.float()
    e = math.floor(math.log2(max(float(w.abs().max()), 2.0 ** -126)))
    return float((got.float() - w).abs().max()) / 2.0 ** (e - 7)


def phase_k1(torch, seed, dev="cuda", reps=30, dims=DIMS_8B):
    """K1 through its public wrapper only (`quant.w4_matmul_decode`), so the
    same phase also times an earlier tree's K1 in an old-against-new call:
    the NVILA-8B lm_head at M = 1, 2, 8, 16, 17, 24 and 32 and layer 1 of a
    stacked qkv at M = 1, 8 and 24, each against `quant._w4_gemv_ref` on
    the card within 2^-7 max|ref| (one bf16 ulp of the largest output; the
    largest difference is reported in those ulps), timed beside cuBLAS
    bf16 `x @ w` over the weights dequantised once; the plain version
    and dequantize + matmul at the batched routes' M = 8 and 24; one
    layer's four projections at M = 24 (a short prompt's prefill) on K1; the
    host's wall time of one call (the qkv at M = 1). On a generator of its
    own."""
    from vila_tpu_torch.ops import quant

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    D, I, hd, Hq, Hkv, V = dims
    shapes = {"lm_head": (D, V, None, ()), "qkv": (D, (Hq + 2 * Hkv) * hd, None, (2,)),
              "o": (Hkv * 8 * hd, D, None, (2,)), "gate_up": (D, 2 * I, None, (2,)),
              "down": (I, D, 5 << 20, (2,))}
    rows = {"lm_head": K1_LM_ROWS, "qkv": K1_QKV_ROWS, "o": (24,), "gate_up": (24,),
            "down": (24,)}
    recs, ok, layer, slots = [], True, [], {}
    for name, (din, dout, budget, lead) in shapes.items():
        slot = slots[name] = synth_w4_slot(torch, gen, lead, din, dout, budget)
        packed, scales = slot["packed"], slot["scales"]
        li = 1 if lead else None
        w_l = quant.dequantize({"packed": packed[li] if lead else packed,
                                "scales": scales[li] if lead else scales})
        group = quant._tiled_meta(packed, scales)[4]
        for m in rows[name]:
            x = torch.randn((m, din), generator=gen, device=dev).to(torch.bfloat16)
            fn = lambda: quant.w4_matmul_decode(x, packed, scales, layer_index=li)  # noqa: E731
            ref = lambda: quant._w4_gemv_ref(x, packed, scales, li)  # noqa: E731
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err, scale = rel_err(torch, got, want)
            tol = 2.0 ** -7 * scale
            good = bool(torch.isfinite(got.float()).all()) and err <= tol
            ok &= good
            t = time_ms(torch, fn, reps, flush)
            t_bf16 = time_ms(torch, lambda: x @ w_l, reps, flush)
            b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout, group) + m * dout * 2,
                               2 * 2 * m * din * dout, INT8_OPS)
            rec = dict(shape=name, m=m, din=din, dout=dout, max_abs_err=err, tol=tol,
                       max_ulps=bf16_ulps(torch, got, want), ok=good, ms=t, bound_ms=b_ms,
                       bound_by=b_by, bf16_matmul_ms=t_bf16, plain_ms=None,
                       library_ms=None)
            if name == "lm_head" and m in (8, 24):
                rec["plain_ms"] = time_ms(torch, ref, 5, flush)
                rec["library_ms"] = time_ms(torch, lambda: x @ quant.dequantize(
                    {"packed": packed, "scales": scales}), 5, flush)
            if m == 24 and name != "lm_head":
                layer.append(fn)
            recs.append(rec)
            log(f"[k1] {name:8s} M={m:<3d} err {err:.3e} (tol {tol:.3e}; "
                f"{rec['max_ulps']:.2f} bf16 ulps of max|ref|) {'OK' if good else 'FAIL'}  kernel "
                f"{t:.4f} ms  bf16 matmul {t_bf16:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        del w_l
    t_layer = time_ms(torch, lambda: [f() for f in layer], reps, flush)
    log(f"[k1] one layer's four projections (qkv, o, gate_up, down) at M=24: {t_layer:.4f} ms")
    # the host's side of a launch: wall time of the wrapper (output
    # allocation, checks, the launch itself), the card kept busy meanwhile
    x = torch.randn((1, D), generator=gen, device=dev).to(torch.bfloat16)
    qkv = slots["qkv"]
    for _ in range(20):
        quant.w4_matmul_decode(x, qkv["packed"], qkv["scales"], layer_index=1)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(200):
        quant.w4_matmul_decode(x, qkv["packed"], qkv["scales"], layer_index=1)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    log(f"[k1] host time of one K1 call (stacked slot, M=1): {host_us:.1f} us")
    return ok, dict(k1=recs, k1_layer_m24_ms=t_layer, k1_host_us=host_us)


def _check_k1_forms(torch, quant, seed, flush, dims=DIMS_8B):
    """What only this K1 has: the wgmma form's digits and lo-plane group
    sums bit for bit against `_w4_digits_ref` run on the CPU (on the card
    PyTorch divides by a scalar through its reciprocal), and a repeat
    launch of each form bit for bit; the probe: the
    NVILA-8B lm_head slab's byte sum through the stream ring's 128- and
    256-byte boxes and through plain 16-byte loads, each equal to the sum
    on the card, timed (GB/s over the 272 MB slab)."""
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    D, I, hd, Hq, Hkv, V = dims
    lm = synth_w4_slot(torch, gen, (), D, V)
    qkv = synth_w4_slot(torch, gen, (2,), D, (Hq + 2 * Hkv) * hd)
    ok, recs = True, []
    for name, slot, li, m in (("lm_head", lm, None, 24), ("qkv", qkv, 1, 8),
                              ("lm_head", lm, None, 1)):
        x = torch.randn((m, D), generator=gen, device=dev).to(torch.bfloat16)
        out = quant.w4_matmul_decode(x, slot["packed"], slot["scales"], layer_index=li)
        again = quant.w4_matmul_decode(x, slot["packed"], slot["scales"], layer_index=li)
        torch.cuda.synchronize()
        repeat = torch.equal(out, again)
        digits = None
        if m > 1:
            got = [t.cpu() for t in quant.k1_digits(dev)]
            group = quant._tiled_meta(slot["packed"], slot["scales"])[4]
            want = quant._w4_digits_ref(x.cpu(), group=group)
            digits = torch.equal(got[0], want[0]) and torch.equal(got[1], want[2])
        good = repeat and digits is not False
        ok &= good
        recs.append(dict(shape=name, m=m, repeat_bit_exact=repeat, digits_bit_exact=digits,
                         ok=good))
        form = quant.k1_form(m, D)
        log(f"[kernels] w4_gemv {name:8s} M={m:<3d} {form} form: "
            f"repeat launch bit-exact {repeat}"
            + ("" if digits is None else f", digits and group sums bit-exact {digits}")
            + f" {'OK' if good else 'FAIL'}")
    packed = lm["packed"]
    total = int(packed.sum(dtype=torch.int64))
    nbytes = packed.numel()
    for mode in (128, 256, "v4"):
        fn = lambda: quant.launch_probe(packed, mode)  # noqa: E731
        got = int(fn().to(torch.int64).remainder(1 << 32).sum())
        good = got == total
        ok &= good
        t = time_ms(torch, fn, 30, flush)
        recs.append(dict(probe=str(mode), ms=t, gb_per_s=nbytes / t / 1e6, bytes=nbytes,
                         sum_ok=good, ok=good))
        log(f"[kernels] K1 probe ({mode}{'-byte boxes' if mode != 'v4' else ' loads'}): "
            f"{nbytes / 1e6:.1f} MB in {t:.4f} ms = {nbytes / t / 1e6:.1f} GB/s, byte sum "
            f"{'OK' if good else 'FAIL'}")
    del lm, qkv
    return ok, recs


def _small_slots(torch, quant, gen, dims, group=None):
    """Two layers of W4 slots at `dims` (D, I, hd, Hq, Hkv, V), quantised
    with the quantizer's groups (`quantize_llm_params`: 112 where D = 896),
    or with `group` everywhere."""
    D, I, hd, Hq, Hkv, V = dims
    shapes = {"qkv": (D, (Hq + 2 * Hkv) * hd, None), "o": (Hkv * 8 * hd, D, None),
              "gate_up": (D, 2 * I, None), "down": (I, D, 5 << 20)}
    slots = {}
    for name, (din, dout, budget) in shapes.items():
        w = 0.02 * torch.randn((2, din, dout), generator=gen, device=gen.device)
        bout = quant.pick_bout(din, dout, budget) if budget else None
        q = quant.quantize_w4(w, group or quant.group_for(din // 2), bout=bout)
        slots[name] = {"packed": q["packed"], "scales": q["scales"]}
    return slots


def _check_small(torch, quant, fused_decode, results, seed, flush, dims=DIMS_0_5B,
                 m_prefill=320, cache=(2048, 1300), group=None):
    """K1-K6 at Qwen2-0.5B widths (head dim 64; D = 896, so the D-input
    products take groups of 112), on a generator of their own, with the
    NVILA-8B checks' tolerances: K1 the layer-0 qkv at M = 1 and the four
    projections at M = 24 (its two forms) and K2 one layer's four
    projections at M = 320 within one bf16 ulp of the largest output, K3
    at cache 2048 / fill 1300 and K4/K5 at M = 24 within 1e-2 x max|ref|,
    K6 at B = 8 within 2e-2 x max|ref|. With `group` (64: the
    kernels' paths for groups padded to less than 128 rows) every product
    takes that group."""
    D, I, hd, Hq, Hkv, V = dims
    dev, bf16 = flush.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 3 + (group or 0))
    slots = _small_slots(torch, quant, gen, dims, group)
    groups = {n: quant._tiled_meta(s["packed"], s["scales"])[4] for n, s in slots.items()}
    model = "Qwen2-0.5B" if group is None else f"Qwen2-0.5B, group {group}"
    log(f"[kernels] Qwen2-0.5B widths: groups {groups}, head dim {hd}")
    ok = True
    # K1: layer 0's qkv at M = 1 (the stream form), the four projections at
    # M = 24 (the wgmma form); K2: the four projections at M = 320
    for kern, m, names in (("w4_gemv", 1, ("qkv",)),
                           ("w4_gemv", 24, ("qkv", "o", "gate_up", "down")),
                           ("w4_gemm", m_prefill, ("qkv", "o", "gate_up", "down"))):
        for name in names:
            slot = slots[name]
            din = slot["packed"].shape[-2] * 2
            dout = slot["packed"].shape[-3] * slot["packed"].shape[-1]
            x = torch.randn((m, din), generator=gen, device=dev).to(bf16)
            if kern == "w4_gemv":
                fn = lambda: quant.w4_matmul_decode(  # noqa: E731
                    x, slot["packed"], slot["scales"], layer_index=0)
                ref = lambda: quant._w4_gemv_ref(x, slot["packed"], slot["scales"], 0)  # noqa: E731
                ops, rate = 2 * 2 * m * din * dout, INT8_OPS
            else:
                fn = lambda: quant.w4_matmul_prefill(  # noqa: E731
                    x, slot["packed"], slot["scales"], layer_index=0)
                ref = lambda: quant._w4_gemm_ref(x, slot["packed"], slot["scales"], 0)  # noqa: E731
                ops, rate = 2 * m * din * dout, BF16_FLOPS
            got, want = fn(), ref()
            torch.cuda.synchronize()
            err, scale = rel_err(torch, got, want)
            tol = 2.0 ** -7 * scale
            good = bool(torch.isfinite(got.float()).all()) and err <= tol
            ok &= good
            t = time_ms(torch, fn, 30, flush)
            t_plain = time_ms(torch, ref, 5, flush)
            b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout, groups[name])
                               + m * dout * 2, ops, rate)
            results[kern].append(dict(
                model=model, shape=name, m=m, din=din, dout=dout,
                group=groups[name], max_abs_err=err, tol=tol, ok=good, ms=t,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))
            log(f"[kernels] {kern:8s} {model} {name:8s} M={m:<4d} group "
                f"{groups[name]} err {err:.3e} (tol {tol:.3e}) {'OK' if good else 'FAIL'}  "
                f"kernel {t:.4f} ms  plain {t_plain:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
    # K3: one bs=1 layer at cache 2048 / fill 1300
    S, fill = cache
    kv_ld = Hkv * hd
    kc = (0.5 * torch.randn((2, 1, S, kv_ld), generator=gen, device=dev)).to(bf16)
    vc = torch.randn((2, 1, S, kv_ld), generator=gen, device=dev).to(bf16)
    mask = torch.full((1, S), -1e30, device=dev)
    mask[:, : fill + 1] = 0.0
    q32 = hd ** -0.5 * torch.randn((Hkv, 8, hd), generator=gen, device=dev)
    q32[:, Hq // Hkv:] = 0.0
    q32 = q32.reshape(Hkv * 8, hd).to(bf16)
    h = torch.randn((1, D), generator=gen, device=dev).to(bf16).expand(8, D)
    gpost = 1.0 + 0.1 * torch.randn((2, D), generator=gen, device=dev)
    gin = 1.0 + 0.1 * torch.randn((2, D), generator=gen, device=dev)
    qkv_slot = dict(slots["qkv"])
    qkv_slot["bias"] = 0.02 * torch.randn((2, (Hq + 2 * Hkv) * hd), generator=gen, device=dev)
    args = (q32, mask, h, 0, kc, vc, slots["o"], slots["gate_up"], slots["down"],
            qkv_slot, gpost, gin)
    ok &= _run_k3(torch, fused_decode, results, args, fill, flush, dims, model=model)
    del kc, vc
    layer_w = (w4_bytes(Hkv * 8 * hd, D) + w4_bytes(D, 2 * I, groups["gate_up"])
               + w4_bytes(I, D) + w4_bytes(D, (Hq + 2 * Hkv) * hd, groups["qkv"]))
    layer_macs = Hkv * 8 * hd * D + D * 2 * I + I * D + D * (Hq + 2 * Hkv) * hd
    ok &= _check_k6(torch, quant, fused_decode, results, slots, qkv_slot, gpost, gin, gen,
                    flush, dims, S, layer_w, layer_macs, batches=(8,), model=model)
    ok &= _check_k4_k5(torch, quant, fused_decode, results, slots, qkv_slot, gpost, gin,
                       gen, flush, dims, rows=(24,), model=model)
    return ok


def _check_gemm_plans(torch, quant, slots, seed, flush, rows=(33, 200, 1024)):
    """K2 and its products alone on layer 1's qkv at the other tile plans
    (one warpgroup's slices, two, and three M tiles), on inputs from a
    generator of their own, against the plain version with the main
    shape's tolerance (one bf16 ulp of the largest output)."""
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    slot = slots["qkv"]
    w_l = quant.dequantize({"packed": slot["packed"][1], "scales": slot["scales"][1]})
    ok = True
    for m in rows:
        x = torch.randn((m, w_l.shape[0]), generator=gen, device=dev).to(torch.bfloat16)
        want = quant._w4_gemm_ref(x, slot["packed"], slot["scales"], 1)
        got = quant.w4_matmul_prefill(x, slot["packed"], slot["scales"], layer_index=1)
        got_d = quant.bf16_matmul_dots(x, w_l)
        torch.cuda.synchronize()
        tol = 2.0 ** -7 * float(want.float().abs().max())
        errs = [rel_err(torch, g, want)[0] for g in (got, got_d)]
        good = all(e <= tol for e in errs) and bool(torch.isfinite(got.float()).all())
        ok &= good
        plan = (quant.gemm_plan(m, w_l.shape[1], w_l.shape[0] // 2,
                                quant._device_state(dev)[0]) if dev.type == "cuda" else "-")
        log(f"[kernels] w4_gemm / w4_gemm_dots qkv M={m:<4d} plan {plan} err "
            f"{errs[0]:.3e} / {errs[1]:.3e} (tol {tol:.3e}) {'OK' if good else 'FAIL'}")
    return ok


def _check_rows(torch, quant, results, slots, seed, flush, dims, rows=(2, 8, 16, 24)):
    """K6's two GEMV kernels on their own, on inputs from a generator of
    their own (K6's and K4/K5's checks draw what they drew before these
    kernels existed). `w4_digits` for each prologue: its digits, scales and
    group sums bit for bit against the plain version run on the CPU over
    the kernel's own prologue values (`value_out`), and those values bit
    for bit against the plain prologue on the CPU (none, RMS, SiLU: the
    definition of `csrc/w4_common.cuh`, which takes the sum of squares, the
    square root and exp in f64 so that no sum order shows).
    `w4_gemv_rows` on the four products of layer 1 at M = 2, 8, 16 and 24
    (24 is not routed: K6 takes B <= 16), over the kernel's own digits: its
    f32 output against the plain version's per element within 2^-10 |want|
    + 2^-14 max|want| (the two differ only in the order of f32 sums), its
    bf16 output that f32 output rounded; timed with its digit pass at M = 8
    and 16."""
    D, I, hd, Hq, Hkv, V = dims
    dev, bf16 = flush.device, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    shapes = {"o": (Hkv * 8 * hd, D), "gate_up": (D, 2 * I), "down": (I, D),
              "qkv": (D, (Hq + 2 * Hkv) * hd)}
    gamma = (1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)).to(bf16)
    results["w4_digits"], results["w4_gemv_rows"] = [], []
    ok = True
    for m in rows:
        cases = {
            "none": (torch.randn((m, I), generator=gen, device=dev).to(bf16),
                     quant.PRO_NONE, None, I),
            "rms": (4 * torch.randn((m, D), generator=gen, device=dev), quant.PRO_RMS,
                    gamma, D),
            "silu": (torch.randn((m, 2 * I), generator=gen, device=dev).to(bf16),
                     quant.PRO_SILU, None, I),
        }
        for tag, (x, pro, g, din) in cases.items():
            value = torch.empty((m, din), dtype=bf16, device=dev)
            got = quant.launch_digits(x, m=m, prologue=pro, gamma=g, eps=1e-6,
                                      value_out=value)
            torch.cuda.synchronize()
            got, v_k = [t.cpu() for t in got], value.cpu().float()
            # the plain versions on the CPU: on the card PyTorch divides by a
            # scalar through its reciprocal, which is not the IEEE quotient
            # that quant._digits (and JAX's _int8_digits) take
            want = quant._w4_digits_ref(value.cpu(), quant.PRO_NONE)
            exact = all(torch.equal(a, b) for a, b in zip(got, want))
            v = quant._prologue_ref(x.cpu(), pro, None if g is None else g.cpu(), 1e-6)
            same = float((v_k == v).float().mean())
            equal = torch.equal(v_k, v)
            good = exact and equal
            ok &= good
            results["w4_digits"].append(dict(
                prologue=tag, m=m, digits_bit_exact=exact, values_bit_exact=equal,
                values_equal_share=same, ok=good))
            log(f"[kernels] w4_digits {tag:4s} M={m:<3d} digits, scales, sums bit-exact "
                f"{exact}; values bit-exact {equal} (equal {100 * same:.4f}%) "
                f"{'OK' if good else 'FAIL'}")
        for name, (din, dout) in shapes.items():
            slot = slots[name]
            x = torch.randn((m, din), generator=gen, device=dev).to(bf16)
            out = torch.empty((m, dout), dtype=bf16, device=dev)
            out32 = torch.empty((m, dout), dtype=torch.float32, device=dev)
            expansion = quant.launch_digits(x, m=m)
            quant.launch_rows(expansion, slot["packed"], slot["scales"], 1, m=m,
                              out_f32=out32, out_bf16=out)
            want = quant._w4_gemv_rows_ref(*expansion, slot["packed"], slot["scales"], 1,
                                           m=m)
            torch.cuda.synchronize()
            err = (out32 - want).abs()
            scale = float(want.abs().max())
            tol = 2.0 ** -10 * want.abs() + 2.0 ** -14 * scale
            good = (bool(torch.isfinite(out32).all()) and bool((err <= tol).all())
                    and torch.equal(out, out32.to(bf16)))
            ok &= good
            rec = dict(shape=name, m=m, max_abs_err=float(err.max()),
                       worst_err_over_tol=float((err / tol).max()),
                       tol="2^-10 |want| + 2^-14 max|want| per element (f32 output)",
                       max_abs_ref=scale, ok=good)
            msg = ""
            if m in (8, 16):
                fn = lambda: quant.launch_gemv_rows(  # noqa: E731
                    x, slot["packed"], slot["scales"], 1, m=m, out_bf16=out)
                t = time_ms(torch, fn, 30, flush)
                b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout) + m * dout * 2,
                                   4 * m * din * dout, INT8_OPS)
                rec.update(ms=t, bound_ms=b_ms, bound_by=b_by)
                msg = f"  digits + rows {t:.4f} ms  bound {b_ms:.4f} ms ({b_by})"
            results["w4_gemv_rows"].append(rec)
            log(f"[kernels] w4_gemv_rows {name:8s} M={m:<3d} err {rec['max_abs_err']:.3e} "
                f"(max|ref| {scale:.3e}, worst err/tol {rec['worst_err_over_tol']:.3f}) "
                f"{'OK' if good else 'FAIL'}{msg}")
    return ok


def _check_k6(torch, quant, fused_decode, results, slots, qkv_slot, gpost, gin, gen,
              flush, dims, S, layer_w, layer_macs, batches=(8, 16), model="NVILA-8B"):
    """K6 at B = 8 and 16: staggered cursors in an S-row cache, one row at
    S - 1 and one idle slot whose cursor lies past S (clamped)."""
    D, I, hd, Hq, Hkv, V = dims
    dev, bf16 = gpost.device, torch.bfloat16
    kv_ld = Hkv * hd
    ok = True
    for B in batches:
        fills = torch.randint(0, S - 1, (B,), generator=gen, device=dev).tolist()
        fills[1], fills[2] = S - 1, S + 40  # full row; idle slot past the cache
        kc = (0.5 * torch.randn((2, B, S, kv_ld), generator=gen, device=dev)).to(bf16)
        vc = torch.randn((2, B, S, kv_ld), generator=gen, device=dev).to(bf16)
        live = torch.tensor([min(f + 1, S) for f in fills], device=dev)
        mask = torch.where(torch.arange(S, device=dev)[None] < live[:, None], 0.0, -1e30)
        q32 = hd ** -0.5 * torch.randn((B, Hkv, 8, hd), generator=gen, device=dev)
        q32[:, :, Hq // Hkv:] = 0.0
        q32 = q32.reshape(B, Hkv * 8, hd).to(bf16)
        h = torch.randn((B, D), generator=gen, device=dev).to(bf16)
        args = (q32, mask.float(), h, 0, kc, vc, slots["o"], slots["gate_up"],
                slots["down"], qkv_slot, gpost, gin)
        kw = dict(hkv=Hkv, hd=hd, eps=1e-6, fill=fills, num_q_heads=Hq)
        fn = lambda: fused_decode.fused_layer_batched(*args, **kw)  # noqa: E731
        ref = lambda: fused_decode._fused_layer_batched_ref(*args, **kw)  # noqa: E731
        (h_k, qkv_k), (h_r, qkv_r) = fn(), ref()
        torch.cuda.synchronize()
        err_h, sc_h = rel_err(torch, h_k, h_r)
        err_q, sc_q = rel_err(torch, qkv_k, qkv_r)
        good = (err_h <= 2e-2 * sc_h and err_q <= 2e-2 * sc_q
                and bool(torch.isfinite(qkv_k.float()).all()))
        ok &= good
        t = time_ms(torch, fn, 30, flush)
        t_plain = time_ms(torch, ref, 5, flush)
        n_live = int(live.sum())
        byts = (layer_w + 2 * n_live * kv_ld * 2 + n_live * 4 + q32.numel() * 2
                + 2 * B * D * 2 + B * (Hq + 2 * Hkv) * hd * 2 + 3 * D * 2)
        ops = 2 * 2 * B * layer_macs + 4 * n_live * Hq * hd
        b_ms, b_by = bound(byts, ops, INT8_OPS)
        results["fused_layer_batched"].append(dict(
            model=model, shape=f"decode layer, B={B}, cache {S}, live rows {n_live}", m=B,
            max_abs_err=max(err_h, err_q),
            tol=f"2e-2 x max|ref| (h {2e-2 * sc_h:.3e}, qkv {2e-2 * sc_q:.3e})",
            ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
            library_ms=None))
        log(f"[kernels] fused_layer_batched {model} B={B} h err {err_h:.3e} (max {sc_h:.3e}) "
            f"qkv err {err_q:.3e} (max {sc_q:.3e}) {'OK' if good else 'FAIL'}  kernel "
            f"{t:.4f} ms  plain {t_plain:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
        if dev.type == "cuda":
            results["fused_layer_batched"][-1]["stages_ms"] = stages = _layer_stages(
                torch, quant, fused_decode, args, fills, flush, hd, Hq // Hkv)
            log(f"[kernels] fused_layer_batched {model} B={B} stages (ms): " + ", ".join(
                f"{k} {v:.4f}" for k, v in stages.items()))
    return ok


# K4's and K5's stages between the grid barriers of their one launch (K4's
# product-1 prologue and both kernels' merge + product-2 prologue run by the
# rows' owners, with no barrier inside)
PAIR_STAGES = {
    "fused_o_gateup": ("prologue 1", "product 1", "merge + prologue 2", "product 2",
                       "final sum"),
    "fused_down_qkv": ("values 1", "digits 1", "product 1", "merge + prologue 2",
                       "product 2", "final sum"),
}


def _check_k4_k5(torch, quant, fused_decode, results, slots, qkv_slot, gpost, gin,
                 gen, flush, dims, rows=(24, 32), model="NVILA-8B"):
    """K4 then K5 at M = 24 and 32 (the route of 17..32 rows); K5 is fed
    K4's kernel outputs on both sides, so each is held on its own, within
    1e-2 x max|ref|. Each launch's product-1 digits and group sums (prologue
    none for K4, SiLU for K5) bit for bit against the plain version run on
    the CPU; a second launch on the same inputs must repeat every output bit
    for bit. Timed beside the plain version, dequantize + matmul, cuBLAS
    bf16 over weights dequantised once, the bound, and the same two
    products through K6's rows route (a digit pass and a rows GEMV each:
    four launches, the yardstick of the fusion); at NVILA-8B, M = 24, the
    stage times from inside the launch."""
    D, I, hd, Hq, Hkv, V = dims
    dev, bf16 = gpost.device, torch.bfloat16
    o, gu, down = slots["o"], slots["gate_up"], slots["down"]
    group = lambda slot: quant._tiled_meta(slot["packed"], slot["scales"])[4]  # noqa: E731
    deq = lambda slot, l: quant.dequantize(  # noqa: E731
        {"packed": slot["packed"][l], "scales": slot["scales"][l]})
    # the one-call yardstick: cuBLAS bf16 products over weights dequantised once
    w_o, w_gu, w_d, w_q = deq(o, 0), deq(gu, 0), deq(down, 0), deq(qkv_slot, 1)
    g_post, g_in = gpost[0].to(bf16), gin[1].to(bf16)
    bias = qkv_slot["bias"][1].to(bf16) if "bias" in qkv_slot else None
    ok = True
    for m in rows:
        attn = torch.randn((m, Hkv, 8, hd), generator=gen, device=dev)
        attn[:, :, Hq // Hkv:] = 0.0
        attn = attn.reshape(m, -1).to(bf16)
        h = torch.randn((m, D), generator=gen, device=dev).to(bf16)
        k4 = lambda: fused_decode.fused_o_gateup(attn, h, 0, o, gu, gpost)  # noqa: E731
        k4_ref = lambda: fused_decode._fused_o_gateup_ref(attn, h, 0, o, gu, gpost)  # noqa: E731
        (h1, g1), (h1_r, g1_r) = k4(), k4_ref()
        digits = {}
        if dev.type == "cuda":
            digits["fused_o_gateup"] = ([t.cpu() for t in fused_decode.pair_first_digits(dev)],
                                        attn, quant.PRO_NONE, group(o))
        k5 = lambda: fused_decode.fused_down_qkv(g1, h1, 0, down, qkv_slot, gin)  # noqa: E731
        k5_ref = lambda: fused_decode._fused_down_qkv_ref(  # noqa: E731
            g1, h1, 0, down, qkv_slot, gin)
        (h2, q2), (h2_r, q2_r) = k5(), k5_ref()
        if dev.type == "cuda":
            digits["fused_down_qkv"] = ([t.cpu() for t in fused_decode.pair_first_digits(dev)],
                                        g1, quant.PRO_SILU, group(down))
        torch.cuda.synchronize()
        x1 = torch.randn((m, D), generator=gen, device=dev).to(bf16)
        x2 = torch.randn((m, I), generator=gen, device=dev).to(bf16)
        cases = {
            "fused_o_gateup": ((h1, h1_r), (g1, g1_r), k4, k4_ref,
                               lambda: (attn @ deq(o, 0), x1 @ deq(gu, 0)),
                               lambda: (attn @ w_o, x1 @ w_gu),
                               lambda: fused_decode._launch_o_gateup(
                                   attn, h, 0, o, gu, g_post, 1e-6, h_new=torch.empty_like(h)),
                               ((Hkv * 8 * hd, D), (D, 2 * I))),
            "fused_down_qkv": ((h2, h2_r), (q2, q2_r), k5, k5_ref,
                               lambda: (x2 @ deq(down, 0), x1 @ deq(qkv_slot, 1)),
                               lambda: (x2 @ w_d, x1 @ w_q),
                               lambda: fused_decode._launch_down_qkv(
                                   g1, h1, 0, 1, down, qkv_slot, g_in, bias, 1e-6,
                                   h_new=torch.empty_like(h1)),
                               ((I, D), (D, (Hq + 2 * Hkv) * hd))),
        }
        for name, (ha, oa, fn, ref, lib, lib1, rows_route, mats) in cases.items():
            err_h, sc_h = rel_err(torch, *ha)
            err_o, sc_o = rel_err(torch, *oa)
            good = (err_h <= 1e-2 * sc_h and err_o <= 1e-2 * sc_o
                    and bool(torch.isfinite(oa[0].float()).all()))
            exact = repeat = None
            if dev.type == "cuda":
                (d_k, s_k), x_in, pro, gs = digits[name]
                d_w, _, s_w = quant._w4_digits_ref(x_in.cpu(), pro, group=gs)
                exact = torch.equal(d_k, d_w) and torch.equal(s_k, s_w)
                again = fn()
                torch.cuda.synchronize()
                repeat = all(torch.equal(a, b) for a, b in zip(again, (ha[0], oa[0])))
                good &= exact and repeat
            ok &= good
            t = time_ms(torch, fn, 30, flush)
            t_plain = time_ms(torch, ref, 5, flush)
            t_lib = time_ms(torch, lib, 5, flush)
            t_bf16 = time_ms(torch, lib1, 30, flush)
            t_rows = time_ms(torch, rows_route, 30, flush)
            byts = sum(w4_bytes(a, b, quant.group_for(a // 2)) + m * a * 2 + m * b * 2
                       for a, b in mats) + 3 * m * D * 2
            b_ms, b_by = bound(byts, sum(4 * m * a * b for a, b in mats), INT8_OPS)
            rec = dict(
                model=model, shape="o + gate_up" if name == "fused_o_gateup" else "down + qkv",
                m=m, max_abs_err=max(err_h, err_o),
                tol=f"1e-2 x max|ref| (h {1e-2 * sc_h:.3e}, out {1e-2 * sc_o:.3e})",
                digits_bit_exact=exact, repeat_bit_exact=repeat,
                ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_lib, bf16_matmul_ms=t_bf16, rows_route_ms=t_rows)
            if dev.type == "cuda" and model == "NVILA-8B" and m == 24:
                rec["stages_ms"] = _pair_stamps(torch, fused_decode, fn, name, flush)
            results[name].append(rec)
            log(f"[kernels] {name} {model} M={m} h err {err_h:.3e} (max {sc_h:.3e}) out err "
                f"{err_o:.3e} (max {sc_o:.3e}); product-1 digits bit-exact {exact}, repeat "
                f"bit-exact {repeat} {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  plain "
                f"{t_plain:.3f} ms  dequant+matmul {t_lib:.3f} ms  bf16 matmul {t_bf16:.4f} ms  "
                f"rows route (4 launches) {t_rows:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
            if "stages_ms" in rec:
                log(f"[kernels] {name} stages inside the launch (ms, median of 20, "
                    "%globaltimer of CTA 0): " + ", ".join(
                        f"{k} {v:.4f}" for k, v in rec["stages_ms"].items()))
    return ok


def _pair_stamps(torch, fused_decode, fn, name, flush, reps=20):
    """K4's or K5's stage times from inside its one launch (CTA 0's
    %globaltimer after each grid barrier; a product's time runs from the
    barrier after its digits to the one after its units): medians over
    `reps` launches, L2 flushed before each. `fn` launches the wrapper; the
    stamps are taken by a launch of `launch_pair` with the same arguments."""
    names = PAIR_STAGES[name]
    nb = len(names) - 1  # barriers before the last stage
    stamps = torch.zeros(9, dtype=torch.int64, device=flush.device)
    real = fused_decode.launch_pair

    def stamped(*a, **kw):
        kw["stamps"] = stamps
        return real(*a, **kw)

    per = []
    fused_decode.launch_pair = stamped
    try:
        for _ in range(reps):
            flush.zero_()
            fn()
            torch.cuda.synchronize()
            t = stamps.tolist()
            t = t[:nb + 1] + [t[8]]  # start, after each barrier, end
            per.append([(b - a) / 1e6 for a, b in zip(t, t[1:])])
    finally:
        fused_decode.launch_pair = real
    return {k: statistics.median(p[i] for p in per) for i, k in enumerate(names)}


LAYER_STAGES = ("attention", "attention merge", "o prologue", "o stream",
                "gate_up prologue", "gate_up stream", "silu", "down prologue", "down stream",
                "qkv prologue", "qkv stream", "qkv merge")


def _layer_stamps(torch, fused_decode, args, kw, flush, reps=20):
    """K3's stage times from inside its one launch: the kernel writes
    %globaltimer at the start, after each of its seven grid barriers, after
    each product's prologue (digits) and at the end (CTA 0's view; a
    product's "stream" runs to the next barrier); medians over `reps`
    launches, L2 flushed before each."""
    q32, mask, h, li, kc, vc, o, gu, down, qkv, gpost, gin = args
    l, l_next, rows = fused_decode._layer_rows(o, qkv, gpost, gin, li)
    _, grp = fused_decode._group(q32.shape[0], kw["hkv"], kw["num_q_heads"])
    d = h.shape[1]
    out = torch.empty(d + fused_decode._dout(qkv), dtype=torch.bfloat16, device=q32.device)
    stamps = torch.zeros(len(LAYER_STAGES) + 1, dtype=torch.int64, device=q32.device)
    per = []
    for _ in range(reps):
        flush.zero_()
        fused_decode.launch_layer(q32, kc, vc, mask, h[0:1], l, l_next, kw["fill"] + 1,
                                  kw["hkv"], kw["hd"], grp, (o, gu, down, qkv), rows,
                                  kw["eps"], out, stamps=stamps)
        torch.cuda.synchronize()
        t = stamps.tolist()
        per.append([(b - a) / 1e6 for a, b in zip(t, t[1:])])
    return {name: statistics.median(p[i] for p in per) for i, name in enumerate(LAYER_STAGES)}


def _layer_stages(torch, quant, fused_decode, args, fill, flush, hd, grp):
    """Each of K6's nine launches timed on its own (same inputs, each stage
    run once in order first so that every input holds real values): the
    attention, then per product a digit pass and a rows GEMV."""
    q32, mask, h, _, kc, vc, o, gu, down, qkv, gpost, gin = args
    dev, bf16 = q32.device, torch.bfloat16
    hkv = kc.shape[-1] // hd
    m = q32.shape[0]
    d = h.shape[1]
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    x_att, h32, h32b = e((m, q32.numel() // m), bf16), e((m, d), torch.float32), e((m, d), torch.float32)
    g_out, q_out = e((m, fused_decode._dout(gu)), bf16), e((m, fused_decode._dout(qkv)), bf16)
    h_new = e((m, d), bf16)
    rms_post = dict(prologue=quant.PRO_RMS, gamma=gpost[0].to(bf16), eps=1e-6)
    rms_in = dict(prologue=quant.PRO_RMS, gamma=gin[1].to(bf16), eps=1e-6)
    epi = {  # stage: (input, slot, layer, prologue, epilogue)
        "o": (x_att, o, 0, {}, dict(res_bf16=h, out_f32=h32)),
        "gate_up": (h32, gu, 0, rms_post, dict(out_bf16=g_out)),
        "down": (g_out, down, 0, dict(prologue=quant.PRO_SILU),
                 dict(res_f32=h32, out_f32=h32b, out_bf16=h_new)),
        "qkv": (h32b, qkv, 1, rms_in, dict(bias=qkv["bias"][1].to(bf16), out_bf16=q_out)),
    }
    live = fused_decode._live_rows(fill, m, kc.shape[2])
    stages = {"attention": lambda: fused_decode._launch_attn_batched(
        q32, kc, vc, mask, 0, live, hkv, hd, grp, x_att)}
    digits = {}

    def digit_pass(name, x, pro, slot):
        group = quant._tiled_meta(slot["packed"], slot["scales"])[4]
        digits[name] = quant.launch_digits(x, m=m, group=group, **pro)

    for name, (x, slot, li, pro, out) in epi.items():
        stages[f"{name} digits"] = (lambda n=name, x=x, pro=pro, slot=slot: digit_pass(
            n, x, pro, slot))
        stages[name] = (lambda n=name, slot=slot, li=li, out=out: quant.launch_rows(
            digits[n], slot["packed"], slot["scales"], li, m=m, **out))
    for f in stages.values():
        f()
    return {k: time_ms(torch, f, 30, flush) for k, f in stages.items()}


def summarise(results, launches):
    """One entry per kernel, summed over the calls the main paths make per
    unit of work: K1 one bs=1 decode step's layer-0 qkv and lm_head at M=1
    (and, under `batched`, timings only, the lm_head at M=8 and 24 of
    `serve b8` and `serve b24`: those paths' K1 launches, layer 0's qkv
    included, are in its `launches_by_path`);
    K2 one prefill layer's four projections at M=320 (under `media`, the
    same at M=1536 and 8192, the s2 and video prompts' buckets); K3 one
    bs=1 decode layer (under `media`, over the video's cache); K6 one decode layer at B=8 (the max_batch=8 server); K4 and K5
    one layer's pair of GEMVs at M=24 (the max_batch=24 server).
    `launches` maps each path run to its counts; a kernel's `launches` is
    its sum over those runs."""
    picks = {
        "w4_gemv": lambda r: r["m"] == 1 and r["shape"] in ("qkv", "lm_head"),
        "w4_gemm": lambda r: r["m"] > 32 and "media" not in r,
        "w4_gemm_dots": lambda r: r["m"] > 32,
        "fused_layer": lambda r: "media" not in r,
        "fused_o_gateup": lambda r: r["m"] == 24,
        "fused_down_qkv": lambda r: r["m"] == 24,
        "fused_layer_batched": lambda r: r["m"] == 8,
        **{name: (lambda r: r["main"]) for name in FLASH_KERNELS},
    }
    batched = [dict(work=f"lm_head M={m} ({path})", m=m, path=path,
                    **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "library_ms", "bf16_matmul_ms")})
               for m, path in K1_BATCHED
               for r in results.get("k1", []) if r["shape"] == "lm_head" and r["m"] == m]
    # K2 at the media prompts' buckets (one layer's four projections) and K3
    # over the video's cache, beside the main entries (timings only)
    media = {}
    for name in ("w4_gemm", "fused_layer"):
        by_path = {}
        for r in results.get(name, []):
            if "media" in r:
                by_path.setdefault((r["media"], r["m"]), []).append(r)
        media[name] = [dict(
            work=(f"one prefill layer's 4 projections M={m} ({path})" if name == "w4_gemm"
                  else f"one bs=1 layer, {rows[0]['shape']} ({path})"),
            m=m, path=path, max_abs_err=max(r["max_abs_err"] for r in rows),
            **{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "bound_ms")},
            bound_by=rows[0]["bound_by"],
            library_ms=None if rows[0]["library_ms"] is None else sum(
                r["library_ms"] for r in rows),
            checks_ok=all(r["ok"] for r in rows))
            for (path, m), rows in by_path.items()]
    out = []
    for name, meta in KERNELS.items():
        # the NVILA-8B main-path shapes (the Qwen2-0.5B checks are reported apart)
        rows = [r for r in results.get(name, [])
                if r.get("model", "NVILA-8B") == "NVILA-8B" and picks[name](r)]
        if not rows:
            continue
        lib = [r["library_ms"] for r in rows]
        out.append(dict(
            name=name, **meta,
            launches=sum(c.get(name, 0) for c in launches.values()),
            launches_by_path={path: c.get(name, 0) for path, c in launches.items()},
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=rows[0]["bound_by"],
            library_ms=None if None in lib else sum(lib),
            **({"bf16_matmul_ms": sum(r["bf16_matmul_ms"] for r in rows)}
               if all("bf16_matmul_ms" in r for r in rows) else {}),
            work=", ".join(f"{r['shape']} M={r['m']}" for r in rows),
            checks_ok=all(r["ok"] for r in results[name]),
            **({"batched": batched} if name == "w4_gemv" and batched else {}),
            **({"media": media[name]} if media.get(name) else {}),
        ))
    return out


QUESTIONS = ["Describe the image in detail.", "What is in the picture?",
             "How many objects are there?", "What colour dominates?"]


def _images(seed, n):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (448, 448, 3), dtype=np.uint8) for _ in range(n)]


def _no_launches():
    from vila_tpu_torch.ops import _build

    return {name: 0 for name in _build.LAUNCHES}


def phase_e2e(torch, engine, seed, n_requests=3, new_tokens=32, tag="e2e", prompt=None):
    """The serial engine (bs=1: K2 prefill, K3 + K1 decode); each request's
    ids are in its entry of the returned list. `prompt(i)` gives request
    i's prompt (default: a 448² image and a question)."""
    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build

    cfg, tok = engine.cfg, engine.tokenizer
    layers = cfg.llm.num_hidden_layers
    if prompt is None:
        images = _images(seed, n_requests + 1)
        prompt = lambda i: [images[i], QUESTIONS[i % len(QUESTIONS)]]  # noqa: E731
    # no stop token: every request decodes exactly `new_tokens`
    gc = GenerationConfig(max_new_tokens=new_tokens, stop_token_ids=(-1,))

    def serve(i):
        t_start = time.perf_counter()
        inputs = engine.prepare_inputs(prompt(i))
        t_inputs = time.perf_counter()
        ids, times = [], []
        for chunk in engine.stream_ids(inputs, gc):
            ids.extend(chunk)
            times.append(time.perf_counter())
        return inputs, ids, t_start, times, t_inputs - t_start

    serve(n_requests)  # warm-up request (cuBLAS handles, allocator)
    _build.reset_launches()
    reqs = []
    for i in range(n_requests):
        inputs, ids, t_start, times, prep = serve(i)
        ttft = (times[0] - t_start) * 1e3
        dec = (len(ids) - 1) / (times[-1] - times[0])
        reqs.append(dict(prompt_tokens=int(inputs["input_ids"].shape[0]),
                         new_tokens=len(ids), ttft_ms=ttft, inputs_ms=prep * 1e3,
                         decode_tok_s=dec, ids=ids))
        log(f"[{tag}] request {i}: prompt {inputs['input_ids'].shape[0]} tokens, "
            f"{len(ids)} new, TTFT {ttft:.1f} ms (host inputs {prep * 1e3:.1f} ms), "
            f"decode {dec:.1f} tok/s, "
            f"text {tok.decode(ids, skip_special_tokens=True)[:40]!r}")
        ok_ids = len(ids) == new_tokens and all(0 <= t < cfg.llm.vocab_size for t in ids)
        if not ok_ids:
            log(f"[{tag}] FAIL: request {i} gave {len(ids)} ids, range check failed")
            return False, reqs, dict(_build.LAUNCHES)
    launches = dict(_build.LAUNCHES)
    steps = sum(r["new_tokens"] - 1 for r in reqs)
    # the bs=1 path launches none of the batched kernels (K4-K6)
    want = dict(_no_launches(), w4_gemv=n_requests + 2 * steps,
                w4_gemm=4 * layers * n_requests, fused_layer=layers * steps)
    log(f"[{tag}] launches {launches}, expected {want}")
    ok = all(launches[k] > 0 for k in E2E_KERNELS) and launches == want
    return ok, reqs, launches


def phase_serve(torch, engine, seed, max_batch, n_requests, new_tokens, max_len=2048):
    """`n_requests` image+question requests submitted at once to a
    `ContinuousBatcher` with `max_batch` slots, greedy, `new_tokens` each
    (no stop token). Every decode step runs the batched route for
    max_batch rows: K6 for max_batch <= 16, K4/K5 above; the launches are
    held exactly against the batcher's step count."""
    import concurrent.futures as cf

    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    cfg, tok = engine.cfg, engine.tokenizer
    layers = cfg.llm.num_hidden_layers
    tag = f"serve b{max_batch}"
    images = _images(seed + max_batch, n_requests)
    gc = GenerationConfig(max_new_tokens=new_tokens, stop_token_ids=(-1,))
    batcher = ContinuousBatcher(engine, max_batch=max_batch, max_len=max_len)
    try:
        # warm-up request: the first batched step's allocations
        batcher.generate_content([images[0], QUESTIONS[0]],
                                 GenerationConfig(max_new_tokens=3, stop_token_ids=(-1,)))
        torch.cuda.synchronize()
        _build.reset_launches()
        steps0 = batcher.steps

        def one(i):
            t_submit = time.perf_counter()
            ids, times = [], []
            for chunk in batcher.stream_ids([images[i], QUESTIONS[i % len(QUESTIONS)]], gc):
                ids.extend(chunk)
                times.append(time.perf_counter())
            return ids, t_submit, times

        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(n_requests) as ex:
            done = [f.result(timeout=600) for f in
                    [ex.submit(one, i) for i in range(n_requests)]]
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        steps = batcher.steps - steps0
        step_s = list(batcher.step_seconds)[-steps:] if steps else []
    finally:
        batcher.shutdown()
    reqs = []
    ok = True
    for i, (ids, t_submit, times) in enumerate(done):
        ttft = (times[0] - t_submit) * 1e3
        dec = (len(ids) - 1) / (times[-1] - times[0])
        reqs.append(dict(new_tokens=len(ids), ttft_ms=ttft, decode_tok_s=dec))
        good = len(ids) == new_tokens and all(0 <= t < cfg.llm.vocab_size for t in ids)
        ok &= good
        log(f"[{tag}] request {i}: TTFT {ttft:.1f} ms, decode {dec:.1f} tok/s, "
            f"{len(ids)} tokens{'' if good else ' FAIL'}")
    total = sum(len(d[0]) for d in done)
    route = ({"fused_layer_batched": layers * steps} if max_batch <= 16 else
             {"fused_o_gateup": layers * steps, "fused_down_qkv": layers * steps})
    want = dict(_no_launches(), w4_gemv=2 * steps + n_requests,
                w4_gemm=4 * layers * n_requests, **route)
    ok &= steps > 0 and launches == want
    step_ms = sorted(1e3 * t for t in step_s)
    summary = dict(
        max_batch=max_batch, requests=n_requests, new_tokens=new_tokens, steps=steps,
        wall_s=wall, aggregate_tok_s=total / wall, requests_detail=reqs,
        ttft_ms_median=statistics.median(r["ttft_ms"] for r in reqs),
        decode_tok_s_median=statistics.median(r["decode_tok_s"] for r in reqs),
        step_ms_median=statistics.median(step_ms), step_ms_min=step_ms[0],
    )
    log(f"[{tag}] {n_requests} requests x {new_tokens} tokens on {max_batch} slots: "
        f"{steps} steps in {wall:.2f} s, aggregate {total / wall:.1f} tok/s, TTFT "
        f"median {summary['ttft_ms_median']:.1f} ms, decode median "
        f"{summary['decode_tok_s_median']:.1f} tok/s per request, step wall median "
        f"{summary['step_ms_median']:.2f} ms (min {step_ms[0]:.2f})")
    log(f"[{tag}] launches {launches}, expected {want} -> {'OK' if ok else 'FAIL'}")
    return ok, summary, launches


def phase_consistency(torch, engine, llm_cpu, seed, steps=8):
    """Kernel decode path (K2 prefill, K3 + K1 decode) against a cache-free
    forward over prefix + generated tokens through the plain versions
    (CPU)."""
    import numpy as np

    from vila_tpu_torch.models import qwen2, vlm

    device = engine.device
    params, cfg = engine.params, engine.cfg
    layers = cfg.llm.num_hidden_layers
    image = np.random.default_rng(seed + 1).integers(0, 256, (448, 448, 3), dtype=np.uint8)
    inputs = engine.prepare_inputs([image, "Describe the image."])
    llm, lcfg = params["llm"], cfg.llm
    ids = torch.as_tensor(inputs["input_ids"], device=device)[None].long()
    mp = torch.as_tensor(inputs["media_pos"], device=device).long()
    media = engine.encode_media(inputs["media"])
    embeds = vlm.splice_media(qwen2.embed_tokens(llm, lcfg, ids), media, mp)
    n = ids.shape[1]
    cache = qwen2.init_cache(lcfg, 1, 512, device=device)
    logits, cache = qwen2.forward(llm, lcfg, inputs_embeds=embeds, cache=cache,
                                  last_token_only=True)
    step_logits, toks = [logits[0, -1].float()], []
    for _ in range(steps):
        t = int(step_logits[-1].argmax())
        toks.append(t)
        logits, cache = qwen2.forward(
            llm, lcfg, input_ids=torch.tensor([[t]], device=device), cache=cache)
        step_logits.append(logits[0, -1].float())
    got = torch.stack(step_logits).cpu()

    full = torch.cat([embeds.cpu(), qwen2.embed_tokens(
        llm_cpu, lcfg, torch.tensor([toks]))], dim=1)
    t0 = time.time()
    h, _ = qwen2.forward(llm_cpu, lcfg, inputs_embeds=full, return_hidden=True)
    want = qwen2.compute_logits(llm_cpu, lcfg, h[:, n - 1:])[0].float()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    tol = 5e-2
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol * scale).all())
    log(f"[consistency] {layers} layers, prompt {n} tokens, {steps} decode steps "
        f"(plain forward {time.time() - t0:.1f} s on the CPU): max |dlogit| per "
        f"step {[round(float(e), 4) for e in err]}, max |logit| "
        f"{float(scale.max()):.3f}, tolerance {tol} x max|logit|; argmax agrees "
        f"on {agree}/{steps + 1} steps -> {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=float(err.max()), max_logit=float(scale.max()),
                    tol_rel=tol, argmax_agree=agree, steps=steps + 1)


def phase_batched_consistency(torch, engine, llm_cpu, seed, steps=8,
                              batches=((3, ("fused_layer_batched",)),
                                       (20, ("fused_o_gateup", "fused_down_qkv")))):
    """The batched decode routes against the plain cache-free forward of
    each row on the CPU: B = 3 rows through K6 and B = 20 through K4/K5,
    each row a text prompt of its own length, prefilled (K2) into a bs=1
    cache and copied into its batch slot by the batcher's own insert, then
    `steps` greedy steps with per-row cursors. All rows of both batches
    run through one packed plain forward (one segment per row)."""
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    device, cfg = engine.device, engine.cfg
    llm, lcfg = engine.params["llm"], cfg.llm
    layers = lcfg.num_hidden_layers
    rows, got, ok = [], [], True
    for B, route in batches:
        batcher = ContinuousBatcher(engine, max_batch=B, max_len=512)  # never started
        first, n = [], []
        for i in range(B):
            inputs = engine.prepare_inputs(f"Row {i} of {B}: " + "more " * (1 + i))
            prompt = [int(t) for t in inputs["input_ids"]]
            _, cache1, tok, plen = batcher._prepare(_greedy_request(inputs))
            batcher._insert(i, cache1)
            first.append(tok)
            n.append(plen)
            rows.append(prompt)
        del cache1
        cache = batcher.cache
        toks = torch.tensor(first, device=device)
        pos = torch.tensor(n, dtype=torch.int32, device=device)
        fed = [toks]
        out = []
        _build.reset_launches()
        for j in range(steps):
            logits, cache = qwen2.forward(llm, lcfg, input_ids=toks[:, None],
                                          positions=(pos + j)[:, None], cache=cache)
            out.append(logits[:, 0].float())
            toks = logits[:, 0].argmax(-1)
            fed.append(toks)
        launches = dict(_build.LAUNCHES)
        want = dict(_no_launches(), w4_gemv=2 * steps,
                    **{k: layers * steps for k in route})
        ok &= launches == want
        log(f"[batched consistency] B={B}: launches {launches}, expected {want}")
        fed = torch.stack(fed, 1).cpu()  # (B, steps + 1): first token + each step's
        for i in range(B):
            rows[-B + i] = rows[-B + i] + fed[i, :steps].tolist()
        got.append((B, torch.stack(out, 1).cpu(), fed))
        del batcher, cache

    # one packed plain forward over every row: prompt + tokens fed
    lens = [len(r) for r in rows]
    ids = torch.tensor([[t for r in rows for t in r]])
    seg = torch.tensor([[i + 1 for i, r in enumerate(rows) for _ in r]])
    positions = torch.tensor([[p for ln in lens for p in range(ln)]], dtype=torch.int32)
    t0 = time.time()
    h, _ = qwen2.forward(llm_cpu, lcfg, input_ids=ids, positions=positions,
                         segment_ids=seg, return_hidden=True)
    ends = torch.tensor(lens).cumsum(0)
    # logits after each fed token: positions len - steps .. len - 1 of a row
    at = torch.cat([torch.arange(e - steps, e) for e in ends.tolist()])
    want_all = qwen2.compute_logits(llm_cpu, lcfg, h[:, at])[0].float()
    cpu_s = time.time() - t0
    tol = 5e-2
    summary = {}
    r0 = 0
    for B, got_b, fed in got:
        want = want_all[r0 * steps:(r0 + B) * steps].reshape(B, steps, -1)
        r0 += B
        err = (got_b - want).abs().amax(-1)
        scale = want.abs().amax(-1)
        agree = int((got_b.argmax(-1) == want.argmax(-1)).sum())
        good = bool(torch.isfinite(got_b).all()) and bool((err <= tol * scale).all())
        ok &= good
        summary[f"B{B}"] = dict(max_abs_err=float(err.max()), max_logit=float(scale.max()),
                                tol_rel=tol, argmax_agree=agree, compared=B * steps)
        log(f"[batched consistency] B={B}, {layers} layers, {steps} steps: max |dlogit| "
            f"{float(err.max()):.4f}, max |logit| {float(scale.max()):.3f}, tolerance "
            f"{tol} x max|logit|; argmax agrees on {agree}/{B * steps} "
            f"-> {'OK' if good else 'FAIL'}")
    log(f"[batched consistency] plain packed forward of {sum(lens)} tokens: "
        f"{cpu_s:.1f} s on the CPU")
    return ok, summary


def phase_small_consistency(torch, seed, steps=8, layers=4, prompt=300, dev="cuda",
                            batches=((1, ("fused_layer",)), (3, ("fused_layer_batched",)),
                                     (20, ("fused_o_gateup", "fused_down_qkv")))):
    """Every decode route at Qwen2-0.5B widths (head dim 64; D = 896, so the
    D-input products take W4 groups of 112): a text-only LLM, W4, random
    weights from the seed, depth cut to `layers`. bs=1 prefills a
    `prompt`-token prompt through K2 and decodes through K3 (K1 takes layer
    0's qkv each step; the lm_head is the tied embedding); B = 3 (K6) and
    B = 20 (K4/K5) prefill rows of 4 + i tokens through K1 (M <= 32) into bs=1
    caches, copied into their batch slots, then decode with per-row cursors.
    Each route's per-step logits are held against one packed cache-free
    plain forward of every row on the CPU (tolerance and argmax count as
    `consistency`), and its launches exactly against the steps and rows."""
    import numpy as np

    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.utils.weights import to_torch_tree

    lcfg = qwen2_0_5b_config(layers)
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    llm = synth_llm_params(torch, lcfg, gen, dev)
    llm_cpu = to_torch_tree(llm, torch.device("cpu"))
    rng = np.random.default_rng(seed + 5)
    max_len = 512
    rows, got, ok = [], [], True
    for B, route in batches:
        lens = [prompt] if B == 1 else [4 + i for i in range(B)]
        cache = qwen2.init_cache(lcfg, B, max_len, device=dev, per_slot_fill=True)
        first = []
        _build.reset_launches()
        for i, n in enumerate(lens):
            ids = [int(t) for t in rng.integers(0, lcfg.vocab_size, n)]
            cache1 = qwen2.init_cache(lcfg, 1, max_len, device=dev)
            logits, cache1 = qwen2.forward(llm, lcfg, input_ids=torch.tensor([ids], device=dev),
                                           cache=cache1, last_token_only=True)
            first.append(int(logits[0, -1].argmax()))
            cache["k"][:, i].copy_(cache1["k"][:, 0])
            cache["v"][:, i].copy_(cache1["v"][:, 0])
            cache["valid"][i].copy_(cache1["valid"][0])
            cache["fill"][i] = int(cache1["fill"])
            cache["fill_host"][i] = int(cache1["fill"])
            rows.append(ids)
        torch.cuda.synchronize()
        pre = dict(_build.LAUNCHES)
        want_pre = dict(_no_launches(), **({"w4_gemm": 4 * layers} if B == 1 else
                                           {"w4_gemv": 4 * layers * B}))
        del cache1
        toks = torch.tensor(first, device=dev)
        pos = torch.tensor(lens, dtype=torch.int32, device=dev)
        fed, out = [toks], []
        _build.reset_launches()
        for j in range(steps):
            logits, cache = qwen2.forward(llm, lcfg, input_ids=toks[:, None],
                                          positions=(pos + j)[:, None], cache=cache)
            out.append(logits[:, 0].float())
            toks = logits[:, 0].argmax(-1)
            fed.append(toks)
        launches = dict(_build.LAUNCHES)
        want = dict(_no_launches(), w4_gemv=steps, **{k: layers * steps for k in route})
        good = launches == want and pre == want_pre
        ok &= good
        log(f"[small consistency] B={B}: prefill launches {pre} (expected {want_pre}); "
            f"decode launches {launches}, expected {want} -> {'OK' if good else 'FAIL'}")
        fed = torch.stack(fed, 1).cpu()
        for i in range(B):
            rows[-B + i] = rows[-B + i] + fed[i, :steps].tolist()
        got.append((B, torch.stack(out, 1).cpu()))
        del cache

    lens = [len(r) for r in rows]
    ids = torch.tensor([[t for r in rows for t in r]])
    seg = torch.tensor([[i + 1 for i, r in enumerate(rows) for _ in r]])
    positions = torch.tensor([[p for ln in lens for p in range(ln)]], dtype=torch.int32)
    t0 = time.time()
    h, _ = qwen2.forward(llm_cpu, lcfg, input_ids=ids, positions=positions,
                         segment_ids=seg, return_hidden=True)
    ends = torch.tensor(lens).cumsum(0)
    at = torch.cat([torch.arange(e - steps, e) for e in ends.tolist()])
    want_all = qwen2.compute_logits(llm_cpu, lcfg, h[:, at])[0].float()
    cpu_s = time.time() - t0
    tol = 5e-2
    summary = {}
    r0 = 0
    for B, got_b in got:
        want = want_all[r0 * steps:(r0 + B) * steps].reshape(B, steps, -1)
        r0 += B
        err = (got_b - want).abs().amax(-1)
        scale = want.abs().amax(-1)
        agree = int((got_b.argmax(-1) == want.argmax(-1)).sum())
        good = bool(torch.isfinite(got_b).all()) and bool((err <= tol * scale).all())
        ok &= good
        summary[f"B{B}"] = dict(max_abs_err=float(err.max()), max_logit=float(scale.max()),
                                tol_rel=tol, argmax_agree=agree, compared=B * steps)
        log(f"[small consistency] Qwen2-0.5B widths, B={B}, {layers} layers, {steps} steps: "
            f"max |dlogit| {float(err.max()):.4f}, max |logit| {float(scale.max()):.3f}, "
            f"tolerance {tol} x max|logit|; argmax agrees on {agree}/{B * steps} "
            f"-> {'OK' if good else 'FAIL'}")
    log(f"[small consistency] plain packed forward of {sum(lens)} tokens: "
        f"{cpu_s:.1f} s on the CPU")
    del llm
    return ok, summary


def _greedy_request(inputs):
    """A greedy batcher request for `_prepare`, outside the scheduler."""
    import queue

    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.serving.batcher import _Request

    return _Request(inputs=inputs, gen=GenerationConfig(max_new_tokens=1),
                    out=queue.Queue(), stop_ids=frozenset())


def phase_http(torch, engine, n_requests=4, new_tokens=16):
    """The OpenAI-compatible server on 127.0.0.1 (a free port) over a
    max_batch=8 batcher: `n_requests` concurrent text requests through the
    port's client, one of them streamed (the client raises unless the
    stream ends with [DONE]); each reply must be the batcher's own greedy
    answer to the same prompt."""
    import concurrent.futures as cf
    import threading

    from vila_tpu_torch.serving import client, server
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    prompts = [f"Say something about the number {i}." for i in range(n_requests)]
    batcher = ContinuousBatcher(engine, max_batch=8, max_len=2048)
    httpd = server.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        gc = server._gen_config({"max_tokens": new_tokens, "temperature": 0})
        direct = [batcher.generate_content(server.parse_messages(
            client.build_messages(p)), gc) for p in prompts]
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(n_requests) as ex:
            futs = [ex.submit(lambda i: "".join(client.chat(
                url, client.build_messages(prompts[i]), max_tokens=new_tokens,
                temperature=0.0, stream=i == 0, timeout=300)), i)
                for i in range(n_requests)]
            got = [f.result(timeout=300) for f in futs]
        wall = time.perf_counter() - t0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.shutdown()
        thread.join(timeout=30)
    ok = [g.strip() == d for g, d in zip(got, direct)]
    log(f"[http] {n_requests} concurrent requests (request 0 streamed) in "
        f"{wall:.2f} s: replies equal the batcher's own greedy answers: {ok}; "
        f"first reply {got[0][:40]!r}")
    return all(ok) and not thread.is_alive(), dict(wall_s=wall, equal=ok)


# --------------------------------------------------------------------------
# NVILA's media paths: dynamic-S2 and TSP video at NVILA-8B width
# --------------------------------------------------------------------------

TSP_TARGET = "llava.model.encoders.TSPVideoEncoder"
# (top-level config.json fields, projector type, requests, new tokens) of
# each media phase. s2: NVILA's scales with the aspect-ratio grid kept
# (s2_resize_output_to_scale_idx -1, the multi-block merge; the JAX
# default 0 gives one block) over the 3x3 projector; mm_hidden_size is
# left to build_config (1152 x 3 scales). video: the NVILA-Video-8B
# TinyChat condition, 64 frames (BASELINE.md:5) pooled 4 in time: 16 rows
# of 256 tokens, ≈ 4.1k prompt tokens (bench.py:438-441's reckoning).
MEDIA_PHASES = {
    "s2": (dict(image_aspect_ratio="dynamic_s2", dynamic_s2=True,
                s2_scales=[448, 896, 1344], max_tiles=12,
                s2_resize_output_to_scale_idx=-1),
           "mlp_downsample_3x3_fix", 2, 16),
    "video": (dict(num_video_frames=64,
                   video_encoder={"_target_": TSP_TARGET, "pool_sizes": [[4, 1, 1]]}),
              "mlp_downsample", 2, 32),
}
S2_IMAGE = (1008, 1344, 3)  # 4:3: 1 + 4 + 12 tiles of 448², a 3 x 4 block grid
VIDEO_FRAME = (720, 1280, 3)


def media_config(kind, serving, dev="cuda"):
    """The phase's VLMConfig through `entry.build_config`: the serving
    configuration's (`serving`, the e2e engine's) component configs
    (`entry.save_config`) under the git-ignored `runs/`, the top-level
    config.json given the phase's fields, read back and removed."""
    import dataclasses
    import shutil
    import tempfile

    from vila_tpu_torch import entry

    fields, ptype, _, _ = MEDIA_PHASES[kind]
    base = dataclasses.replace(
        serving, projector=dataclasses.replace(serving.projector, projector_type=ptype))
    os.makedirs("runs", exist_ok=True)
    d = tempfile.mkdtemp(prefix=f"{kind}_cfg_", dir="runs")
    try:
        entry.save_config(base, d)
        with open(os.path.join(d, "config.json")) as f:
            top = json.load(f)
        top.pop("mm_hidden_size")
        top.update(fields)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(top, f)
        cfg = entry.build_config(d, dtype=base.llm.dtype, device=dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if (cfg.llm, cfg.vision) != (base.llm, base.vision):
        raise RuntimeError(f"build_config read back another model: {cfg}")
    return cfg


class plain_versions:
    """The reference side of a comparison on the card: while active, the
    W4 wrappers compute their plain versions (`quant._w4_gemv_ref`,
    `_w4_gemm_ref`) on the card's tensors, and no kernel may launch. The
    port's wrappers never do this themselves."""

    def __enter__(self):
        from vila_tpu_torch.ops import _build, quant

        self.quant, self.saved = quant, (quant.w4_matmul_decode, quant.w4_matmul_prefill)
        self.before = dict(_build.LAUNCHES)
        quant.w4_matmul_decode = (lambda x, packed, scales, act_digits=2, layer_index=None:
                                  quant._w4_gemv_ref(x, packed, scales, layer_index))
        quant.w4_matmul_prefill = (lambda x, packed, scales, layer_index=None:
                                   quant._w4_gemm_ref(x, packed, scales, layer_index))
        return self

    def __exit__(self, *exc):
        from vila_tpu_torch.ops import _build

        self.quant.w4_matmul_decode, self.quant.w4_matmul_prefill = self.saved
        if exc[0] is None and dict(_build.LAUNCHES) != self.before:
            raise RuntimeError("a kernel launched inside plain_versions")
        return False


def plain_media_embeds(torch, engine, entry):
    """One media entry's embeddings through the reference's own
    formulation, from the same tower and projector: the dynamic-S2 merge
    as llava_arch.py:256-394 writes it (chessboard merge of NCHW maps,
    `F.interpolate(mode="area")`, concatenated channels, chessboard split,
    projector, merge), TSP as a 3-D average pool of the projected frames
    (video/tsp.py:11-13)."""
    from vila_tpu_torch.models import projector, siglip, vlm

    F = torch.nn.functional
    cfg, params = engine.cfg, engine.params
    tiles = torch.as_tensor(entry["tiles"], device=engine.device)
    if entry["kind"] == "tsp":
        x = vlm.encode_images(params, cfg, tiles)  # (T, S, D)
        t, n_tok, d = x.shape
        nl = int(round(n_tok ** 0.5))
        x = x.reshape(t, nl, nl, d).permute(3, 0, 1, 2)[None].float()
        out = [F.avg_pool3d(x, tuple(ps))[0].permute(1, 2, 3, 0).reshape(-1, d)
               for ps in entry["pool_sizes"]]
        return torch.cat(out).to(cfg.projector.compute_dtype)
    feats = siglip.forward(params["vision_tower"], cfg.vision, tiles,
                           feature_layer=cfg.vision_feature_layer, select=cfg.vision_select)
    n, n_tok, c = feats.shape
    side = int(round(n_tok ** 0.5))

    def merge(x, gh, gw):  # (gh*gw, C, side, side) -> (1, C, gh*side, gw*side)
        return x.reshape(gh, gw, c, side, side).permute(2, 0, 3, 1, 4).reshape(
            1, c, gh * side, gw * side)

    chw = feats.reshape(n, side, side, c).permute(0, 3, 1, 2)
    grids = [s // cfg.s2_scales[0] for s in cfg.s2_scales[:-1]]
    maps, i = [], 0
    for g in grids:
        maps.append(merge(chw[i:i + g * g], g, g))
        i += g * g
    bh, bw = entry["block_size"]
    maps.append(merge(chw[i:i + bh * bw], bh, bw))
    out_idx = cfg.s2_resize_output_to_scale_idx
    th, tw = maps[out_idx].shape[2:]
    merged = torch.cat([F.interpolate(m.float(), size=(th, tw), mode="area").to(m.dtype)
                        for m in maps], dim=1)[0]  # (C * scales, th, tw)
    obh, obw = (bh, bw) if out_idx in (-1, len(cfg.s2_scales) - 1) else (grids[out_idx],) * 2
    ch = merged.shape[0]
    blocks = merged.reshape(ch, obh, th // obh, obw, tw // obw).permute(1, 3, 2, 4, 0)
    blocks = blocks.reshape(obh * obw, (th // obh) * (tw // obw), ch)
    proj = projector.forward(params["mm_projector"], cfg.projector, blocks)
    k = int(round(proj.shape[1] ** 0.5))
    return proj.reshape(obh, obw, k, k, -1).permute(0, 2, 1, 3, 4).reshape(-1, proj.shape[-1])


def _int8_products_exact(torch, quant, siglip, vt8, vcfg, tiles):
    """Layer 0's q and fc1 int8 products of the W8A8 tower at the phase's
    row count (tiles x 1024), `torch._int_mm` against an f64 product on the
    card (exact: every int8 x int8 sum is far below 2^53)."""
    from vila_tpu_torch.ops.norms import layer_norm

    lp = {k: {n: v[0] for n, v in slot.items()} for k, slot in vt8["layers"].items()}
    h = siglip.embed_pixels(vt8, vcfg, tiles)
    x = layer_norm(h, lp["layer_norm1"]["scale"], lp["layer_norm1"]["bias"], vcfg.layer_norm_eps)
    out = {}
    for name in ("q_proj", "fc1"):
        xq, _ = quant.w8a8_activations(x)
        xq = xq.reshape(-1, xq.shape[-1])
        acc = quant.int8_matmul(xq, lp[name]["w8"])
        want = (xq.double() @ lp[name]["w8"].double()).to(torch.int32)
        out[f"{name} ({xq.shape[0]}x{xq.shape[1]}x{acc.shape[1]})"] = bool(torch.equal(acc, want))
        del acc, want
    return out


def media_engine(torch, e2e, vt8, seed, kind, dev="cuda"):
    """(engine, prompt(i), whether the config has the phase's widths) of a
    media phase: the config through `media_config`, the e2e engine's W4
    LLM, the W8A8 tower `vt8`, the phase's projector (s2: its own, seeded;
    video: the e2e engine's) and its seeded media."""
    import numpy as np

    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.media import Video
    from vila_tpu_torch.models import projector

    n_requests = MEDIA_PHASES[kind][2]
    cfg = media_config(kind, e2e.cfg, dev)
    if kind == "s2":
        gen = torch.Generator(device=dev).manual_seed(seed + 20)
        proj = projector.init_params(gen, cfg.projector, torch.bfloat16)
        want_cfg = (cfg.projector.mm_hidden_size == 3 * cfg.vision.hidden_size
                    and cfg.tokens_per_image == 121 and cfg.image_aspect_ratio == "dynamic_s2")
        rng = np.random.default_rng(seed + 21)
        media = [rng.integers(0, 256, S2_IMAGE, dtype=np.uint8) for _ in range(n_requests + 1)]
    else:
        proj = e2e.params["mm_projector"]
        want_cfg = (cfg.video_encoder == "tsp" and cfg.tsp_pool_sizes == ((4, 1, 1),)
                    and cfg.num_video_frames == 64 and cfg.tokens_per_image == 256)
        rng = np.random.default_rng(seed + 22)
        frames = [rng.integers(0, 256, VIDEO_FRAME, dtype=np.uint8) for _ in range(64)]
        media = [Video(frames)] * (n_requests + 1)
    log(f"[{kind}] entry.build_config: aspect {cfg.image_aspect_ratio}, scales "
        f"{cfg.s2_scales}, projector {cfg.projector.projector_type} over "
        f"{cfg.projector.mm_hidden_size}, {cfg.tokens_per_image} tokens a tile, video "
        f"{cfg.video_encoder} {cfg.tsp_pool_sizes} x {cfg.num_video_frames} frames "
        f"{'OK' if want_cfg else 'FAIL'}")
    engine = GenerationEngine({"llm": e2e.params["llm"], "vision_tower": vt8,
                               "mm_projector": proj}, cfg, e2e.tokenizer, device=dev)
    return engine, lambda i: [media[i], QUESTIONS[i % len(QUESTIONS)]], want_cfg


def ttft_parts(torch, engine, inputs, new_tokens):
    """(encode, prefill): the device parts of a request's TTFT as two
    calls, the media encode (tower, merge or pooling, projector) and the
    prefill (cache, K2, attention) over the padded prompt."""
    from vila_tpu_torch.inference.generate import (PROMPT_BUCKETS, _bucket, _round_up,
                                                   padded_prompt)
    from vila_tpu_torch.models import qwen2

    n_prompt = int(inputs["input_ids"].shape[0])
    s_pad = _bucket(n_prompt, PROMPT_BUCKETS)
    ids, valid, mpos = padded_prompt(inputs, s_pad, engine.device)
    emb = engine.encode_media(inputs["media"])
    cache_len = min(engine.max_cache_len, _round_up(s_pad + new_tokens, 256))

    def prefill():
        cache = qwen2.init_cache(engine.cfg.llm, 1, cache_len, device=engine.device)
        return engine._prefill(ids, valid, emb, mpos, cache, n_prompt)

    return (lambda: engine.encode_media(inputs["media"])), prefill


def phase_media(torch, e2e, vt8, seed, kind, dev="cuda"):
    """NVILA-8B's own media paths at full width and depth through the entry
    points: `entry.build_config` (the phase's fields), `prepare_inputs`
    (PIL dynamic-S2 tiling of a 1344 x 1008 image, or 64 seeded 720 x 1280
    frames through the native resize), `encode_media` (the W8A8 tower,
    TinyChat's: `vt8`, the e2e engine's tower quantized), K2 prefill, K3 +
    K1 decode; the W4 LLM is the e2e engine's (`media_engine`). Checks: the
    config's widths, the prompt's layout, exact K1-K3 launches, the media
    embeddings against the reference's formulation (`plain_media_embeds`),
    layer 0's int8 products exact, and request 0's greedy tokens against a
    cache-free forward through the plain versions on the card. Times the
    tower bf16 and W8A8 on the phase's tiles, and TTFT's device parts."""
    from vila_tpu_torch.inference.generate import PROMPT_BUCKETS, _bucket
    from vila_tpu_torch.models import siglip
    from vila_tpu_torch.ops import quant

    n_requests, new_tokens = MEDIA_PHASES[kind][2:]
    out, ok = {}, True
    torch.cuda.reset_peak_memory_stats()
    engine, prompt, want_cfg = media_engine(torch, e2e, vt8, seed, kind, dev)
    cfg = engine.cfg
    ok &= want_cfg

    # the prompt's layout
    t0 = time.perf_counter()
    inputs = engine.prepare_inputs(prompt(0))
    prep_ms = (time.perf_counter() - t0) * 1e3
    entry = inputs["media"][0]
    n_media, n_prompt = len(inputs["media_pos"]), int(inputs["input_ids"].shape[0])
    s_pad = _bucket(n_prompt, PROMPT_BUCKETS)
    if kind == "s2":
        layout = (entry["kind"] == "s2" and entry["tiles"].shape == (17, 448, 448, 3)
                  and tuple(entry["block_size"]) == (3, 4) and n_media == 12 * 121
                  and s_pad == 1536)
    else:
        layout = (entry["kind"] == "tsp" and entry["tiles"].shape == (64, 448, 448, 3)
                  and n_media == 16 * 256 and s_pad == 8192)
    ok &= layout
    out.update(prompt_tokens=n_prompt, media_tokens=n_media, bucket=s_pad,
               tiles=list(entry["tiles"].shape), prepare_ms=prep_ms)
    log(f"[{kind}] prepare_inputs in {prep_ms:.1f} ms: {entry['kind']} entry of "
        f"{entry['tiles'].shape[0]} tiles {entry.get('block_size', '')}, {n_media} media "
        f"tokens, prompt {n_prompt} tokens -> bucket {s_pad} {'OK' if layout else 'FAIL'}")

    # media embeddings, the int8 products, the tower's time
    got = engine.encode_media(inputs["media"])
    want = plain_media_embeds(torch, engine, entry)
    err, ref = rel_err(torch, got, want)
    emb_ok = (got.shape == want.shape == (n_media, cfg.llm.hidden_size)
              and bool(torch.isfinite(got.float()).all()) and err <= 1e-2 * ref)
    ok &= emb_ok
    tiles = torch.as_tensor(entry["tiles"], device=dev)
    exact = _int8_products_exact(torch, quant, siglip, vt8, cfg.vision, tiles)
    ok &= all(exact.values())

    def tower(vp):
        return siglip.forward(vp, cfg.vision, tiles, feature_layer=cfg.vision_feature_layer,
                              select=cfg.vision_select)

    bf16_ms = time_ms(torch, lambda: tower(e2e.params["vision_tower"]), 3)
    w8_ms = time_ms(torch, lambda: tower(vt8), 3)
    out.update(embeds_max_abs_err=err, embeds_max_abs=ref, embeds_tol_rel=1e-2,
               int8_exact=exact, tower_bf16_ms=bf16_ms, tower_w8a8_ms=w8_ms)
    log(f"[{kind}] encode_media {tuple(got.shape)} against the reference's formulation "
        f"(plain_media_embeds): max |d| {err:.3e} of max |ref| {ref:.3e} (tolerance 1e-2 x "
        f"max|ref|) {'OK' if emb_ok else 'FAIL'}; W8A8 layer-0 int8 products equal to f64: "
        f"{exact}; tower over {tiles.shape[0]} tiles: bf16 {bf16_ms:.2f} ms, W8A8 "
        f"{w8_ms:.2f} ms (CUDA events, median of 3)")
    del got, want, tiles

    # serve, with exact launches
    good, reqs, launches = phase_e2e(torch, engine, seed, n_requests, new_tokens, tag=kind,
                                     prompt=prompt)
    ok &= good
    out["requests"] = reqs

    encode, prefill = ttft_parts(torch, engine, inputs, new_tokens)
    out["encode_ms"] = time_ms(torch, encode, 2)
    out["prefill_ms"] = time_ms(torch, prefill, 2)
    del encode, prefill
    log(f"[{kind}] TTFT parts for request 0's prompt: host inputs {reqs[0]['inputs_ms']:.1f} "
        f"ms, encode_media {out['encode_ms']:.1f} ms, prefill over {s_pad} rows "
        f"{out['prefill_ms']:.1f} ms (CUDA events, median of 2), TTFT {reqs[0]['ttft_ms']:.1f} ms")

    # request 0's greedy tokens against the plain versions on the card
    with plain_versions():
        g = greedy_against_plain(torch, engine.params["llm"], cfg.llm, inputs,
                                 engine.encode_media(inputs["media"]), reqs[0]["ids"],
                                 attn_impl="blocked")
    ok &= g["ok"]
    out.update(greedy_exact=g["exact"], greedy_margins=g["margins"], greedy_tol=g["tol"],
               greedy_ok=g["ok"], peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[{kind}] request 0's {len(reqs[0]['ids'])} greedy tokens against a cache-free "
        f"forward through the plain versions on the card ({g['seconds']:.1f} s): argmax "
        f"equal on {g['exact']}/{len(reqs[0]['ids'])} steps; largest top-minus-served margin "
        f"{max(g['margins']):.4f} (tolerance 2^-7 max|logit| = {g['tol']:.4f}) "
        f"{'OK' if g['ok'] else 'FAIL'}; peak {out['peak_gib']:.2f} GiB allocated")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return ok, out, launches


def phase_media_profile(torch, e2e, vt8, seed, kind, dev="cuda"):
    """(only when named) torch.profiler traces of one media request's two
    device parts of TTFT, the media encode and the prefill: device busy
    time against the host clock, and the operations by device time
    (tables in chiprun_out/media_profile_<kind>.txt)."""
    from torch.profiler import ProfilerActivity, profile

    engine, prompt, _ = media_engine(torch, e2e, vt8, seed, kind, dev)
    inputs = engine.prepare_inputs(prompt(0))
    encode, prefill = ttft_parts(torch, engine, inputs, MEDIA_PHASES[kind][3])
    out = {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"media_profile_{kind}.txt"), "w") as f:
        for part, fn in (("encode_media", encode), ("prefill", prefill)):
            fn()  # warm-up
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            # the device's kernels and copies by name (the operators that
            # launched them and the profiler's own markers not counted twice)
            by_name = {}
            for e in prof.events():
                if (e.device_type == torch.autograd.DeviceType.CUDA
                        and e.name != "Command Buffer Full"):
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
            ops = sorted(by_name.items(), key=lambda kv: -kv[1])
            busy = sum(by_name.values())
            out[part] = dict(wall_ms=wall, busy_ms=busy, top=ops[:12])
            f.write(f"==== {kind} {part}: wall {wall:.1f} ms, device busy {busy:.1f} ms\n")
            f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
            log(f"[media_profile] {kind} {part}: wall {wall:.1f} ms, device busy {busy:.1f} "
                f"ms; kernels by device time: " + "; ".join(f"{k[:70]} {ms:.1f}"
                                                             for k, ms in ops[:10]))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return out


def synth_bf16_params(torch, cfg, seed, device):
    """Unquantized bf16 VLM params at `cfg`'s widths on `device` (what a
    checkpoint holds): normal(0.02) kernels as `init_params` draws them,
    norm scales around 1 and biases around 0 drawn too, so that a load
    that drops or swaps a leaf shows."""
    from vila_tpu_torch.models import vlm

    gen = torch.Generator(device=device).manual_seed(seed)
    params = vlm.init_params(gen, cfg, torch.bfloat16)

    def perturb(tree, key=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v, k)
            elif k in ("scale", "bias"):
                r = torch.randn(v.shape, generator=gen, device=device)
                tree[k] = ((1.0 if k == "scale" else 0.0) + (0.1 if k == "scale" else 0.02)
                           * r).to(torch.bfloat16)
        return tree

    return perturb(params)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def _w8a8_layer0(torch, quant, siglip, vt8, vcfg, pixels):
    """Every layer-0 W8A8 product of the tower on its real inputs (one
    image through layer 0), on the card against the plain version on the
    CPU: activations, int32 accumulators and outputs must be equal."""
    calls = []
    real = siglip._linear
    siglip._linear = lambda x, p, dtype: calls.append((x, p, dtype)) or real(x, p, dtype)
    try:
        siglip.forward(vt8, vcfg, pixels, feature_layer=1)
    finally:
        siglip._linear = real
    calls = [c for c in calls if "w8" in c[1]]  # not the patch embedding's
    if len(calls) != 6:
        raise RuntimeError(f"layer 0 made {len(calls)} W8A8 products, not 6")
    rows = []
    for (x, p, dtype), name in zip(calls, ("q", "k", "v", "out", "fc1", "fc2")):
        pc = {k: v.cpu() for k, v in p.items()}
        xq, a = quant.w8a8_activations(x)
        acc = quant.int8_matmul(xq.reshape(-1, xq.shape[-1]), p["w8"])
        xq_c, a_c = quant.w8a8_activations(x.cpu())
        acc_c = quant.int8_matmul(xq_c.reshape(-1, xq_c.shape[-1]), pc["w8"])
        y = quant.w8a8_linear(x, p, dtype)
        y_c = quant.w8a8_linear(x.cpu(), pc, dtype)
        rows.append(dict(
            product=name, m=int(acc.shape[0]), k=int(xq.shape[-1]), n=int(acc.shape[1]),
            activations_equal=bool(torch.equal(xq.cpu(), xq_c) and torch.equal(a.cpu(), a_c)),
            acc_equal=bool(torch.equal(acc.cpu(), acc_c)),
            out_equal=bool(torch.equal(y.cpu(), y_c))))
    return rows


def greedy_against_plain(torch, llm, lcfg, inputs, media, ids, attn_impl="auto"):
    """The served greedy tokens `ids` of a prepared request against the
    argmax of one cache-free forward over the prompt (its media
    embeddings `media` spliced in) plus `ids[:-1]`, on `llm`'s device.
    Both sides round the W4 lm_head's logits to bf16 after f32 sums in
    another order, so two tokens within one bf16 ulp of the top are a tie
    either side may break (ROADMAP §3): a served token counts if the plain
    forward puts it within K1's tolerance, 2^-7 max|logit|, of its top
    logit. The exact agreement is reported beside it."""
    from vila_tpu_torch.models import qwen2, vlm

    dev = llm["embed_tokens"]["embedding"].device
    prompt = torch.as_tensor(inputs["input_ids"], device=dev)[None].long()
    n = prompt.shape[1]
    embeds = vlm.splice_media(qwen2.embed_tokens(llm, lcfg, prompt), media.to(dev),
                              torch.as_tensor(inputs["media_pos"], device=dev).long())
    full = torch.cat([embeds, qwen2.embed_tokens(
        llm, lcfg, torch.tensor([ids[:-1]], device=dev))], dim=1)
    t0 = time.time()
    h, _ = qwen2.forward(llm, lcfg, inputs_embeds=full, return_hidden=True,
                         attn_impl=attn_impl)
    logits = qwen2.compute_logits(llm, lcfg, h[:, n - 1:])[0].float().cpu()
    plain = logits.argmax(-1).tolist()
    tol = 2.0 ** -7 * float(logits.abs().max())
    margins = (logits.max(-1).values - logits[torch.arange(len(ids)), ids]).tolist()
    return dict(plain=plain, exact=sum(p == t for p, t in zip(plain, ids)), margins=margins,
                tol=tol, ok=all(m <= tol for m in margins), seconds=time.time() - t0,
                max_logit=float(logits.abs().max()))


def phase_load(torch, seed, dev="cuda", layers=4, n_requests=2, new_tokens=16,
               full_layers=28, steps=8, cfg=None):
    """The loader on the card at NVILA-8B width (LLM depth cut to `layers`):
    unquantized bf16 parameters synthesised from a seed of their own are
    written with `entry.save` and read back with `entry.build_config` /
    `entry.load_params` (config equal, every leaf bit for bit); the LLM is
    quantized on the card (layer 0's fused slots and the lm_head bit for bit
    against the CPU), the tower to W8A8 (layer 0's products against the
    plain version, bf16 and W8A8 encode timed); the engine over them serves
    `n_requests` image + prompt requests with exact K1-K3 launches, and one
    request's first `steps` tokens must be the argmax of a cache-free plain
    forward on the CPU. Last, the quantizer's peak memory on a
    `full_layers`-deep bf16 LLM. The checkpoint goes under the git-ignored
    `runs/` and is removed at the end, pass or fail."""
    import dataclasses
    import shutil
    import tempfile

    from vila_tpu_torch import entry
    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import qwen2, siglip, vlm
    from vila_tpu_torch.ops import quant
    from vila_tpu_torch.utils.weights import to_torch_tree

    import numpy as np

    cfg = cfg or nvila_8b_config(layers)
    cpu = torch.device("cpu")
    out, ok = {}, True
    os.makedirs("runs", exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="load_ckpt_", dir="runs")
    try:
        # 1. write
        t0 = time.time()
        params = synth_bf16_params(torch, cfg, seed + 100, dev)
        torch.cuda.synchronize()
        t_synth = time.time() - t0
        t0 = time.time()
        nbytes = entry.save(params, cfg, None, ckpt)
        out.update(write_s=time.time() - t0, bytes=nbytes, synth_s=t_synth)
        log(f"[load] wrote {nbytes / 1e9:.3f} GB (f32) with entry.save in "
            f"{out['write_s']:.1f} s ({nbytes / 1e9 / out['write_s']:.2f} GB/s; bf16 "
            f"params synthesised on the card in {t_synth:.1f} s)")

        # 2. load
        got_cfg = entry.build_config(ckpt)
        diff = [f.name for f in dataclasses.fields(cfg)
                if getattr(got_cfg, f.name) != getattr(cfg, f.name)]
        t0 = time.time()
        loaded = entry.load_params(ckpt, got_cfg, device=dev)
        out["load_s"] = time.time() - t0
        want = dict(_leaves(params))
        got = dict(_leaves(loaded))
        bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
               or not torch.equal(got[k], want[k])] + [k for k in got if k not in want]
        out.update(config_equal=not diff, leaves=len(want), leaves_unequal=bad)
        ok &= not diff and not bad
        log(f"[load] build_config equals the written config: {not diff} {diff or ''}; "
            f"load_params in {out['load_s']:.1f} s ({nbytes / 1e9 / out['load_s']:.2f} "
            f"GB/s): {len(want) - len(bad)}/{len(want)} leaves bit-equal to the "
            f"synthesised bf16 tree {'OK' if not bad else 'FAIL ' + str(bad[:4])}")
        del params, want, got

        # 3. quantize: on the card, and layer 0 + the lm_head on the CPU
        t0 = time.time()
        llm_q = quant.quantize_llm_params(loaded["llm"], fuse=True, cfg=got_cfg.llm)
        torch.cuda.synchronize()
        out["quantize_s"] = time.time() - t0
        src = loaded["llm"]
        l0 = {"embed_tokens": src["embed_tokens"], "norm": src["norm"],
              "lm_head": {"kernel": src["lm_head"]["kernel"].cpu()},
              "layers": {n: {k: v[:1].cpu() for k, v in slot.items()}
                         for n, slot in src["layers"].items()}}
        t0 = time.time()
        q_cpu = quant.quantize_llm_params(l0, fuse=True, cfg=got_cfg.llm)
        t_cpu = time.time() - t0
        slots = [("layers", n) for n in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")]
        q_bad = []
        for where, n in slots + [(None, "lm_head")]:
            card = llm_q[where][n] if where else llm_q[n]
            plain = q_cpu[where][n] if where else q_cpu[n]
            for k in ("packed", "scales"):
                c = card[k][0] if where else card[k]
                pl = plain[k][0] if where else plain[k]
                if not torch.equal(c.cpu(), pl):
                    q_bad.append(f"{n}.{k}")
        out.update(quantize_cpu_s=t_cpu, quantized_unequal=q_bad)
        ok &= not q_bad
        log(f"[load] quantize_llm_params on the card in {out['quantize_s']:.2f} s; layer "
            f"0's four fused slots and the lm_head on the CPU ({t_cpu:.1f} s): packed "
            f"bytes and scales equal {'OK' if not q_bad else 'FAIL ' + str(q_bad)}")

        # 4. the W8A8 tower
        vt8 = siglip.quantize_siglip_w8a8(loaded["vision_tower"])
        side = got_cfg.vision.image_size
        img = torch.as_tensor(np.random.default_rng(seed + 8).integers(
            0, 256, (1, side, side, 3), dtype=np.uint8), device=dev)
        rows = _w8a8_layer0(torch, quant, siglip, vt8, got_cfg.vision, img)
        w8_ok = all(r["activations_equal"] and r["acc_equal"] and r["out_equal"] for r in rows)
        ok &= w8_ok

        def tower(vp):
            return siglip.forward(vp, got_cfg.vision, img,
                                  feature_layer=got_cfg.vision_feature_layer,
                                  select=got_cfg.vision_select)

        bf16_ms = time_ms(torch, lambda: tower(loaded["vision_tower"]), 10)
        w8_ms = time_ms(torch, lambda: tower(vt8), 10)
        issue = {}
        for tag, vp in (("bf16", loaded["vision_tower"]), ("w8a8", vt8)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tower(vp)  # the host's issue time: the call returns before the card ends
            issue[tag] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        f_bf, f_w8 = tower(loaded["vision_tower"]), tower(vt8)
        err, ref = rel_err(torch, f_w8, f_bf)
        out.update(w8a8_products=rows, tower_bf16_ms=bf16_ms, tower_w8a8_ms=w8_ms,
                   tower_issue_ms=issue, tower_rel_err=err / ref)
        log(f"[load] W8A8 layer-0 products {[(r['product'], r['m'], r['k'], r['n']) for r in rows]}: "
            f"int8 activations, int32 accumulators and outputs equal to the plain "
            f"version on the CPU: {'OK' if w8_ok else 'FAIL ' + str(rows)}")
        log(f"[load] one {side}x{side} image through the tower ({got_cfg.vision.num_hidden_layers} "
            f"layers, feature layer {got_cfg.vision_feature_layer}): bf16 {bf16_ms:.3f} ms, "
            f"W8A8 {w8_ms:.3f} ms (CUDA events; the host issues one call in "
            f"{issue['bf16']:.1f} / {issue['w8a8']:.1f} ms); features max|W8A8 - bf16| / "
            f"max|bf16| = {err / ref:.4f}")

        # 5. serve the loaded W4 LLM + W8A8 tower
        served = {"llm": llm_q, "vision_tower": vt8, "mm_projector": loaded["mm_projector"]}
        engine = GenerationEngine(served, got_cfg, ByteTokenizer(), device=dev)
        good, reqs, launches = phase_e2e(torch, engine, seed + 7, n_requests, new_tokens,
                                         tag="load")
        ok &= good
        out["requests"] = reqs
        images = _images(seed + 7, n_requests + 1)
        inputs = engine.prepare_inputs([images[0], QUESTIONS[0]])
        ids = reqs[0]["ids"][:steps]
        llm_cpu = to_torch_tree(llm_q, cpu)
        g = greedy_against_plain(torch, llm_cpu, got_cfg.llm, inputs,
                                 engine.encode_media(inputs["media"]).cpu(), ids)
        ok &= g["ok"]
        out.update(greedy_exact=g["exact"], greedy_margins=g["margins"], greedy_tol=g["tol"],
                   greedy_ok=g["ok"], ttft_ms=[r["ttft_ms"] for r in reqs],
                   decode_tok_s=[r["decode_tok_s"] for r in reqs])
        log(f"[load] request 0's first {steps} greedy tokens {ids} against a cache-free "
            f"plain forward on the CPU ({g['seconds']:.1f} s): its argmax {g['plain']} "
            f"equal on {g['exact']}/{steps} steps; top logit minus the served token's "
            f"{[round(m, 4) for m in g['margins']]} (tolerance 2^-7 max|logit| = "
            f"{g['tol']:.4f}) {'OK' if g['ok'] else 'FAIL'}")
        del engine, served, llm_q, llm_cpu, vt8, loaded, src, l0, q_cpu
        gc.collect()
        torch.cuda.empty_cache()

        # 6. the quantizer's peak memory at full depth
        big_cfg = dataclasses.replace(cfg.llm, num_hidden_layers=full_layers)
        gen = torch.Generator(device=dev).manual_seed(seed + 101)
        big = qwen2.init_params(gen, big_cfg, torch.bfloat16)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        tree = sum(v.numel() * v.element_size() for _, v in _leaves(big))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        q = quant.quantize_llm_params(big, fuse=True, cfg=big_cfg)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        qbytes = sum(v.numel() * v.element_size() for k, v in _leaves(q)
                     if "packed" in k or "scales" in k)
        out.update(full_quantize_s=time.time() - t0, full_tree_gb=tree / 1e9,
                   full_peak_gib=peak / 2**30, full_base_gib=base / 2**30,
                   full_slots_gb=qbytes / 1e9)
        fits = peak < 80e9
        ok &= fits
        log(f"[load] quantize_llm_params on a {full_layers}-layer bf16 LLM ({tree / 1e9:.2f} "
            f"GB) on the card in {out['full_quantize_s']:.2f} s: peak "
            f"{peak / 2**30:.2f} GiB allocated (of which {base / 2**30:.2f} GiB before it: "
            f"the tree and the serving engines), W4 slots {qbytes / 1e9:.2f} GB "
            f"{'OK' if fits else 'FAIL'}")
        del big, q
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return ok, out, launches


def phase_profile(torch, engine, seed, new_tokens=17):
    """Trace one request's decode with torch.profiler: device busy time per
    decode step against the host clock (the device's idle share), and the
    kernels by device time (table in chiprun_out/profile.txt)."""
    from torch.profiler import ProfilerActivity, profile

    from vila_tpu_torch.inference.generate import GenerationConfig

    layers = engine.cfg.llm.num_hidden_layers
    inputs = engine.prepare_inputs([_images(seed, 1)[0], "Describe the image."])

    def run(n):
        gc = GenerationConfig(max_new_tokens=n, stop_token_ids=(-1,))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.generate_ids(inputs, gc)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages())
        return wall * 1e3, busy / 1e3, prof

    run(new_tokens)  # warm-up
    w1, b1, _ = run(1)
    wn, bn, prof = run(new_tokens)
    steps = new_tokens - 1
    step_wall, step_busy = (wn - w1) / steps, (bn - b1) / steps
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    log(f"[profile] prefill request (1 token): wall {w1:.1f} ms, device busy {b1:.1f} ms; "
        f"decode step: wall {step_wall:.2f} ms, device busy {step_busy:.2f} ms, "
        f"device idle {100 * (1 - step_busy / step_wall):.0f}% (traced, {layers} layers)")
    return dict(prefill_wall_ms=w1, prefill_busy_ms=b1, step_wall_ms=step_wall,
                step_busy_ms=step_busy)


def phase_profile_batched(torch, engine, max_batch=8, warmup=2):
    """(only with `profile`) One decode step of a full `max_batch` batch
    (K6 at every layer, K1 for the lm_head at M = max_batch), fed as the
    batcher feeds it: host clock of the step unprofiled (the issue time,
    then the wall to the synchronise), then the same step under
    torch.profiler: device busy time (the kernels' own intervals), its
    share of the step wall, the host time per layer, and the kernels by
    device time (chiprun_out/profile_batched.txt)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    device, cfg = engine.device, engine.cfg
    llm, lcfg = engine.params["llm"], cfg.llm
    layers = lcfg.num_hidden_layers
    batcher = ContinuousBatcher(engine, max_batch=max_batch, max_len=2048)  # never started
    first, n = [], []
    for i in range(max_batch):
        inputs = engine.prepare_inputs(f"Row {i}: " + "tell me more " * (4 + 3 * i))
        _, cache1, tok, plen = batcher._prepare(_greedy_request(inputs))
        batcher._insert(i, cache1)
        first.append(tok)
        n.append(plen)
    del cache1
    cache = batcher.cache
    toks = torch.tensor(first, device=device)
    pos = torch.tensor(n, dtype=torch.int32, device=device)
    j = 0

    def step():
        nonlocal cache, toks, j
        logits, cache = qwen2.forward(llm, lcfg, input_ids=toks[:, None],
                                      positions=(pos + j)[:, None], cache=cache)
        toks = logits[:, 0].argmax(-1)
        j += 1

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    issue = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "profile_batched.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    del batcher, cache
    log(f"[profile b{max_batch}] one decode step, {layers} layers: wall {1e3 * wall:.2f} ms "
        f"unprofiled (host issue {1e3 * issue:.2f} ms, {1e3 * issue / layers:.3f} ms per "
        f"layer); traced wall {1e3 * traced:.2f} ms, device busy {busy:.2f} ms "
        f"({100 * busy / (1e3 * wall):.0f}% of the unprofiled wall, "
        f"{100 * busy / (1e3 * traced):.0f}% of the traced)")
    return dict(max_batch=max_batch, step_wall_ms=1e3 * wall, host_issue_ms=1e3 * issue,
                host_ms_per_layer=1e3 * issue / layers, traced_ms=1e3 * traced,
                device_busy_ms=busy)


# --------------------------------------------------------------------------
# Training (NVILA-Lite-2B SFT)
# --------------------------------------------------------------------------


def nvila_lite_2b_config(layers=28, vision_layers=27):
    """NVILA-Lite-2B shape (`__graft_entry__._flagship_cfg`): Qwen2-1.5B LLM
    (tied embeddings, vocab 151936 + 64), SigLIP-SO400M-448,
    mlp_downsample; bf16 compute over f32 master weights."""
    from vila_tpu_torch.models import projector, qwen2, siglip, vlm

    llm = qwen2.LLMConfig(
        vocab_size=151936 + 64, hidden_size=1536, intermediate_size=8960,
        num_hidden_layers=layers, num_attention_heads=12, num_key_value_heads=2,
        rope_theta=1e6, tie_word_embeddings=True, dtype="bfloat16",
    )
    vis = siglip.SigLIPConfig(num_hidden_layers=vision_layers, dtype="bfloat16")
    proj = projector.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=1152,
                                     hidden_size=1536, dtype="bfloat16")
    return vlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def train_flops_per_token(cfg, seq):
    """bench.py's model-FLOPs count (bench.py:240-243) with this model's
    P, L, H and S: 6 P + 12 L H S (the LLM; the vision tower is not
    counted)."""
    llm = cfg.llm
    D, I, hd = llm.hidden_size, llm.intermediate_size, llm.head_dim_
    Hq, Hkv, L = llm.num_attention_heads, llm.num_key_value_heads, llm.num_hidden_layers
    p_layer = D * (Hq + 2 * Hkv) * hd + Hq * hd * D + 3 * D * I
    P = L * p_layer + llm.vocab_size * D
    return 6 * P + 12 * L * D * seq


def _packed_segments(torch, s, dev):
    """(1, s) int32: three packed samples (40 %, 35 %, 20 % of the row) and
    a tail of collator padding (segment 0)."""
    cuts = [int(s * f) for f in (0.4, 0.75, 0.95)]
    seg = torch.zeros((1, s), dtype=torch.int32, device=dev)
    seg[:, :cuts[0]] = 1
    seg[:, cuts[0]:cuts[1]] = 2
    seg[:, cuts[1]:cuts[2]] = 3
    return seg


def _shuffled_runs(torch, s, dev, seed, run=24, n_ids=9):
    """(1, s) int32: runs of `run` rows whose ids (0, the padding id, among
    them) come in a shuffled order, so that the tiles' id ranges overlap
    without sharing ids: the skip test must stay conservative."""
    import numpy as np

    ids = np.random.default_rng(seed).integers(0, n_ids, size=(s + run - 1) // run)
    return torch.tensor(np.repeat(ids, run)[:s], dtype=torch.int32, device=dev)[None]


def train_row_segments(torch, seq, dev):
    """(1, seq) int32: the `train` phase's first packed row (DummyDataset
    samples through PackingCollator, padding 0 at the tail)."""
    examples, per_step, collator, _ = train_data(torch, nvila_lite_2b_config(), seq)
    seg = collator(examples[:per_step])["segment_ids"]
    return torch.tensor(seg, dtype=torch.int32, device=dev)


# the tiles each kernel walks (all three skip the tiles the masks empty):
# K7 128 q x 128 kv, K8 128 q x 64 kv, K9 64 q x 128 kv
FLASH_TILES = {"flash_fwd": (128, 128), "flash_bwd_dq": (128, 64), "flash_bwd_dkv": (64, 128)}


def live_tiles(fa, seg_q, seg_kv, sq, skv, causal, tiles):
    """(tile pairs walked, tile pairs under the causal cut alone)."""
    tq, tkv = tiles
    qs = None if seg_q is None else seg_q[0].tolist()
    ks = None if seg_kv is None else seg_kv[0].tolist()
    live = total = 0
    for q0 in range(0, sq, tq):
        for kv0 in range(0, skv, tkv):
            if causal and kv0 > q0 + tq - 1:
                continue
            total += 1
            live += fa.tile_may_attend(qs, ks, q0, kv0, tiles, causal)
    return live, total


def phase_train_kernels(torch, seed, dev="cuda", heads=(12, 2), seq=2048, row_seg=None):
    """K7, K8 and K9 against their plain versions (same inputs, on the
    card), each timed beside its plain version and, as the yardstick,
    `scaled_dot_product_attention` (GQA; causal, or not for the cross shape)
    forward and backward. Shapes: B 1, heads of 128, S `seq` with three
    packed segments and a padding tail (the main one); the same at S - 48
    (ragged tiles); causal alone (SDPA's own work); the `train` phase's first
    packed row; short runs of shuffled segment ids; Sq seq/2 against Skv seq,
    not causal. The bound counts this run's work: 2, 3 and 4 products over
    the (q, k) pairs the masks allow."""
    import torch.nn.functional as F

    from vila_tpu_torch.ops import flash_attention as fa

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    hq, hkv = heads
    d = fa.HEAD_DIM
    scale = d ** -0.5
    bf16 = torch.bfloat16
    if row_seg is None:
        row_seg = train_row_segments(torch, seq, dev)
    shapes = [  # (tag, Sq, Skv, causal, segment ids)
        ("3 segments", seq, seq, True, _packed_segments(torch, seq, dev)),
        ("3 segments, ragged", seq - 48, seq - 48, True, _packed_segments(torch, seq - 48, dev)),
        ("causal only", seq, seq, True, None),
        ("train row", seq, seq, True, row_seg.to(dev)),
        ("shuffled ids", seq, seq, True, _shuffled_runs(torch, seq, dev, seed)),
        ("cross, not causal", seq // 2, seq, False, None),
    ]
    results = {name: [] for name in FLASH_KERNELS}
    ok = True
    for tag, s, skv, causal, seg in shapes:
        rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(bf16)  # noqa: E731
        q, k, v, do = rnd(1, s, hq, d), rnd(1, skv, hkv, d), rnd(1, skv, hkv, d), rnd(1, s, hq, d)
        kw = dict(causal=causal, scale=scale)
        out_r, lse_r = fa.flash_fwd_plain(q, k, v, seg, seg, **kw)
        delta = (do.float() * out_r.float()).sum(-1).transpose(1, 2).contiguous()
        bwd = (q, k, v, do, lse_r, delta, seg, seg)
        cases = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, seg, seg, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, seg, seg, **kw), 2),
            "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd, **kw),
                             lambda: fa.flash_bwd_dq_plain(*bwd, **kw), 3),
            "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **kw),
                              lambda: fa.flash_bwd_dkv_plain(*bwd, **kw), 4),
        }
        # the yardstick: one SDPA call in the (B, H, S, D) layout, no segments
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
        qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal, enable_gqa=True)
        sdpa_bwd = lambda: torch.autograd.grad(out_g, (qg, kg, vg), dot,  # noqa: E731
                                               retain_graph=True)
        t_sdpa, t_sdpa_bwd = time_ms(torch, sdpa, 20, flush), time_ms(torch, sdpa_bwd, 20, flush)
        # allowed (q, k) pairs per head, and those of causality alone
        mask = fa._mask(1, s, skv, causal, seg, seg, dev)
        pairs = s * skv if mask is None else int(mask.sum())
        pairs_causal = s * (s + 1) // 2 if causal else s * skv
        counts = None if seg is None else torch.bincount(seg[0].long()).tolist()
        seg_bytes = 0 if seg is None else 4 * seg.numel() * 2
        in_bytes = 2 * (q.numel() + k.numel() + v.numel()) + seg_bytes
        for name, (fn, ref, products) in cases.items():
            got, want = fn(), ref()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            errs = []
            good = True
            for g, w in zip(got, want):
                err, sc = rel_err(torch, g, w)
                # bf16 outputs: 1e-2 x max|ref| (the kernel rounds P and dS
                # at its running tile maxima, the plain version at the row's);
                # the LSE (f32): 1e-3 absolute
                tol = 1e-3 if g.dtype == torch.float32 else 1e-2 * sc
                good &= bool(torch.isfinite(g.float()).all()) and err <= tol
                errs.append(err)
            ok &= good
            t = time_ms(torch, fn, 20, flush)
            t_plain = time_ms(torch, ref, 3, flush)
            flops = products * 2 * hq * d * pairs
            flops_causal = products * 2 * hq * d * pairs_causal
            out_bytes = sum(g.numel() * g.element_size() for g in got)
            extra = 0 if name == "flash_fwd" else 2 * do.numel() + 8 * hq * s  # dO, lse, delta
            b_ms, b_by = bound(in_bytes + extra + out_bytes, flops, BF16_FLOPS)
            lib = t_sdpa if name == "flash_fwd" else t_sdpa_bwd
            live, walk = live_tiles(fa, seg, seg, s, skv, causal, FLASH_TILES[name])
            if name == "flash_bwd_dq":  # no atomics: a second launch repeats dQ bit for bit
                again = fn()
                torch.cuda.synchronize()
                same = torch.equal(again, got[0])
                good &= same
                ok &= same
            results[name].append(dict(
                shape=f"B 1, Sq {s}, Skv {skv}, {hq}/{hkv} heads of {d}, "
                      f"{'causal' if causal else 'not causal'}, {tag}"
                      + ("" if counts is None else f" (segment sizes by id {counts})"),
                m=s, main=tag == "3 segments", max_abs_err=max(errs), ok=good, ms=t,
                plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by,
                bound_ms_causal=bound(in_bytes + extra + out_bytes, flops_causal,
                                      BF16_FLOPS)[0],
                library_ms=lib,
                library=("sdpa forward" if name == "flash_fwd" else
                         "sdpa backward (dq, dk, dv in one call)")
                        + (", causal" if causal else ", not causal"),
                tflops=flops / t / 1e9, allowed_pairs=pairs, tiles_walked=live,
                tiles_causal=walk, tile=FLASH_TILES[name],
                **({"deterministic": same} if name == "flash_bwd_dq" else {})))
            log(f"[train_kernels] {name:13s} {tag:18s} Sq={s}: err {max(errs):.3e} "
                f"{'OK' if good else 'FAIL'}{'' if name != 'flash_bwd_dq' else f' (repeat bit-exact {same})'}"
                f"  kernel {t:.4f} ms ({flops / t / 1e9:.1f} "
                f"TFLOP/s on allowed pairs; tiles {live}/{walk} of "
                f"{FLASH_TILES[name][0]}x{FLASH_TILES[name][1]})  plain {t_plain:.3f} ms  "
                f"{results[name][-1]['library']} {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}; "
                f"causal-only {results[name][-1]['bound_ms_causal']:.4f})")
        del out_g, qg, kg, vg
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "train_kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return ok, results


def _materialise(dataset):
    """Every example of a dataset, processed once: the DummyDataset draws
    its images from one generator in call order, so the examples are fixed
    here and a resumed run reads the same data as the run it continues."""
    return [dataset[i] for i in range(len(dataset))]


def train_data(torch, cfg, seq, fill=0.85):
    """DummyDataset (with images) through the smoke's ByteTokenizer, the
    per-step sample count whose mean length fills `fill` of one row, and the
    packing collator."""
    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.data.dummy import DummyDataset

    tok = ByteTokenizer()
    examples = _materialise(DummyDataset(tok, cfg, with_images=True))
    mean = sum(len(e["input_ids"]) for e in examples) / len(examples)
    per_step = max(1, math.ceil(fill * seq / mean))
    collator = PackingCollator(seq_len=seq, rows=1, pad_token_id=tok.pad_token_id,
                               tile_size=cfg.vision.image_size)
    return examples, per_step, collator, mean


def _snapshot(params):
    """Copies of one tensor per component that every step's gradient
    reaches."""
    return {
        "llm": params["llm"]["layers"]["input_layernorm"]["scale"].detach().clone(),
        "vision_tower": params["vision_tower"]["layers"]["layer_norm1"]["scale"].detach().clone(),
        "mm_projector": params["mm_projector"]["1"]["scale"].detach().clone(),
    }


def phase_train(torch, seed, cfg=None, dev="cuda", steps=6, save_steps=3, seq=2048,
                out_dir=os.path.join("runs", "chip_smoke_train")):
    """`Trainer` on the card at full NVILA-Lite-2B width, stage sft: `steps`
    steps with checkpoints every `save_steps`; then the last checkpoint is
    removed and a fresh `Trainer` resumes from step `save_steps`, which must
    reproduce the first run's losses. K7-K9 must launch 28 times per step
    (one per LLM layer; no remat) and nothing else."""
    import dataclasses
    import gc
    import shutil

    from vila_tpu_torch.cli.train import STAGE_PRESETS
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    cfg = cfg or nvila_lite_2b_config()
    layers = cfg.llm.num_hidden_layers
    dev = torch.device(dev)
    examples, per_step, collator, mean = train_data(torch, cfg, seq)
    fill = collator(examples[:per_step])["segment_ids"].astype(bool).mean()
    log(f"[train] {len(examples)} DummyDataset image samples, mean {mean:.1f} tokens; "
        f"{per_step} per step fill {100 * fill:.1f}% of a {seq}-token row")
    args = TrainArgs(output_dir=out_dir, max_steps=steps, per_device_batch_size=per_step,
                     seq_len=seq, pack_rows=1, logging_steps=1, save_steps=save_steps,
                     max_ckpts_to_keep=2, seed=seed, **STAGE_PRESETS["sft"])
    fpt = train_flops_per_token(cfg, seq)
    shutil.rmtree(out_dir, ignore_errors=True)

    def run(tag):
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = vlm.init_params(gen, cfg, torch.float32)
        before = _snapshot(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        trainer = Trainer(cfg, params, examples, collator, args, device=dev)
        t_init = time.perf_counter() - t0
        saves = {}  # step -> seconds of its checkpoint save
        save = trainer.ckpt.save

        def timed_save(step, *a, **kw):
            ts = time.perf_counter()
            save(step, *a, **kw)
            saves[step] = time.perf_counter() - ts

        trainer.ckpt.save = timed_save
        hist = trainer.train()["log_history"]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        moved = {k: not torch.equal(v, _snapshot(trainer.params)[k]) for k, v in before.items()}
        n_steps = steps - trainer.start_step
        rows = []
        prev = 0.0
        for h in hist:
            # a save after step n is timed apart, not as part of step n + 1
            step_s = h["elapsed_s"] - prev - saves.get(h["step"] - 1, 0.0)
            prev = h["elapsed_s"]
            rows.append(dict(step=h["step"], loss=h["loss"], grad_norm=h["grad_norm"],
                             n_tokens=h["n_tokens"], step_s=step_s,
                             tokens_per_s=seq / step_s,
                             mfu=fpt * seq / step_s / BF16_FLOPS))
            log(f"[{tag}] step {h['step']}: loss {h['loss']:.4f} grad_norm "
                f"{h['grad_norm']:.4f} step wall {1e3 * step_s:.1f} ms, "
                f"{seq / step_s:.0f} tokens/s, model-FLOPs share "
                f"{100 * rows[-1]['mfu']:.2f}%")
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] {n_steps} steps from step {trainer.start_step} in {wall:.1f} s "
            f"(set-up {t_init:.1f} s; checkpoint saves "
            f"{', '.join(f'{k}: {v:.1f} s' for k, v in saves.items())}); peak allocated "
            f"{peak / 2**30:.2f} GiB; launches {launches}; moved {moved}")
        want = dict(_no_launches(), **{k: layers * n_steps for k in FLASH_KERNELS})
        good = (launches == want and all(moved.values()) and len(rows) == n_steps
                and all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                        for r in rows))
        if not good:
            log(f"[{tag}] FAIL: launches {launches}, expected {want}; moved {moved}")
        del trainer, params
        gc.collect()
        torch.cuda.empty_cache()
        return good, rows, launches, dict(peak_bytes=peak, wall_s=wall, init_s=t_init,
                                          save_s=saves)

    try:
        ok1, rows1, launches1, info1 = run("train")
        ckpt = os.path.join(out_dir, "checkpoints")
        shutil.rmtree(os.path.join(ckpt, f"checkpoint-{steps}"))
        os.remove(os.path.join(ckpt, f"metadata-{steps}.json"))
        ok2, rows2, launches2, info2 = run("train resumed")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    resumed = rows2[0]["step"] == save_steps + 1 if rows2 else False
    rel = [abs(a["loss"] - b["loss"]) / abs(a["loss"])
           for a, b in zip(rows1[save_steps:], rows2)]
    # the kernels sum in a fixed order (no atomics): the resumed steps repeat
    # the first run's exactly
    ok3 = resumed and len(rel) == steps - save_steps and max(rel) == 0.0
    log(f"[train] resumed run: steps {[r['step'] for r in rows2]}, loss relative "
        f"differences to the first run {[f'{x:.2e}' for x in rel]} (must be 0) -> "
        f"{'OK' if ok3 else 'FAIL'}")
    steady = rows1[1:] or rows1
    summary = dict(
        config="NVILA-Lite-2B, sft, f32 master weights, bf16 compute, no remat",
        seq=seq, samples_per_step=per_step, row_fill=float(fill), steps=rows1,
        resumed_steps=rows2, resume_loss_rel_diff=rel,
        step_s_median=statistics.median(r["step_s"] for r in steady),
        tokens_per_s_median=statistics.median(r["tokens_per_s"] for r in steady),
        mfu_median=statistics.median(r["mfu"] for r in steady),
        flops_per_token=fpt, peak_bytes=info1["peak_bytes"], run=info1, resumed_run=info2)
    log(f"[train] steady steps (2..{steps}): step wall median "
        f"{1e3 * summary['step_s_median']:.1f} ms, {summary['tokens_per_s_median']:.0f} "
        f"tokens/s, model-FLOPs share {100 * summary['mfu_median']:.2f}%, peak "
        f"{info1['peak_bytes'] / 2**30:.2f} GiB")
    return ok1 and ok2 and ok3, summary, {"train": launches1, "train resumed": launches2}


def phase_train_profile(torch, seed, cfg=None, dev="cuda", seq=2048, warmup=2):
    """(only when named) One full-width training step (the `train` phase's
    configuration and batch size) timed without and then with
    torch.profiler: device busy time against the host clock, and the ops by
    device time (chiprun_out/train_profile.txt)."""
    from torch.profiler import ProfilerActivity, profile

    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step

    cfg = cfg or nvila_lite_2b_config()
    dev = torch.device(dev)
    examples, per_step, collator, _ = train_data(torch, cfg, seq)
    params = vlm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                             torch.float32)
    opt = topt.make_optimizer(topt.OptimizerConfig(learning_rate=2e-5,
                                                   vision_tower_lr=2e-6))
    _, params, state = make_train_step(cfg, params, opt)
    batch = batch_to_device(collator(examples[:per_step]), dev)

    def step():
        nonlocal params, state
        params, state, m = train_step(params, state, batch, cfg=cfg, optimizer=opt)
        float(m["loss"])  # the host waits for the step, as the trainer's log does

    for _ in range(warmup):
        step()
    t0 = time.perf_counter()
    step()
    wall = time.perf_counter() - t0
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        traced = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # device time = the kernels' own intervals (an op's self device time
    # repeats its kernels' and is not added again)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    groups = {}
    for e in kernels:
        t = e.time_range.elapsed_us() / 1e3
        name = e.name.lower()
        group = ("flash (K7-K9)" if "flash" in name else
                 "adamw" if "adam" in name else
                 "matmul f32" if "f32f32" in name or "sgemm" in name else
                 "matmul bf16" if any(w in name for w in ("gemm", "cutlass", "xmma",
                                                          "nvjet", "cublas")) else
                 "softmax / reductions" if any(w in name for w in ("softmax", "reduce",
                                                                   "norm")) else
                 "copies / casts / elementwise")
        groups[group] = groups.get(group, 0.0) + t
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "train_profile.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total" if dev.type == "cuda" else "self_cpu_time_total",
            row_limit=40))
    log(f"[train_profile] one step ({per_step} samples, {seq} tokens): wall "
        f"{1e3 * wall:.1f} ms unprofiled, {1e3 * traced:.1f} ms traced; device busy "
        f"{busy:.1f} ms ({100 * (1 - busy / (1e3 * traced)):.0f}% idle while traced); "
        "by group (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      sorted(groups.items(), key=lambda kv: -kv[1])))
    return dict(wall_ms=1e3 * wall, traced_ms=1e3 * traced, busy_ms=busy, groups_ms=groups)


def copy_tree(tree, dev):
    """A copy of a nested dict of tensors on `dev` (a copy even on the
    same device)."""
    if isinstance(tree, dict):
        return {k: copy_tree(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def phase_train_consistency(torch, seed, cfg=None, card="cuda", seq=512):
    """One `train_step` (stage sft, constant learning rates so that the
    step moves every tuned tensor) at full widths and reduced depth: on the
    card through K7-K9, and from the same parameters and batch on the CPU
    through their plain versions. Tolerances: loss 1e-2 and grad_norm 5e-2
    relative (bf16 products rounded by different libraries); the updated
    tensors: each update is at most lr per element (Adam's first step is
    lr * g / (|g| + eps)), so the card's and the CPU's may differ by up to
    2 lr where a gradient near zero changes sign, and at least 90 % of the
    elements must agree within 0.1 lr."""
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step

    cfg = cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
    layers = cfg.llm.num_hidden_layers
    examples, _, collator, _ = train_data(torch, cfg, seq)
    batch = collator(examples[:1])
    ocfg = topt.OptimizerConfig(learning_rate=2e-5, vision_tower_lr=2e-6,
                                schedule="constant", warmup_ratio=0.0)
    named = {"llm.layers.q_proj.kernel": (("llm", "layers", "q_proj", "kernel"), 2e-5),
             "vision_tower.layers.fc1.kernel": (("vision_tower", "layers", "fc1", "kernel"), 2e-6),
             "mm_projector.2.kernel": (("mm_projector", "2", "kernel"), 2e-5)}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    cpu = torch.device("cpu")
    params_cpu = vlm.init_params(torch.Generator().manual_seed(seed), cfg, torch.float32)
    before = {n: get(params_cpu, p).detach().clone() for n, (p, _) in named.items()}
    out = {}
    for tag, dev, impl in (("card", torch.device(card), "auto"), ("cpu", cpu, "flash")):
        params = copy_tree(params_cpu, dev) if tag == "card" else params_cpu
        opt = topt.make_optimizer(ocfg)
        _, params, state = make_train_step(cfg, params, opt)
        _build.reset_launches()
        t0 = time.perf_counter()
        params, state, m = train_step(params, state, batch_to_device(batch, dev), cfg=cfg,
                                      optimizer=opt, attn_impl=impl)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        out[tag] = dict(loss=loss, grad_norm=gnorm, s=time.perf_counter() - t0,
                             launches=dict(_build.LAUNCHES),
                             delta={n: (get(params, p).detach().to(cpu) - before[n])
                                    for n, (p, _) in named.items()})
        del params, state, opt
    card, host = out["card"], out["cpu"]
    want = dict(_no_launches(), **{k: layers for k in FLASH_KERNELS})
    ok = card["launches"] == want and all(v == 0 for v in host["launches"].values())
    rel_loss = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    rel_gn = abs(card["grad_norm"] - host["grad_norm"]) / abs(host["grad_norm"])
    ok &= rel_loss <= 1e-2 and rel_gn <= 5e-2
    tensors = {}
    for n, (_, lr) in named.items():
        diff = (card["delta"][n] - host["delta"][n]).abs()
        agree = float((diff <= 0.1 * lr).float().mean())
        moved = bool((host["delta"][n] != 0).any())
        good = float(diff.max()) <= 2 * lr * (1 + 1e-3) and agree >= 0.9 and moved
        ok &= good
        tensors[n] = dict(max_abs_diff=float(diff.max()), lr=lr, share_within_0p1_lr=agree)
        log(f"[train_consistency] {n}: max |d update| {float(diff.max()):.3e} "
            f"(lr {lr:g}), {100 * agree:.2f}% within 0.1 lr -> {'OK' if good else 'FAIL'}")
    log(f"[train_consistency] {layers} LLM + {cfg.vision.num_hidden_layers} SigLIP layers, "
        f"seq {seq}: "
        f"loss card {card['loss']:.6f} / CPU {host['loss']:.6f} (rel {rel_loss:.2e}, "
        f"limit 1e-2); grad_norm {card['grad_norm']:.5f} / {host['grad_norm']:.5f} "
        f"(rel {rel_gn:.2e}, limit 5e-2); card launches {card['launches']}; CPU step "
        f"{host['s']:.1f} s -> {'OK' if ok else 'FAIL'}")
    return ok, dict(loss=(card["loss"], host["loss"]), grad_norm=(card["grad_norm"],
                    host["grad_norm"]), tensors=tensors, cpu_s=host["s"])


def nvidia_smi_line():
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=DEFAULT_PHASES)
    ap.add_argument("--layers", type=int, default=28,
                    help="LLM depth for e2e, serve, http and profile")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import vila_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})", file=sys.stderr)
        return 2
    if "jax" in sys.modules or any(m.startswith("vila_tpu.") or m == "vila_tpu"
                                   for m in sys.modules):
        print("chip_smoke: JAX or the JAX package got imported", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = nvidia_smi_line()
    log(f"[card] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    ok = True
    report = {}
    results = {}
    launches = {}  # path run -> launch counts
    engines = {}
    t_all = time.time()

    def engine(layers, seed):
        """The engine over weights synthesised on the card, made once per
        (depth, seed) and shared by the phases."""
        if (layers, seed) not in engines:
            from vila_tpu_torch.inference.generate import GenerationEngine

            cfg = nvila_8b_config(layers)
            t0 = time.time()
            params = synth_params(torch, cfg, seed, "cuda")
            torch.cuda.synchronize()
            log(f"[weights] NVILA-8B shape, {layers} LLM layers: synthesised in "
                f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} "
                f"GiB on the card")
            engines[(layers, seed)] = GenerationEngine(params, cfg, ByteTokenizer(),
                                                       device="cuda")
        return engines[(layers, seed)]

    def llm_cpu():
        if "cpu" not in engines:
            from vila_tpu_torch.utils.weights import to_torch_tree

            engines["cpu"] = to_torch_tree(engine(4, args.seed + 1).params["llm"],
                                           torch.device("cpu"))
        return engines["cpu"]

    if "build" in phases:
        report["build_s"] = phase_build()
    if "kernels" in phases:
        good, results = phase_kernels(torch, args.seed)
        ok &= good
    else:  # (only when named: the kernels phase runs them)
        if "k1" in phases:
            good, k1 = phase_k1(torch, args.seed)
            results.update(k1)
            ok &= good
        if "k1_forms" in phases:
            from vila_tpu_torch.ops import quant

            flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            good, results["k1_forms"] = _check_k1_forms(torch, quant, args.seed, flush)
            ok &= good
    if "e2e" in phases:
        good, report["requests"], launches["e2e"] = phase_e2e(
            torch, engine(args.layers, args.seed), args.seed)
        ok &= good
    if "serve" in phases:
        for max_batch, n_req, new_tokens in SERVE_RUNS:
            good, report[f"serve_b{max_batch}"], launches[f"serve b{max_batch}"] = \
                phase_serve(torch, engine(args.layers, args.seed), args.seed,
                            max_batch, n_req, new_tokens)
            ok &= good
    if "consistency" in phases:
        good, report["consistency"] = phase_consistency(
            torch, engine(4, args.seed + 1), llm_cpu(), args.seed)
        ok &= good
    if "batched_consistency" in phases:
        good, report["batched_consistency"] = phase_batched_consistency(
            torch, engine(4, args.seed + 1), llm_cpu(), args.seed)
        ok &= good
    if "small_consistency" in phases:
        good, report["small_consistency"] = phase_small_consistency(torch, args.seed)
        ok &= good
    if "http" in phases:
        good, report["http"] = phase_http(torch, engine(args.layers, args.seed))
        ok &= good
    if any(p in phases for p in ("s2", "video", "media_profile")):
        from vila_tpu_torch.models import siglip

        e2e = engine(args.layers, args.seed)
        vt8 = siglip.quantize_siglip_w8a8(e2e.params["vision_tower"])
        for kind in ("s2", "video"):
            if kind in phases:
                good, report[kind], launches[kind] = phase_media(torch, e2e, vt8, args.seed,
                                                                 kind)
                ok &= good
        if "media_profile" in phases:  # not in the default run
            report["media_profile"] = {kind: phase_media_profile(torch, e2e, vt8, args.seed,
                                                                 kind)
                                       for kind in ("s2", "video")}
        del e2e, vt8
    if "load" in phases:
        good, report["load"], launches["load"] = phase_load(torch, args.seed)
        ok &= good
    if "profile" in phases:  # not in the default run
        report["profile"] = phase_profile(torch, engine(args.layers, args.seed), args.seed)
        report["profile_batched"] = phase_profile_batched(torch, engine(args.layers, args.seed))
    if any(p.startswith("train") for p in phases):
        # the serving engines' weights make room for training
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    if "train_kernels" in phases:
        good, train_results = phase_train_kernels(torch, args.seed)
        results.update(train_results)
        ok &= good
    if "train" in phases:
        good, report["train"], train_launches = phase_train(torch, args.seed)
        launches.update(train_launches)
        ok &= good
    if "train_consistency" in phases:
        good, report["train_consistency"] = phase_train_consistency(torch, args.seed)
        ok &= good
    if "train_profile" in phases:  # not in the default run
        report["train_profile"] = phase_train_profile(torch, args.seed)
    report["seconds"] = time.time() - t_all
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_report.json"), "w") as f:
        json.dump(dict(report, kernels=results, launches=launches, card=card), f, indent=1)
    if not ok:
        log("chip_smoke: FAILED")
        return 1
    log(card)
    log(json.dumps({"kernels": summarise(results, launches)}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
