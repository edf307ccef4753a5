#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`vila_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py                      # every phase, as a check
    python3 chip_smoke.py --phases build,kernels

Phases:
  build        compile every CUDA kernel of the served path from
               `vila_tpu_torch/csrc/` (one nvcc per source, in parallel);
  kernels      hold each kernel against its plain PyTorch version on the
               card at the NVILA-8B main-path shapes, and time kernel, plain
               version and the nearest PyTorch library call;
  e2e          serve 3 image+prompt requests through `GenerationEngine` at
               the full NVILA-8B width (Qwen2-7B W4A16 LLM, 28 layers;
               SigLIP-SO400M-448 bf16; mlp_downsample projector), weights
               synthesised on the card from a seed; reports TTFT, decode
               tok/s and the launch count of every kernel;
  consistency  at full width and 4 layers, the kernel decode path's
               per-step logits against one cache-free forward over prefix
               plus generated tokens run through the plain versions on the
               CPU;
  profile      (only when named) torch.profiler trace of one request:
               device busy time and idle share of a decode step.

The second-to-last line is the kernels JSON, the last line
`{"ok": true, "device": {...}}`. The script exits nonzero, and prints no
result, without CUDA or without the package beside it. Long reports (ptxas
output, per-shape numbers) go to `chiprun_out/`.
"""

from __future__ import annotations

import argparse
import json
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
        route="cuda", source="vila_tpu_torch/csrc/w4_gemv.cu",
        replaces="vila_tpu/ops/quant.py:384 (_w4_decode_manual_kernel; "
                 "grid form quant.py:349)"),
    "w4_gemm": dict(
        route="cuda", source="vila_tpu_torch/csrc/w4_gemm.cu",
        replaces="vila_tpu/ops/quant.py:796 (_w4_prefill_kernel; stacked "
                 "closure quant.py:914)"),
    "fused_layer": dict(
        route="cuda",
        source="vila_tpu_torch/csrc/decode_attn.cu + "
               "vila_tpu_torch/csrc/w4_gemv.cu",
        replaces="vila_tpu/ops/fused_decode.py:550 (_fused_layer_kernel)"),
}


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# Tokenizer (defined here so that the script needs no `transformers`)
# --------------------------------------------------------------------------


class ByteTokenizer:
    """Byte-level tokenizer with a ChatML template: ids 0-255 are the
    UTF-8 bytes, special tokens follow. Implements what `GenerationEngine`
    calls."""

    def __init__(self):
        self.vocab = {}
        self.add_tokens(["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
                        special_tokens=True)
        self.eos_token = "<|im_end|>"
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
    uniform nibbles, per-group scales drawn around 2e-3."""
    from vila_tpu_torch.ops import quant

    bout = quant.pick_bout(din, dout, budget=bout_budget or quant._BLOCK_BUDGET)
    nj = dout // bout
    ngh = din // 2 // 128
    s_rows = quant.scale_rows(ngh)
    dev = gen.device
    packed = torch.randint(0, 256, lead + (nj, din // 2, bout), generator=gen,
                           device=dev, dtype=torch.int32).to(torch.uint8)
    scales = torch.zeros(lead + (nj, s_rows, bout), device=dev, dtype=torch.bfloat16)
    scales[..., : 2 * ngh, :] = (
        0.002 * (0.5 + torch.rand(lead + (nj, 2 * ngh, bout), generator=gen, device=dev))
    ).to(torch.bfloat16)
    return {"packed": packed, "scales": scales}


def synth_params(torch, cfg, seed, device):
    """Full-width VLM params on `device`: W4 LLM slots in the fused,
    GQA-padded layout of `quantize_llm_params(fuse=True, cfg=...)`, bf16
    vision tower and projector."""
    from vila_tpu_torch.models import projector, siglip

    gen = torch.Generator(device=device).manual_seed(seed)
    llm = cfg.llm
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
        "lm_head": synth_w4_slot(torch, gen, (), D, llm.vocab_size),
    }
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
    return secs


def phase_kernels(torch, seed, dev="cuda", dims=(3584, 18944, 128, 28, 4, 152064),
                  m_prefill=320, cache=(2048, 1300)):
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
    results = {"w4_gemv": [], "w4_gemm": [], "fused_layer": []}
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
    kw = dict(hkv=Hkv, hd=hd, eps=1e-6, fill=fill, num_q_heads=Hq)
    fn = lambda: fused_decode.fused_layer(*args, **kw)
    ref = lambda: fused_decode._fused_layer_ref(*args, **kw)
    (h_k, qkv_k), (h_r, qkv_r) = fn(), ref()
    torch.cuda.synchronize()
    err_h, sc_h = rel_err(torch, h_k[0], h_r[0])
    err_q, sc_q = rel_err(torch, qkv_k[0], qkv_r[0])
    good = (err_h <= 2e-2 * sc_h and err_q <= 2e-2 * sc_q
            and bool(torch.isfinite(qkv_k.float()).all()))
    ok &= good
    t = time_ms(torch, fn, 30, flush)
    t_plain = time_ms(torch, ref, 5, flush)
    n_rows = fill + 1
    byts = (w4_bytes(Hkv * 8 * hd, D) + w4_bytes(D, 2 * I) + w4_bytes(I, D)
            + w4_bytes(D, (Hq + 2 * Hkv) * hd) + 2 * n_rows * kv_ld * 2
            + n_rows * 4 + q32.numel() * 2 + 4 * D * 2 + (Hq + 2 * Hkv) * hd * 4 + D * 2)
    ops = 2 * 2 * (Hkv * 8 * hd * D + D * 2 * I + I * D + D * (Hq + 2 * Hkv) * hd)
    b_ms, b_by = bound(byts, ops, INT8_OPS)
    results["fused_layer"].append(dict(
        shape="decode layer, cache 2048, fill 1300", m=1, max_abs_err=max(err_h, err_q),
        tol=f"2e-2 x max|ref| (h {2e-2 * sc_h:.3e}, qkv {2e-2 * sc_q:.3e})",
        ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))
    log(f"[kernels] fused_layer h err {err_h:.3e} (max {sc_h:.3e}) qkv err "
        f"{err_q:.3e} (max {sc_q:.3e}) {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  "
        f"plain {t_plain:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
    if dev.type == "cuda":
        results["fused_layer"][-1]["stages_ms"] = stages = _k3_stages(
            torch, quant, fused_decode, args, fill, flush)
        log("[kernels] fused_layer stages (ms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in stages.items()))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return ok, results


def _k3_stages(torch, quant, fused_decode, args, fill, flush):
    """Each of K3's five launches timed on its own (same inputs)."""
    q32, mask, h, _, kc, vc, o, gu, down, qkv, gpost, gin = args
    dev, bf16 = q32.device, torch.bfloat16
    hkv, hd = kc.shape[-1] // 128, 128
    d = h.shape[1]
    e = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    x_att, h32, h32b = e((1, q32.numel()), bf16), e((1, d), torch.float32), e((1, d), torch.float32)
    g_out, q_out = e((1, fused_decode._dout(gu)), bf16), e((1, fused_decode._dout(qkv)), bf16)
    h_new = e((1, d), bf16)
    stages = {
        "attention": lambda: fused_decode._launch_attn(
            q32, kc, vc, mask, 0, fill + 1, hkv, hd, 7, x_att),
        "o": lambda: quant.launch_gemv(x_att, o["packed"], o["scales"], 0, m=1,
                                       res_bf16=h[0:1], out_f32=h32),
        "gate_up": lambda: quant.launch_gemv(
            h32, gu["packed"], gu["scales"], 0, m=1, prologue=quant.PRO_RMS,
            gamma=gpost[0].to(bf16), eps=1e-6, out_bf16=g_out),
        "down": lambda: quant.launch_gemv(
            g_out, down["packed"], down["scales"], 0, m=1, prologue=quant.PRO_SILU,
            res_f32=h32, out_f32=h32b, out_bf16=h_new),
        "qkv": lambda: quant.launch_gemv(
            h32b, qkv["packed"], qkv["scales"], 1, m=1, prologue=quant.PRO_RMS,
            gamma=gin[1].to(bf16), eps=1e-6, bias=qkv["bias"][1].to(bf16), out_bf16=q_out),
    }
    return {k: time_ms(torch, f, 30, flush) for k, f in stages.items()}


def summarise(results, launches):
    """One entry per kernel. K1 and K2 are summed over the calls the main
    path makes per unit of work (K1: one decode step's layer-0 qkv and
    lm_head at M=1; K2: one prefill layer's four projections at M=320);
    K3 is one decode layer."""
    picks = {
        "w4_gemv": lambda r: r["m"] == 1 and r["shape"] in ("qkv", "lm_head"),
        "w4_gemm": lambda r: r["m"] > 32,
        "fused_layer": lambda r: True,
    }
    out = []
    for name, meta in KERNELS.items():
        rows = [r for r in results.get(name, []) if picks[name](r)]
        if not rows:
            continue
        lib = [r["library_ms"] for r in rows]
        out.append(dict(
            name=name, **meta, launches=launches.get(name, 0),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows),
            bound_ms=sum(r["bound_ms"] for r in rows),
            bound_by=rows[0]["bound_by"],
            library_ms=None if None in lib else sum(lib),
            work=", ".join(f"{r['shape']} M={r['m']}" for r in rows),
            checks_ok=all(r["ok"] for r in results[name]),
        ))
    return out


def phase_e2e(torch, seed, layers, n_requests=3, new_tokens=32, device="cuda"):
    import numpy as np

    from vila_tpu_torch.inference.generate import GenerationConfig, GenerationEngine
    from vila_tpu_torch.ops import _build

    cfg = nvila_8b_config(layers)
    t0 = time.time()
    params = synth_params(torch, cfg, seed, device)
    torch.cuda.synchronize()
    log(f"[e2e] NVILA-8B shape, {layers} LLM layers: weights synthesised in "
        f"{time.time() - t0:.1f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    tok = ByteTokenizer()
    engine = GenerationEngine(params, cfg, tok, device=device)
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (448, 448, 3), dtype=np.uint8) for _ in range(n_requests + 1)]
    questions = ["Describe the image in detail.", "What is in the picture?",
                 "How many objects are there?", "What colour dominates?"]
    # no stop token: every request decodes exactly `new_tokens`
    gc = GenerationConfig(max_new_tokens=new_tokens, stop_token_ids=(-1,))

    def serve(i):
        t_start = time.perf_counter()
        inputs = engine.prepare_inputs([images[i], questions[i]])
        ids, times = [], []
        for chunk in engine.stream_ids(inputs, gc):
            ids.extend(chunk)
            times.append(time.perf_counter())
        return inputs, ids, t_start, times

    serve(n_requests)  # warm-up request (cuBLAS handles, allocator)
    _build.reset_launches()
    reqs = []
    for i in range(n_requests):
        inputs, ids, t_start, times = serve(i)
        ttft = (times[0] - t_start) * 1e3
        dec = (len(ids) - 1) / (times[-1] - times[0])
        reqs.append(dict(prompt_tokens=int(inputs["input_ids"].shape[0]),
                         new_tokens=len(ids), ttft_ms=ttft, decode_tok_s=dec))
        log(f"[e2e] request {i}: prompt {inputs['input_ids'].shape[0]} tokens, "
            f"{len(ids)} new, TTFT {ttft:.1f} ms, decode {dec:.1f} tok/s, "
            f"text {tok.decode(ids, skip_special_tokens=True)[:40]!r}")
        ok_ids = len(ids) == new_tokens and all(0 <= t < cfg.llm.vocab_size for t in ids)
        if not ok_ids:
            log(f"[e2e] FAIL: request {i} gave {len(ids)} ids, range check failed")
            return False, reqs, dict(_build.LAUNCHES)
    launches = dict(_build.LAUNCHES)
    steps = sum(r["new_tokens"] - 1 for r in reqs)
    want = {"w4_gemv": n_requests + 2 * steps, "w4_gemm": 4 * layers * n_requests,
            "fused_layer": layers * steps}
    log(f"[e2e] launches {launches}, expected {want}")
    ok = all(launches[k] > 0 for k in KERNELS) and launches == want
    return ok, reqs, launches


def phase_consistency(torch, seed, layers=4, steps=8, device="cuda"):
    """Kernel decode path (K2 prefill, K3 + K1 decode) against a cache-free
    forward over prefix + generated tokens through the plain versions
    (CPU)."""
    import numpy as np

    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import qwen2, vlm
    from vila_tpu_torch.utils.weights import to_torch_tree

    cfg = nvila_8b_config(layers)
    params = synth_params(torch, cfg, seed + 1, device)
    tok = ByteTokenizer()
    engine = GenerationEngine(params, cfg, tok, device=device)
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

    llm_cpu = to_torch_tree(llm, torch.device("cpu"))
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


def phase_profile(torch, seed, layers, new_tokens=17):
    """Trace one request's decode with torch.profiler: device busy time per
    decode step against the host clock (the device's idle share), and the
    kernels by device time (table in chiprun_out/profile.txt)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from vila_tpu_torch.inference.generate import GenerationConfig, GenerationEngine

    cfg = nvila_8b_config(layers)
    engine = GenerationEngine(synth_params(torch, cfg, seed, "cuda"), cfg,
                              ByteTokenizer(), device="cuda")
    image = np.random.default_rng(seed).integers(0, 256, (448, 448, 3), dtype=np.uint8)
    inputs = engine.prepare_inputs([image, "Describe the image."])

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
    ap.add_argument("--phases", default="build,kernels,e2e,consistency")
    ap.add_argument("--layers", type=int, default=28, help="LLM depth for e2e")
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
    launches = {}
    t_all = time.time()
    if "build" in phases:
        report["build_s"] = phase_build()
    if "kernels" in phases:
        good, results = phase_kernels(torch, args.seed)
        ok &= good
    if "e2e" in phases:
        good, reqs, launches = phase_e2e(torch, args.seed, args.layers)
        report["requests"] = reqs
        ok &= good
    if "consistency" in phases:
        good, report["consistency"] = phase_consistency(torch, args.seed)
        ok &= good
    if "profile" in phases:  # not in the default run
        report["profile"] = phase_profile(torch, args.seed, args.layers)
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
