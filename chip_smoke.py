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
               (128- and 256-byte boxes, 16-byte loads); K1 over one
               layer's four projections at the speculative verify forward's
               M = 5 and 8; K1's one-digit
               form (the `k1_one_digit` phase); then K1-K6 at Qwen2-0.5B
               widths (head dim 64, W4 groups of 112 and 128, then every
               product in groups of 64);
  k1           (only when named) K1 alone through its public wrapper, as
               in `kernels`: it runs on an earlier tree of the port as well
               (old-against-new calls);
  k1_forms     (only when named) K1's digit, repeat and probe checks, as
               in `kernels`;
  k1_one_digit  (only when named) K1 at act_digits=1, as in `kernels`: the
               lm_head and a stacked qkv at M = 1-32 against the one-digit
               plain version and dequantize + matmul, timed beside two
               digits, its wgmma workspace and repeat launches bit for bit;
  e2e          serve 3 image+prompt requests through `GenerationEngine` at
               the full NVILA-8B width (Qwen2-7B W4A16 LLM, 28 layers;
               SigLIP-SO400M-448 bf16; mlp_downsample projector), weights
               synthesised on the card from a seed; reports TTFT, decode
               tok/s and the launch count of every kernel;
  consistency  at full width and 4 layers, the kernel decode path's
               per-step logits against one cache-free forward over prefix
               plus generated tokens run through the plain versions on the
               card (`plain_versions`);
  batched_consistency  the same for the batched routes: B = 3 (K6) and
               B = 20 (K4/K5);
  small_consistency  every decode route (bs=1 K3, B = 3 K6, B = 20 K4/K5)
               at Qwen2-0.5B widths (head dim 64, W4 groups of 112), 4
               layers, text only, against the plain CPU forward;
  http         the OpenAI-compatible server over a max_batch=8 batcher: 4
               concurrent text requests and, with them, one
               `response_format` request blocking and streamed, which the
               batcher hands to the serial engine (two threads launching on
               one stream); each reply equal to its serial answer;
  spec         prompt-lookup speculative decoding on the e2e engine: an
               image + a question that repeats a span, and the text alone,
               20 tokens at gamma 4 and 7 beside the vanilla stream; TTFT,
               tok/s, tokens per verify forward, the verify forward's device
               busy (traced) and host-issue ms, K1 launches by M (every projection and the
               lm_head at M = gamma + 1); the stream against vanilla up to a
               named K1-band tie, every K1 / K2 call of request 0 against
               its plain version, each verify forward (gamma 4) against the
               plain versions on a copy of its cache, and a vanilla chunk
               after a speculative chunk;
  constrained  JSON-constrained decoding: the e2e engine with json_object and
               a two-property schema, and the W4 quant probe (its
               tokenizer.json) with a yes/no schema: valid JSON prefixes,
               complete where done, key order, the kernel stream against
               `plain_versions`; per token (teacher-forced along a valid JSON
               text) the step's device ms, the host's wait, the logits copy
               and the sampler's pick and mask;
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
  ps3          VILA-HD (PS3) at the repository's defaults through
               `entry.build_config`: a SigLIP-SO400M trunk, scales 378 / 756 /
               1512, 64 selected a high scale (857 tokens an image), an
               mlp2x_gelu projector, the W4 LLM of `e2e`, "after_prompt": 2
               requests x 32 tokens on a seeded 1512 x 1134 image, each in
               two passes (the low-res encode and a cache-free LLM forward
               over the unpadded prompt, K2 at its M, give the top-down
               prompt; the steered selection, pass 2, prefill, decode), with
               exact K1-K3 launches; the TTFT in parts; K2 at the pass-1 M;
               request 0's teacher-forced path call by call against the plain
               versions (which take the kernel pass's selection); the card's
               top-k order against the CPU's; one "after_image" request;
  towers       CLIP ViT-L/14-336, InternViT-6B-448px-V1-5 and RADIO ViT-H/16
               at 432² through `entry.build_config`, seeded bf16 weights and
               `quantize_vit_w8a8`: one image through `encode_images` in bf16
               and W8A8, the W8A8 features against bf16, and one 16-token
               request through the W8A8 tower and the W4 LLM of `e2e`;
  media_profile  (only when named) torch.profiler traces of the s2 and
               video requests' media encode and prefill: device busy time
               and the operations by device time;
  load         the loader at full NVILA-8B width, LLM depth 2: unquantized
               bf16 weights synthesised on the card from a seed of their
               own, written with `entry.save` (≈ 8 GB of f32 safetensors
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
               greedy tokens against the argmax of a plain forward on the
               card); then the quantizer's peak memory on a 28-layer bf16 LLM;
  export       the single-repo HF export at the same width (LLM depth 2): a
               seeded bf16 tree on the card written with `export_hf_repo`
               (≈ 8 GB of f32 safetensors under `runs/`, removed at the
               end), read back bit for bit with the port's reader, its
               config.json against `entry.build_config`'s; the tree rebuilt
               through the port's converters (bit for bit), quantized W4 and
               serving 2 requests x 16 tokens (exact K1-K3 launches) with
               greedy tokens equal to the source tree's engine; one decode
               step traced inside `profiling.annotate("decode_step")`, the
               region in the trace with the card's kernels beneath it; with
               `train`, the `consolidate` check after it: the train run's
               step-3 checkpoint through `consolidate_checkpoint`, loaded
               back by `entry.load_params` on the card bit for bit;
  w8           `quantize_w8` of NVILA-8B's down_proj on the card byte for
               byte against the CPU, `quantized_linear` over the W8 slot
               against the CPU;
  awq          AWQ at NVILA-8B width, 28 layers: seeded bf16 LLM, 32 x 48
               calibration ids, `collect_act_stats`, `apply_awq`,
               `quantize_llm_params` (seconds, peak memory); every fold
               checked; layer 0's searches again on the CPU (in a worker
               process started at the top of the run, read at its end); 1
               request x 32 tokens through K1-K3, each call of the serving
               path against its plain version on its own inputs, the
               end-to-end gap and its growth with depth reported;
  quant_acc    the committed quant probe through `entry.load` (the port's
               tokenizer reader), pope-mini accuracy for bf16 / W4-RTN /
               W4-AWQ over 200 questions beside `QUANT_ACC_r05.json`; on
               the first 40, against the plain versions: the W4-AWQ
               engine's predictions, the W4-RTN engine through the port's
               `vqa.run_eval` and `smoke.run` (text, image; exact K1-K3
               launches, predictions equal), both W4 engines' logits;
  eval         the port's evaluation over the quant probe, started before
               `quant_acc` and read after it: `python -m
               vila_tpu_torch.cli.eval --tags mini` (pope-mini and
               textvqa-mini as subprocesses on the card, bf16; pope-mini
               within 0.03 of `QUANT_ACC_r05.json`'s bf16 accuracy) and
               `--tasks loss-regression smoke-text smoke-image` (exit 0,
               every metric resolved through `json_path`, every smoke
               prompt passed, a finite loss);
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
               row, a checkpoint at 3; then a fresh `Trainer` resumes
               from step 3 and must reproduce steps 4-6 exactly; exact K7-K9 launch
               counts, step wall, tokens/s, model-FLOPs share, peak memory;
  train_consistency  one `train_step` at full widths with 2 LLM and 2 SigLIP
               layers at seq 512 on the card (kernels) against the same
               step through the plain versions on the card (each training
               mode's 2 + 2-layer check below too);
  train_media  the `train` configuration with dynamic tiles: a video sample
               (4 frames of a frame directory) and a dynamic-tiled image (3
               tiles) through the port's `BaseDataset`, packed in one
               2048-token row, 3 steps (K7-K9 once per layer per step): step
               wall, tokens/s, peak memory; then a 2 + 2-layer step on a
               3-frame video row at seq 1024 against the plain versions;
  train_fp8    COAT fp8 at the `train` configuration (one seeded f32
               NVILA-Lite-2B tree, drawn once for the training-mode phases
               and copied into each): 3 `train_step`s with every decoder
               projection in fp8, per tensor (`fp8_linear`: `torch._scaled_mm`
               on the fp8 tensor cores) and then per group, and
               `optimizer="fp8_adamw"`; the first loss against bf16's on the
               same row, the fp8 state's bytes against AdamW's; one
               gate_proj-shaped fp8 linear (M 2048, K 1536, N 8960) forward
               and backward: its quantizers' bytes against the CPU's, its
               products against the plain version on the same fp8 bytes,
               timed beside bf16 `torch.matmul`; a 2 + 2-layer step against
               the plain versions (`fp8.fp8_mm_plain` for `_scaled_mm`);
  train_lora   LoRA, then DoRA (rank 16, all seven projections) over the
               frozen tree: 3 steps each at seq 2048; B = 0 gives the base
               model's hidden states bit for bit, only the factors move,
               `merge_lora` gives the LoRA forward; a 2 + 2-layer DoRA step
               against the plain versions;
  train_dpo    DPO, remat: 2 pairs of 1024-token rows, 2 steps of the
               policy against the tree as the frozen reference; log 2 and
               margin 0 at step 0, the margin rises; 2 + 2 layers against
               the plain versions;
  train_rlhf   a reward model (the tree and a value head), 2 pairwise
               steps; `make_experience` against the frozen tree, 2 PPO
               steps (clipfrac 0 and pg_loss -mean(advantage) at the first);
               2 + 2 layers against the plain versions;
  train_ps3    VILA-HD stage 1.5 (the `ps3` phase's tower, Qwen2-7B bf16
               frozen): 2 steps on 2 rows of seq 1024, one 4:3 image each,
               with gt selection maps (LM + selection loss); 2 + 2 layers
               (tower 2) against the plain versions;
  train_data   `Trainer` at NVILA-Lite-2B width (LLM depth 8) on a mixture
               from the port's registry: a seeded corpus written with the
               port's `prep` (image + caption tar shards, an SFT json turned
               into shards, MMC4-style documents, caption pairs, TextOCR
               shards, LITA frame directories), registered from its YAML
               file and built with `build_dataset("corpus_interleaved+
               corpus_pairs+corpus_wds*2+corpus_textocr+corpus_lita")`; each
               shard's native tar index against the Python index; 3 steps of
               packed 2048-token rows (exact K7-K9 launches), every batch on
               the card bit for bit against the mixture collated afresh on
               the CPU (the same code: collation is deterministic and the
               copy exact; the samples themselves rest on the CPU tests
               against JAX); `loss_eval.loss` on the trained tree at 2048
               (K7 once a layer) within 1e-4 of the same call under
               `plain_versions`, the last layer's output on its batch within
               5e-2 x max|ref|;
  tp           tensor parallelism: (a) two tp ranks (two processes sharing the
               card over gloo) at NVILA-Lite-2B full width, LLM depth 4,
               tower depth 6, one packed 2048-token row with images: the rank's tp
               forward and backward (column / row / vocab parallel, 6 / 1
               heads a rank) against the one-device step on the card (loss
               within 1e-3, every gradient leaf within 2e-2 x max|ref|),
               every K7-K9 call against its plain version; (b) K7-K9 at
               the tp ranks' heads, 6 / 1 (NVILA-Lite-2B at tp 2) and 7 / 1
               (Qwen2-7B at tp 4), S 2048, three segments, against their
               plain versions, timed beside SDPA; (c) the sharded step on a
               (1, 1, 1, 1) NCCL mesh, 2 steps of fp8 AdamW and 2 of PS3
               stage 1.5 at 2 layers, against the one-device step;
  sp_ring      LongVILA's ring at Qwen2-7B attention widths (28 / 4 heads of
               128), bf16, S 32768 with three packed segments: the port's
               ring steps (`_ring_step_fwd`, `_merge`, `_ring_step_bwd`) for
               4 virtual ranks in one process, contiguous and zigzag, held
               against one K7 / K8 / K9 call over the whole sequence; each
               step kind's K7-K9 against its plain version, timed beside
               SDPA; the step kernels' ms summed over the ring;
  extend       context extension (`extend_llm`) over a seeded bf16 Qwen2-7B,
               28 layers: LoRA rank 16, remat, rope_theta 15.3e6, 2 steps of
               32768 tokens (step wall, peak, K7-K9 launches); the first
               loss of a 2-layer cut at S 1024 against the CPU;
  niah         `run_niah` over the same Qwen2-7B: contexts 8192 / 32768 x
               depths 0 / 0.5 / 1 (each forward's ms, K7 launches); at 8192
               every K7 call of the 28-layer forward against its plain
               version on the same inputs;
  long_ctx     `LongContextEngine` over the W4 NVILA-8B LLM on a one-rank
               NCCL mesh: cache 65536, chunks of 4096, a 32768-token prompt,
               16 greedy tokens (TTFT, tok/s, peak, K1 / K2 launches) against
               the serial `qwen2.forward` cache path; then the engine built
               with `param_specs` against the replicated one (8 tokens after
               a 4096-token prompt);
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
import atexit
import contextlib
import functools
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
    # the port's own: the JAX package leaves the loss to XLA; the role of the
    # reference's Liger fused cross entropy
    "ce_rows": dict(
        route="cuda", source="vila_tpu_torch/csrc/ce_rows_sm90.cu",
        replaces="none (the port's own LM-head cross-entropy row kernel)"),
}
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# K1's lm_head work on the batched routes, reported inside its entry:
# (rows, the path that runs it)
K1_BATCHED = ((8, "serve b8"), (24, "serve b24"))
# the kernels the serial (bs=1) path must launch (e2e, load, s2, video, ps3,
# towers)
E2E_KERNELS = ("w4_gemv", "w4_gemm", "fused_layer")
# (max_batch, requests, new tokens) of each serve run: K6, then K4/K5
SERVE_RUNS = ((8, 12, 32), (24, 24, 16))
DEFAULT_PHASES = ("build,kernels,e2e,serve,consistency,batched_consistency,"
                  "small_consistency,http,spec,constrained,s2,video,ps3,towers,load,export,w8,awq,"
                  "quant_acc,eval,train_kernels,train,train_consistency,train_media,train_fp8,"
                  "train_lora,train_dpo,train_rlhf,train_ps3,train_data,tp,sp_ring,extend,"
                  "long_ctx,niah")


def log(*a):
    print(*a, flush=True)


# --------------------------------------------------------------------------
# Tokenizer (defined here so that the script needs no `transformers`)
# --------------------------------------------------------------------------


class ByteTokenizer:
    """Byte-level tokenizer with a ChatML template: ids 0-255 are the
    UTF-8 bytes, special tokens follow. Implements what `GenerationEngine`,
    the grammar's vocab table (`vocab_size`, `len`, `batch_decode`) and the
    training data path (`preprocess_conversation`: special tokens added on
    the fly, the sentinel among them; the collators' pad id) call."""

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

    @property
    def vocab_size(self):
        """The byte vocabulary, the added tokens not counted (HF's meaning)."""
        return 256

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

    def batch_decode(self, sequences, skip_special_tokens=False):
        return [self.decode(seq, skip_special_tokens=skip_special_tokens) for seq in sequences]


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
        good, results["k1_one_digit"], results["k1_one_digit_launches"] = \
            _check_k1_one_digit(torch, quant, seed, flush)
        ok &= good
        ok &= _check_small(torch, quant, fused_decode, results, seed, flush)
        ok &= _check_small(torch, quant, fused_decode, results, seed, flush, group=64)
        ok &= _check_ce_rows(torch, results, seed, flush)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "kernels.json"), "w") as f:
        json.dump(results, f, indent=1)
    return ok, results


# The LM head's row kernel at the sft cell's chunks (NVILA-Lite-2B's vocabulary,
# 2047 shifted rows in two chunks): (rows, gradient, z_loss, on that main path)
CE_VOCAB = 152000
CE_ROWS = ((1024, True, 0.0, True), (1023, True, 0.0, True), (1024, True, 1e-4, False),
           (1024, False, 0.0, False))


def _check_ce_rows(torch, results, seed, flush):
    """`ce_rows` (`cross_entropy.ce_rows`, one launch of ce_rows_sm90.cu)
    against `ce_rows_plain` on the card's tensors at `CE_ROWS`: the rows'
    nll within rtol 1e-6 (atol 1e-5), the probabilities hi + lo + onehot
    within 3e-5 relative (the few f32 steps of lse that exp(x - lse)
    carries), ignored rows' gradient 0; each timed beside its plain version
    and its bound (one read of the scored rows' logits, one write of the
    bf16 hi / lo gradient). On a generator of its own."""
    from vila_tpu_torch.constants import IGNORE_INDEX
    from vila_tpu_torch.ops import cross_entropy as ce

    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 22)
    ok = True
    for rows, grad, z, main in CE_ROWS:
        logits = 4.0 * torch.randn((rows, CE_VOCAB), generator=gen, device=dev)
        targets = torch.randint(0, CE_VOCAB, (rows,), generator=gen, device=dev)
        targets[::5] = IGNORE_INDEX
        fn = lambda: ce.ce_rows(logits, targets, z, grad)  # noqa: E731
        ref = lambda: ce.ce_rows_plain(logits, targets, z, grad)  # noqa: E731
        (nll, g2), (want_nll, want_g2) = fn(), ref()
        nll_gap = float((nll - want_nll).abs().max())
        good = bool(torch.isfinite(nll).all()) and bool(
            torch.allclose(nll, want_nll, rtol=1e-6, atol=1e-5))
        prob_gap = None
        if grad:
            keep = targets != IGNORE_INDEX
            onehot = torch.zeros_like(logits)
            onehot[keep.nonzero()[:, 0], targets[keep]] = 1.0
            got = g2[:rows].float() + g2[rows:].float() + onehot
            want = want_g2[:rows].float() + want_g2[rows:].float() + onehot
            prob_gap = float(((got - want).abs() / (want.abs() + 1e-30)).max())
            zero = not g2[:rows][~keep].any() and not g2[rows:][~keep].any()
            good = good and prob_gap <= 3e-5 and zero
            del onehot, got, want
        del nll, g2, want_nll, want_g2
        ok &= good
        t = time_ms(torch, fn, 20, flush)
        t_plain = time_ms(torch, ref, 3, flush)
        # the kernel reads only the rows it scores (an ignored row's nll is 0)
        # and writes the gradient of every row
        valid = int((targets != IGNORE_INDEX).sum())
        b_ms, b_by = bound(valid * CE_VOCAB * 4 + rows * (8 + 4)
                           + (2 * rows * CE_VOCAB * 2 if grad else 0), 0, BF16_FLOPS)
        what = f"{'nll and gradient' if grad else 'nll only'}, z_loss {z:g}"
        results["ce_rows"].append(dict(
            shape=f"sft chunk x vocab {CE_VOCAB}, {what}", m=rows, main=main,
            max_abs_err=nll_gap, prob_gap=prob_gap,
            tol="nll rtol 1e-6 atol 1e-5; probabilities 3e-5 relative", ok=good, ms=t,
            plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=None))
        log(f"[kernels] ce_rows {rows} x {CE_VOCAB} {what}: nll gap {nll_gap:.3e}"
            + ("" if prob_gap is None else f", probabilities' gap {prob_gap:.3e}")
            + f" {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  plain {t_plain:.3f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})")
        del logits, targets
    return ok


# The media phases' new shapes: K2 at the prompt buckets of a dynamic-S2
# image (1452 media tokens -> 1536) and of a 64-frame TSP video (≈ 4.1k ->
# 8192); K3 over the video's cache (8192 rows, ≈ 4.1k live)
MEDIA_PREFILL = ((1536, "s2"), (8192, "video"))
MEDIA_CACHE = (8192, 4141)


K2_REPS = 10  # timed launches of K2 a row; its plain version and dequant+matmul take 3


def _k2_row(torch, quant, gen, packed, scales, layer_index, m, name, path, flush, tag):
    """(ok, row): K2 over one stacked W4 slot's layer at M = `m` on seeded
    inputs against its plain version (one bf16 ulp of the largest output),
    timed beside its bound, the plain version and `dequantize` +
    `torch.matmul`; the row in the `kernels` phase's form, under `media` =
    `path`."""
    dev = flush.device
    *_, din, dout = quant._tiled_meta(packed, scales)
    x = torch.randn((m, din), generator=gen, device=dev).to(torch.bfloat16)
    fn = lambda: quant.w4_matmul_prefill(x, packed, scales, layer_index=layer_index)  # noqa: E731
    ref = lambda: quant._w4_gemm_ref(x, packed, scales, layer_index)  # noqa: E731
    got, want = fn(), ref()
    torch.cuda.synchronize()
    err, scale = rel_err(torch, got, want)
    tol = 2.0 ** -7 * scale
    good = bool(torch.isfinite(got.float()).all()) and err <= tol
    del got, want
    t = time_ms(torch, fn, K2_REPS, flush)
    t_plain = time_ms(torch, ref, 3, flush)
    t_lib = time_ms(torch, lambda: x @ quant.dequantize(
        {"packed": packed[layer_index], "scales": scales[layer_index]}), 3, flush)
    b_ms, b_by = bound(m * din * 2 + w4_bytes(din, dout) + m * dout * 2,
                       2 * m * din * dout, BF16_FLOPS)
    plan = (quant.gemm_plan(m, dout, din // 2, quant._device_state(dev)[0])
            if dev.type == "cuda" else "-")
    log(f"[{tag}] w4_gemm {path} {name:8s} M={m:<5d} plan {plan} err {err:.3e} "
        f"(tol {tol:.3e}) {'OK' if good else 'FAIL'}  kernel {t:.4f} ms  plain "
        f"{t_plain:.3f} ms  dequant+matmul {t_lib:.3f} ms  bound {b_ms:.4f} ms ({b_by})")
    return good, dict(shape=name, m=m, din=din, dout=dout, max_abs_err=err, tol=tol, ok=good,
                      ms=t, plain_ms=t_plain, bound_ms=b_ms, bound_by=b_by, library_ms=t_lib,
                      media=path, plan=str(plan))


def _check_media_shapes(torch, quant, fused_decode, results, slots, k3_args, seed, flush,
                        dims):
    """K2 (`_k2_row`) over one layer's four projections at M = 1536 and
    8192; K3 at cache 8192 / fill 4141 (65 attention chunks a KV head: each
    CTA loops over several units) against its plain version. Inputs from a
    generator of their own; the weights are the `kernels` phase's."""
    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    D, I, hd, Hq, Hkv, V = dims
    ok = True
    for m, path in MEDIA_PREFILL:
        for name in ("qkv", "o", "gate_up", "down"):
            good, row = _k2_row(torch, quant, gen, slots[name]["packed"],
                                slots[name]["scales"], 1, m, name, path, flush, "kernels")
            ok &= good
            results["w4_gemm"].append(row)
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
# the speculative verify forward's M = gamma + 1 (the `spec` phase's gamma 4
# and 7): K1 on every projection of a layer and the lm_head
K1_SPEC_ROWS = (5, 8)


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
    layer's four projections at M = 24 (a short prompt's prefill) and at
    the speculative verify forward's M = 5 and 8 (`K1_SPEC_ROWS`, each
    projection with its plain version and dequantize + matmul) on K1; the
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
    spec = K1_SPEC_ROWS
    rows = {"lm_head": K1_LM_ROWS, "qkv": tuple(sorted(set(K1_QKV_ROWS + spec))),
            "o": spec + (24,), "gate_up": spec + (24,), "down": spec + (24,)}
    recs, ok, slots = [], True, {}
    layer = {m: [] for m in spec + (24,)}
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
            if (name == "lm_head" and m in (8, 24)) or (name != "lm_head" and m in spec):
                rec["plain_ms"] = time_ms(torch, ref, 5, flush)
                rec["library_ms"] = time_ms(torch, lambda: x @ quant.dequantize(
                    {"packed": packed[li] if lead else packed,
                     "scales": scales[li] if lead else scales}), 5, flush)
            if m in layer and name != "lm_head":  # bound now: fn reads the loop's names
                layer[m].append(functools.partial(quant.w4_matmul_decode, x, packed, scales,
                                                  layer_index=li))
            recs.append(rec)
            log(f"[k1] {name:8s} M={m:<3d} err {err:.3e} (tol {tol:.3e}; "
                f"{rec['max_ulps']:.2f} bf16 ulps of max|ref|) {'OK' if good else 'FAIL'}  kernel "
                f"{t:.4f} ms  bf16 matmul {t_bf16:.4f} ms  bound {b_ms:.4f} ms ({b_by})")
        del w_l
    t_layer = {m: time_ms(torch, lambda: [f() for f in fns], reps, flush)
               for m, fns in layer.items()}
    for m, t in t_layer.items():
        log(f"[k1] one layer's four projections (qkv, o, gate_up, down) at M={m}: {t:.4f} ms")
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
    return ok, dict(k1=recs, k1_layer_m24_ms=t_layer[24],
                    k1_layer_ms={m: t_layer[m] for m in spec}, k1_host_us=host_us)


K1_JAX_TOL = 0.06  # tests/test_quant.py:53, the JAX package's bar for one digit


def _check_k1_one_digit(torch, quant, seed, flush, dims=DIMS_8B, reps=30):
    """K1 at act_digits=1 (one int8 digit a row, ~7 bits) through its public
    wrapper: the NVILA-8B lm_head and layer 1 of a stacked qkv at M = 1, 2,
    8, 16, 17, 24 and 32, each against the one-digit plain version on the
    card within K1's tolerance (2^-7 max|ref|) and against dequantize + an
    f32 matmul within the JAX package's bar for one digit (|d| <= 0.06 +
    0.06 |ref|), timed beside the two-digit form on the same inputs, the
    plain version and dequantize + matmul; the wgmma form's one-digit
    workspace (digits and lo-plane group sums) bit for bit against
    `_w4_digits_ref(n_digits=1)` on the CPU at M = 2 and 24, and a repeat
    launch of each form bit for bit. Returns (ok, records, the wrapper's
    launches in the checked calls, timing excluded). On a generator of its
    own."""
    from vila_tpu_torch.ops import _build

    dev = flush.device
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    D, I, hd, Hq, Hkv, V = dims
    slots = {"lm_head": (synth_w4_slot(torch, gen, (), D, V), None),
             "qkv": (synth_w4_slot(torch, gen, (2,), D, (Hq + 2 * Hkv) * hd), 1)}
    ok, recs, launches = True, [], 0
    for name, (slot, li) in slots.items():
        packed, scales = slot["packed"], slot["scales"]
        layer = {"packed": packed[li] if li is not None else packed,
                 "scales": scales[li] if li is not None else scales}
        w_l = quant.dequantize(layer)
        group = quant._tiled_meta(packed, scales)[4]
        dout = w_l.shape[1]
        for m in K1_LM_ROWS:
            x = torch.randn((m, D), generator=gen, device=dev).to(torch.bfloat16)
            fn = lambda: quant.w4_matmul_decode(x, packed, scales, act_digits=1,  # noqa: E731
                                                layer_index=li)
            ref = lambda: quant._w4_gemv_ref(x, packed, scales, li, act_digits=1)  # noqa: E731
            before = _build.LAUNCHES["w4_gemv"]
            got = fn()
            digits = None
            if quant.k1_form(m, D) == "wgmma" and m in (2, 24):
                torch.cuda.synchronize()
                d_got = [t.cpu() for t in quant.k1_digits(dev)]
                d_want = quant._w4_digits_ref(x.cpu(), group=group, n_digits=1)
                digits = torch.equal(d_got[0], d_want[0]) and torch.equal(d_got[1], d_want[2])
            again = fn()
            launches += _build.LAUNCHES["w4_gemv"] - before
            want = ref()
            deq = x.float() @ w_l.float()
            torch.cuda.synchronize()
            repeat = torch.equal(got, again)
            err, scale = rel_err(torch, got, want)
            tol = 2.0 ** -7 * scale
            jax_excess = float(((got.float() - deq).abs()
                                - (K1_JAX_TOL + K1_JAX_TOL * deq.abs())).max())
            good = (bool(torch.isfinite(got.float()).all()) and err <= tol
                    and jax_excess <= 0 and repeat and digits is not False)
            ok &= good
            t1 = time_ms(torch, fn, reps, flush)
            t2 = time_ms(torch, lambda: quant.w4_matmul_decode(x, packed, scales,
                                                               layer_index=li), reps, flush)
            t_plain = time_ms(torch, ref, 5, flush)
            t_lib = time_ms(torch, lambda: x @ quant.dequantize(layer), 5, flush)
            b_ms, b_by = bound(m * D * 2 + w4_bytes(D, dout, group) + m * dout * 2,
                               2 * m * D * dout, INT8_OPS)
            rec = dict(shape=name, m=m, din=D, dout=dout, form=quant.k1_form(m, D),
                       max_abs_err=err, tol=tol, max_ulps=bf16_ulps(torch, got, want),
                       dequant_max_abs_err=float((got.float() - deq).abs().max()),
                       jax_tol_excess=jax_excess, repeat_bit_exact=repeat,
                       digits_bit_exact=digits, ok=good, ms=t1, two_digit_ms=t2,
                       plain_ms=t_plain, library_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
            recs.append(rec)
            log(f"[k1] one digit {name:8s} M={m:<3d} {rec['form']:6s} err {err:.3e} (tol "
                f"{tol:.3e}); vs dequant+matmul {rec['dequant_max_abs_err']:.3e} (JAX bar "
                f"0.06 + 0.06|ref|: {'held' if jax_excess <= 0 else 'BROKEN'}); repeat "
                f"{repeat}" + ("" if digits is None else f", digits and sums bit-exact {digits}")
                + f" {'OK' if good else 'FAIL'}  one digit {t1:.4f} ms  two digits {t2:.4f} ms"
                f"  plain {t_plain:.3f} ms  dequant+matmul {t_lib:.3f} ms  bound {b_ms:.4f} ms")
        del w_l
    return ok, recs, launches


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
    same at M=1536 and 8192, the s2 and video prompts' buckets, and at the
    ps3 phase's unpadded pass-1 M); K3 one
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
        **{name: (lambda r: r["main"]) for name in FLASH_KERNELS + ("ce_rows",)},
    }
    batched = [dict(work=f"lm_head M={m} ({path})", m=m, path=path,
                    **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "library_ms", "bf16_matmul_ms")})
               for m, path in K1_BATCHED
               for r in results.get("k1", []) if r["shape"] == "lm_head" and r["m"] == m]
    # K1 at the speculative verify forward's M = gamma + 1: one layer's four
    # projections (timings only; the spec paths' launches are in its
    # `launches_by_path`)
    spec = []
    for m in K1_SPEC_ROWS:
        rs = [r for r in results.get("k1", []) if r["m"] == m and r["shape"] != "lm_head"]
        if len(rs) == 4:
            spec.append(dict(
                work=f"one layer's 4 projections M={m} (spec gamma={m - 1})", m=m,
                max_abs_err=max(r["max_abs_err"] for r in rs), bound_by=rs[0]["bound_by"],
                **{k: sum(r[k] for r in rs) for k in ("ms", "plain_ms", "library_ms",
                                                      "bound_ms", "bf16_matmul_ms")},
                sequence_ms=results.get("k1_layer_ms", {}).get(m),
                checks_ok=all(r["ok"] for r in rs)))
    # K1 at act_digits=1 (the `k1_one_digit` check): one bs=1 step's work,
    # layer 1's qkv and the lm_head at M = 1, and the lm_head at every M
    # checked; no path asks for one digit, so its path launches are 0 and
    # the check's own stand apart
    one = results.get("k1_one_digit", [])
    one_digit = None
    if one:
        keys = ("ms", "two_digit_ms", "plain_ms", "library_ms", "bound_ms")
        step = [r for r in one if r["m"] == 1]
        one_digit = dict(
            work="qkv + lm_head M=1, act_digits=1", **{k: sum(r[k] for r in step) for k in keys},
            bound_by=step[0]["bound_by"], max_abs_err=max(r["max_abs_err"] for r in one),
            launches=0, check_launches=results.get("k1_one_digit_launches", 0),
            checks_ok=all(r["ok"] for r in one),
            lm_head=[{k: r[k] for k in ("m", "form", "max_abs_err", "dequant_max_abs_err")
                      + keys} for r in one if r["shape"] == "lm_head"])
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
    # K7-K9 at the ring's block shapes (the `sp_ring` phase), beside the main
    # entries: each step kind once, with the number of ring steps that run it
    ring = {name: [dict(work=r["shape"], steps=r["steps"], ok=r["ok"],
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")})
                   for r in results.get(name, []) if "ring" in r] for name in FLASH_KERNELS}
    # K7-K9 at a tensor-parallel rank's heads (the `tp` phase), beside the
    # main entries
    tp_rows = {name: [dict(work=f"{r['tp']}: {r['shape']}", ok=r["ok"],
                           **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")})
                      for r in results.get(name, []) if "tp" in r] for name in FLASH_KERNELS}
    out = []
    for name, meta in KERNELS.items():
        # the NVILA-8B main-path shapes (the Qwen2-0.5B checks are reported apart)
        rows = [r for r in results.get(name, [])
                if r.get("model", "NVILA-8B") == "NVILA-8B" and picks[name](r)]
        if not rows:  # a run without `train_kernels`: the tp ranks' rows
            rows = [r for r in results.get(name, []) if "tp" in r]
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
            **({"spec": spec} if name == "w4_gemv" and spec else {}),
            **({"one_digit": one_digit} if name == "w4_gemv" and one_digit else {}),
            **({"media": media[name]} if media.get(name) else {}),
            **({"ring": ring[name]} if ring.get(name) else {}),
            **({"tp": tp_rows[name]} if tp_rows.get(name) else {}),
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


def phase_e2e(torch, engine, seed, n_requests=3, new_tokens=32, tag="e2e", prompt=None,
              prefill_passes=1):
    """The serial engine (bs=1: K2 prefill, K3 + K1 decode); each request's
    ids are in its entry of the returned list. `prompt(i)` gives request
    i's prompt (default: a 448² image and a question); `prefill_passes`
    counts the LLM's forwards over a prompt before the decode (2 for PS3's
    top-down mode: the pass-1 forward, then the prefill)."""
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
                w4_gemm=4 * layers * n_requests * prefill_passes, fused_layer=layers * steps)
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


def phase_consistency(torch, engine, seed, steps=8):
    """Kernel decode path (K2 prefill, K3 + K1 decode) against a cache-free
    forward over prefix + generated tokens through the plain versions on
    the card (`plain_versions`)."""
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

    full = torch.cat([embeds, qwen2.embed_tokens(
        llm, lcfg, torch.tensor([toks], device=device))], dim=1)
    t0 = time.time()
    with plain_versions():
        h, _ = qwen2.forward(llm, lcfg, inputs_embeds=full, return_hidden=True)
        want = qwen2.compute_logits(llm, lcfg, h[:, n - 1:])[0].float().cpu()
    err = (got - want).abs().amax(-1)
    scale = want.abs().amax(-1)
    agree = int((got.argmax(-1) == want.argmax(-1)).sum())
    tol = 5e-2
    ok = bool(torch.isfinite(got).all()) and bool((err <= tol * scale).all())
    log(f"[consistency] {layers} layers, prompt {n} tokens, {steps} decode steps "
        f"(plain forward {time.time() - t0:.1f} s on the card): max |dlogit| per "
        f"step {[round(float(e), 4) for e in err]}, max |logit| "
        f"{float(scale.max()):.3f}, tolerance {tol} x max|logit|; argmax agrees "
        f"on {agree}/{steps + 1} steps -> {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=float(err.max()), max_logit=float(scale.max()),
                    tol_rel=tol, argmax_agree=agree, steps=steps + 1)


def phase_batched_consistency(torch, engine, seed, steps=8,
                              batches=((3, ("fused_layer_batched",)),
                                       (20, ("fused_o_gateup", "fused_down_qkv")))):
    """The batched decode routes against the plain cache-free forward of
    each row on the card (`plain_versions`): B = 3 rows through K6 and B =
    20 through K4/K5, each row a text prompt of its own length, prefilled
    (K2) into a bs=1
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
    ids = torch.tensor([[t for r in rows for t in r]], device=device)
    seg = torch.tensor([[i + 1 for i, r in enumerate(rows) for _ in r]], device=device)
    positions = torch.tensor([[p for ln in lens for p in range(ln)]], dtype=torch.int32,
                             device=device)
    t0 = time.time()
    ends = torch.tensor(lens).cumsum(0)
    # logits after each fed token: positions len - steps .. len - 1 of a row
    at = torch.cat([torch.arange(e - steps, e) for e in ends.tolist()]).to(device)
    with plain_versions():
        h, _ = qwen2.forward(llm, lcfg, input_ids=ids, positions=positions,
                             segment_ids=seg, return_hidden=True)
        want_all = qwen2.compute_logits(llm, lcfg, h[:, at])[0].float().cpu()
    plain_s = time.time() - t0
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
        f"{plain_s:.1f} s on the card")
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


HTTP_FORMAT = {"type": "json_schema", "json_schema": {
    "type": "object", "properties": {"number": {"type": "integer"},
                                     "parity": {"enum": ["odd", "even"]}},
    "required": ["number", "parity"]}}
HTTP_TEACHER = '{"number": 7, "parity": "odd"}'


def _post_json(url, body, timeout=300):
    """The content of one chat completion posted to `url` (a streamed one's
    deltas joined; it must end with [DONE])."""
    import urllib.request

    req = urllib.request.Request(url + "/v1/chat/completions", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        if not body.get("stream"):
            return json.loads(r.read())["choices"][0]["message"]["content"]
        lines = [ln[6:] for ln in r.read().decode().splitlines() if ln.startswith("data: ")]
    if lines[-1] != "[DONE]":
        raise ConnectionError("the stream ended before [DONE]")
    return "".join(json.loads(ln)["choices"][0]["delta"].get("content", "")
                   for ln in lines[:-1])


def phase_http(torch, engine, n_requests=4, new_tokens=16):
    """The OpenAI-compatible server on 127.0.0.1 (a free port) over a
    max_batch=8 batcher: `n_requests` concurrent text requests through the
    port's client, one of them streamed (the client raises unless the
    stream ends with [DONE]), and with them one `response_format` request
    (a JSON schema), blocking and streamed, which the batcher hands to the
    serial engine in the request's own thread while its decode loop runs
    the others. The constrained requests are taught along HTTP_TEACHER
    (`constrained_probe`), so that their loop takes one K3 step a token: K3
    and K1 from the handlers' threads beside K6 and K1 from the batcher's,
    on one stream. Checks: each batched reply is the batcher's own greedy
    answer to the same prompt; each constrained reply is the teacher's
    text, and at every step its logits and the sampler's own pick are the
    serial engine's on the same request (CONSISTENCY_TOL; picks equal or
    within K1's band); the batcher stepped while a constrained request
    decoded; K3 launched at least layers x the constrained steps, and K6
    launched."""
    import concurrent.futures as cf
    import threading

    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.serving import client, server
    from vila_tpu_torch.serving.batcher import ContinuousBatcher

    layers = engine.cfg.llm.num_hidden_layers
    prompts = [f"Say something about the number {i}." for i in range(n_requests)]
    json_prompt = "Give the number 7 and its parity as JSON."
    target = engine.tokenizer(HTTP_TEACHER, add_special_tokens=False).input_ids
    json_body = {"messages": [{"role": "user", "content": json_prompt}],
                 "max_tokens": len(target) + 1, "response_format": HTTP_FORMAT}
    with constrained_probe(torch, target) as sp:
        serial = engine.generate_content([json_prompt], GenerationConfig(
            max_new_tokens=len(target) + 1, response_format=HTTP_FORMAT))
    ref = sp.samplers[0]
    batcher = ContinuousBatcher(engine, max_batch=8, max_len=2048)
    httpd = server.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        gen_cfg = server._gen_config({"max_tokens": new_tokens, "temperature": 0})
        direct = [batcher.generate_content(server.parse_messages(
            client.build_messages(p)), gen_cfg) for p in prompts]
        steps0 = batcher.steps
        _build.reset_launches()
        t0 = time.perf_counter()
        with constrained_probe(torch, target, engine, tick=lambda: batcher.steps) as cp, \
                cf.ThreadPoolExecutor(n_requests + 2) as ex:
            futs = [ex.submit(lambda i: "".join(client.chat(
                url, client.build_messages(prompts[i]), max_tokens=new_tokens,
                temperature=0.0, stream=i == 0, timeout=300)), i)
                for i in range(n_requests)]
            json_futs = [ex.submit(_post_json, url, dict(json_body, stream=stream))
                         for stream in (False, True)]
            got = [f.result(timeout=300) for f in futs]
            json_got = [f.result(timeout=300) for f in json_futs]
        wall = time.perf_counter() - t0
        counts = dict(_build.LAUNCHES)
        steps = batcher.steps - steps0
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.shutdown()
        thread.join(timeout=30)
    ok = [g.strip() == d for g, d in zip(got, direct)]
    json_ok = [g.strip() == serial == HTTP_TEACHER for g in json_got]
    held = [_held(s.rows, s.picks, ref.rows, ref.picks) for s in cp.samplers]
    beside = [t[-1] - t[0] for t in cp.ticks.values()]  # batched steps during each
    k3_steps = len(cp.step_ms)
    launched = (k3_steps == 2 * (len(target) - 1) and counts["fused_layer_batched"] > 0
                and counts["fused_layer"] >= layers * k3_steps)
    log(f"[http] {n_requests} concurrent requests (request 0 streamed) and 2 response_format "
        f"requests (blocking, streamed) in {wall:.2f} s, {steps} batched steps: replies equal "
        f"the batcher's own greedy answers: {ok}; constrained replies, taught along "
        f"{HTTP_TEACHER!r} ({k3_steps} K3 steps in all, {beside} batched steps during each), "
        f"equal the serial engine's: {json_ok}; their rows against the serial ones: "
        f"{[(h['gap_max'], h['parts']) for h in held]}; launches {counts}; first reply "
        f"{got[0][:40]!r}")
    good = (all(ok) and all(json_ok) and len(held) == 2 and all(h["ok"] for h in held)
            and any(b > 0 for b in beside) and launched and steps > 0
            and not thread.is_alive())
    return good, dict(wall_s=wall, equal=ok, constrained_equal=json_ok, constrained=serial,
                      constrained_steps=k3_steps, batched_steps_beside=beside,
                      constrained_gap_max=[h["gap_max"] for h in held], launches=counts,
                      batched_steps=steps)


# --------------------------------------------------------------------------
# The decoding options: prompt-lookup speculative and JSON-constrained
# --------------------------------------------------------------------------

SPEC_GAMMAS = (4, 7)
SPEC_NEW_TOKENS = 20  # a stream's tokens (the default run's time bounds them)
# a prompt that repeats a span, so that the 2-gram lookup has material
SPEC_TEXT = ("Read this twice: the red cube sits on the blue table next to the green "
             "ball. Again: the red cube sits on the blue table next to the green ball. "
             "Where does the red cube sit?")
K1_BAND = 2.0 ** -7  # K1's bar, one bf16 ulp of max|logit|: its tie band (ROADMAP §3)


def parting(torch, got, want, rows):
    """Where the token stream `got` first leaves `want`, and whether that
    step is a tie of K1's band: `rows[i]` (the logits that chose want[i],
    on want's own prefix, which both streams share up to the parting step)
    puts its top two, and both streams' tokens, within K1_BAND x max|logit|
    of the top. Streams that part are compared no further."""
    n = min(len(got), len(want))
    for i in range(n):
        if got[i] != want[i]:
            row = rows[i].float()
            band = K1_BAND * float(row.abs().max())
            top2 = row.topk(2).values
            gaps = [float(top2[0] - top2[1]), float(row.max() - row[got[i]]),
                    float(row.max() - row[want[i]])]
            return dict(step=i, tie=max(gaps) <= band, gaps=gaps, band=band, compared=i + 1)
    return dict(step=None, tie=True, compared=n)


def profiled_busy(torch, fn):
    """(the device's busy ms while `fn` runs, the profile): the sum of the
    kernels' and copies' own intervals under torch.profiler (one stream:
    none overlap)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms in _device_events(prof)), prof


def _device_events(prof):
    """(name, ms) of each interval the profile traced on the device."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def _dtoh_ms(prof):
    """The device-to-host copies' ms in a profile."""
    return sum(ms for name, ms in _device_events(prof) if "DtoH" in name)


def _cache_copy(cache):
    """A copy of a decode cache that a pass may write without touching it."""
    return dict(cache, k=cache["k"].clone(), v=cache["v"].clone(), valid=cache["valid"].clone())


class spec_probe:
    """While active: each K1 launch counted by its rows (`quant.launch_gemv`,
    reached only where the kernel launches), and each speculative verify
    forward (`speculative.qwen2.forward`) timed: CUDA events around it, the
    host's issue time (the call returns once every launch is queued), and
    its start on the host clock. With `plain`, each verify forward is first
    run on a copy of the cache through the plain versions (no launch) and
    the two logits compared: max |d| / max|plain| (`gaps`), and whether the
    kernel pass's argmax ids lie within K1's band of the plain top
    (`in_band`)."""

    def __init__(self, torch, plain=False):
        self.torch, self.plain = torch, plain
        self.k1_rows, self.fwd, self.gaps, self.in_band = {}, [], [], []

    def __enter__(self):
        from vila_tpu_torch.inference import speculative
        from vila_tpu_torch.ops import quant

        torch = self.torch
        self.speculative, self.quant = speculative, quant
        self.saved = (speculative.qwen2, quant.launch_gemv)
        real_fwd, real_launch = speculative.qwen2.forward, quant.launch_gemv

        def forward(llm, cfg, **kw):
            if self.plain:
                with plain_versions():
                    want, _ = real_fwd(llm, cfg, **dict(kw, cache=_cache_copy(kw["cache"])))
            t0 = time.perf_counter()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real_fwd(llm, cfg, **kw)
            e.record()
            self.fwd.append((t0, time.perf_counter() - t0, s, e))
            if self.plain:
                got, want = out[0][0].float(), want[0].float()
                scale = want.abs().amax(-1)
                self.gaps.append(float((got - want).abs().max() / scale.max()))
                ids = got.argmax(-1)
                margin = want.max(-1).values - want.gather(-1, ids[:, None])[:, 0]
                self.in_band.append(bool((margin <= K1_BAND * scale).all()))
            return out

        def launch(x, *a, **kw):
            self.k1_rows[int(x.shape[0])] = self.k1_rows.get(int(x.shape[0]), 0) + 1
            return real_launch(x, *a, **kw)

        speculative.qwen2 = argparse.Namespace(forward=forward)
        quant.launch_gemv = launch
        return self

    def __exit__(self, *exc):
        self.speculative.qwen2, self.quant.launch_gemv = self.saved
        return False

    def timings(self):
        """(device ms of each verify forward, host issue ms of each, host ms
        from each forward's start to the next one's)."""
        self.torch.cuda.synchronize()
        dev = [s.elapsed_time(e) for _, _, s, e in self.fwd]
        issue = [1e3 * t for _, t, _, _ in self.fwd]
        starts = [t0 for t0, _, _, _ in self.fwd]
        return dev, issue, [1e3 * (b - a) for a, b in zip(starts, starts[1:])]


def _stream(engine, inputs, gen_cfg):
    """(ids, seconds to the first chunk, seconds from the first chunk to the
    last) of one `stream_ids` request."""
    t0 = time.perf_counter()
    ids, times = [], []
    for chunk in engine.stream_ids(inputs, gen_cfg):
        ids.extend(chunk)
        times.append(time.perf_counter())
    return ids, times[0] - t0, times[-1] - times[0]


def _spec_then_vanilla(torch, engine, inputs, gamma, n_spec, n_vanilla):
    """The engine's own prefill (`_start`), one speculative chunk of
    `n_spec` tokens, then `n_vanilla` width-1 greedy steps from its
    hand-off state (`_decode`, the fused K3 route): the greedy ids, the
    first token included."""
    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.inference.speculative import init_history, spec_chunk

    gen_cfg = GenerationConfig(max_new_tokens=n_spec + gamma + n_vanilla + 1)
    logits, cache, prompt_len, cache_len = engine._start(inputs, gen_cfg)
    first = int(logits[0].argmax())
    hist, hlen = init_history(inputs["input_ids"], first, cache_len + 8 * (gamma + 1))
    out, n, cur, _, pos, cache, *_ = spec_chunk(
        engine.params["llm"], engine.cfg.llm, [first], [int(inputs["input_ids"][-1])],
        prompt_len, cache, hist, hlen, max_out=n_spec, gamma=gamma)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    toks, _, _ = engine._decode(torch.tensor(cur, device=engine.device).long(), cache, pos,
                                gen, n_vanilla, gen_cfg)
    return [first] + out[:n].tolist() + toks.tolist(), n


def phase_spec(torch, engine, seed, gammas=SPEC_GAMMAS, new_tokens=SPEC_NEW_TOKENS):
    """Prompt-lookup speculative decoding (`GenerationConfig.lookup_gamma`)
    through the serial engine at full width: a 448² image + a question
    whose prompt repeats a span, and the same text alone, at 32 new tokens,
    each with gamma 4 and 7 beside the vanilla greedy stream of the same
    request. Reported: TTFT, decode tok/s speculative and vanilla, tokens
    per verify forward, each verify forward's span between CUDA events, the
    device's busy time a forward on request 0 at gamma 4 (`profiled_busy`:
    a traced stream less a traced one-token request; its host operators go
    to spec_profile.txt in OUT_DIR), host issue ms and host iteration ms,
    K1 launches by M. Checks, on every request and gamma: exact launches
    (K1 at M = 1 for the prefill's lm_head, then (4 x layers + 1) at
    M = gamma + 1 a verify forward; K2 4 x layers; no K3); the speculative
    stream equals the vanilla one or parts only at a tie of K1's band of
    the vanilla path's own logits (`parting`); every K1 and K2 call of the
    stream within its bar of its plain version on the same inputs
    (`tap_calls`; the `k1` rows hold K1 at M = 5 and 8 over a layer's four
    projections), every verify forward against the same forward through
    the plain versions on a copy of its cache (CONSISTENCY_TOL, and the
    kernel's argmax ids within K1's band of the plain top). On request 0 at
    gamma 4, a speculative chunk of 12 tokens followed by 12 width-1 steps
    equals the vanilla stream up to such a tie (stale slots masked at the
    hand-off)."""
    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.ops import _build

    layers = engine.cfg.llm.num_hidden_layers
    prompts = {"image": [_images(seed + 11, 1)[0], SPEC_TEXT], "text": SPEC_TEXT}
    base = dict(max_new_tokens=new_tokens, stop_token_ids=(-1,))
    _stream(engine, engine.prepare_inputs(prompts["text"]),
            GenerationConfig(lookup_gamma=gammas[0], **base))  # warm-up
    ok, out, launches = True, {}, {}
    for tag, prompt in prompts.items():
        inputs = engine.prepare_inputs(prompt)
        van, v_ttft, v_dec = _stream(engine, inputs, GenerationConfig(**base))
        rows, _ = _forced_logits(torch, engine, inputs, van)  # the vanilla path's logits
        v_tok_s = (len(van) - 1) / v_dec
        log(f"[spec] {tag}: prompt {inputs['input_ids'].shape[0]} tokens; vanilla TTFT "
            f"{1e3 * v_ttft:.1f} ms, decode {v_tok_s:.1f} tok/s")
        for gamma in gammas:
            gen_cfg = GenerationConfig(lookup_gamma=gamma, **base)
            first = tag == "image" and gamma == gammas[0]
            _build.reset_launches()
            with spec_probe(torch) as pr:
                ids, ttft, dec = _stream(engine, inputs, gen_cfg)
            counts = dict(_build.LAUNCHES)
            dev_ms, issue_ms, iter_ms = pr.timings()
            iters = len(dev_ms)
            # the device's own time a verify forward (request 0 at gamma 4): the
            # traced stream's busy time less the prefill's (a one-token
            # request), over the forwards
            own_ms, ids2 = None, ids
            if first:
                out_p = []
                busy, prof = profiled_busy(torch, lambda: out_p.append(
                    _stream(engine, inputs, gen_cfg)[0]))
                busy_1, _ = profiled_busy(torch, lambda: _stream(
                    engine, inputs, GenerationConfig(max_new_tokens=1, stop_token_ids=(-1,))))
                own_ms, ids2 = (busy - busy_1) / iters, out_p[0]
                os.makedirs(OUT_DIR, exist_ok=True)
                with open(os.path.join(OUT_DIR, "spec_profile.txt"), "w") as f:
                    f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                                      row_limit=40))
                host = sorted(((e.key, e.self_cpu_time_total / 1e3 / iters, e.count / iters)
                               for e in prof.key_averages()), key=lambda r: -r[1])[:8]
            t0 = time.perf_counter()
            want = dict(_no_launches(), w4_gemv=1 + iters * (4 * layers + 1),
                        w4_gemm=4 * layers)
            want_rows = {1: 1, gamma + 1: iters * (4 * layers + 1)}
            part = parting(torch, ids, van, rows)
            checks = dict(launches=counts == want and pr.k1_rows == want_rows,
                          repeat=ids2 == ids, length=len(ids) == new_tokens,
                          stream=part["tie"])
            rec = dict(
                prompt_tokens=int(inputs["input_ids"].shape[0]), gamma=gamma, ttft_ms=1e3 * ttft,
                decode_tok_s=(len(ids) - 1) / dec, vanilla_ttft_ms=1e3 * v_ttft,
                vanilla_decode_tok_s=v_tok_s, verify_forwards=iters,
                tokens_per_forward=(len(ids) - 1) / iters,
                verify_ms_median=statistics.median(dev_ms),
                verify_busy_ms=own_ms,
                issue_ms_median=statistics.median(issue_ms),
                iteration_ms_median=statistics.median(iter_ms) if iter_ms else None,
                k1_by_m=pr.k1_rows, launches=counts, parting=part, ids=ids, vanilla=van)
            rec["issue_share"] = (rec["issue_ms_median"] / rec["iteration_ms_median"]
                                  if iter_ms else None)
            # every call against its plain version (the `k1` rows hold K1 at
            # M = 5 and 8 on a layer's four projections), every verify forward
            # against the plain pass on a copy of its cache
            with tap_calls(engine.cfg.llm.vocab_size, check=True) as tk:
                checked, _, _ = _stream(engine, inputs, gen_cfg)
            checks["local"] = tk.local_ok() and checked == ids
            rec["local_max"] = {k: max((e / s for e, s in v), default=0.0)
                                for k, v in tk.local.items()}
            rec["k1_calls_checked"] = len(tk.local["w4_gemv"])
            with spec_probe(torch, plain=True) as pp:
                forced, _, _ = _stream(engine, inputs, gen_cfg)
            checks["verify_forwards"] = (forced == ids and len(pp.gaps) == iters
                                         and all(pp.in_band) and max(pp.gaps) <= CONSISTENCY_TOL)
            rec["verify_gap_max"] = max(pp.gaps)
            rec["verify_in_band"] = sum(pp.in_band)
            if first:
                hand, n_spec = _spec_then_vanilla(torch, engine, inputs, gamma, 12, 12)
                rec["spec_then_vanilla"] = parting(torch, hand, van, rows)
                rec["spec_then_vanilla"]["spec_tokens"] = n_spec
                checks["spec_then_vanilla"] = rec["spec_then_vanilla"]["tie"]
            rec["checks"], rec["checks_s"] = checks, time.perf_counter() - t0
            good = all(checks.values())
            ok &= good
            out[f"{tag} gamma={gamma}"] = rec
            launches[f"spec {tag} g{gamma}"] = counts
            log(f"[spec] {tag} gamma={gamma}: TTFT {1e3 * ttft:.1f} ms, decode "
                f"{rec['decode_tok_s']:.1f} tok/s (vanilla {v_tok_s:.1f}); {iters} verify "
                f"forwards, {rec['tokens_per_forward']:.2f} tokens each; verify forward "
                f"{rec['verify_ms_median']:.2f} ms between its events, device busy "
                + ("not traced" if own_ms is None else f"{own_ms:.2f} ms (traced)")
                + f", host issue {rec['issue_ms_median']:.2f} ms of a "
                f"{rec['iteration_ms_median']:.2f} ms iteration; K1 launches by M "
                f"{pr.k1_rows}; stream against vanilla: "
                + ("equal" if part["step"] is None else
                   f"parts at step {part['step']} (gaps {part['gaps']}, band "
                   f"{part['band']:.4f})")
                + f"; {rec['k1_calls_checked']} K1 calls checked, local max {rec['local_max']}"
                + (f"; host self ms (calls) a forward, traced: " + ", ".join(
                    f"{k} {t:.2f} ({c:.0f})" for k, t, c in host) if first else "")
                + f"; verify forwards against plain: gap max {rec['verify_gap_max']:.4f}, "
                f"{rec['verify_in_band']}/{len(pp.in_band)} in band"
                + (f"; spec then vanilla {rec['spec_then_vanilla']}" if first else "")
                + f"; checks {rec['checks_s']:.1f} s -> {'OK' if good else 'FAIL ' + str(checks)}")
    return ok, out, launches


CONSTRAINED_SCHEMA = {"type": "object",
                      "properties": {"name": {"type": "string"},
                                     "colour": {"enum": ["red", "green", "blue"]}},
                      "required": ["name", "colour"]}
PROBE_SCHEMA = {"type": "object", "properties": {"answer": {"enum": ["yes", "no"]}},
                "required": ["answer"]}


class constrained_probe:
    """While active, `JsonConstrainedSampler.pick` runs as it is on each
    step's logits, timed on the host, and each sampler keeps its rows (f32,
    on the CPU) and its own picks (`sampler.rows`, `sampler.picks`; the
    samplers in `samplers`); `grammar_token_mask` is timed and its cache
    misses counted. With `target` (the token ids of a JSON text), the
    sampler then takes the target's next token in place of its own pick:
    the engine's own loop (`_constrained_loop` and `_decode_one`) decodes
    along the target, whatever the random weights would pick. With
    `engine`, that engine's own `_decode_one` is wrapped: the host's ms in
    each step (the forward's issue, the wait for the device and the (V,)
    f32 copy), and with `tick` that callable's value before each step, by
    thread (`ticks`). With `plain` too, its own `_prefill` and each step
    first run on a copy of the cache under `plain_versions`, and the
    sampler's own pick on that plain row is kept beside the kernel's
    (`sampler.plain`, `sampler.plain_picks`)."""

    def __init__(self, torch, target=None, engine=None, plain=False, tick=None):
        self.torch, self.target, self.engine, self.plain, self.tick = (
            torch, target, engine, plain, tick)
        self.samplers, self.pick_ms, self.mask_ms, self.step_ms = [], [], [], []
        self.misses, self.ticks = 0, {}
        self._plain_row, self._quiet = None, False

    def __enter__(self):
        import threading

        import numpy as np

        from vila_tpu_torch.inference import constrained

        torch, mod = self.torch, constrained
        self.mod = mod
        self.saved = (mod.JsonConstrainedSampler.pick, mod.grammar_token_mask)
        pick, mask = self.saved

        def probed_pick(sampler, logits):
            if not hasattr(sampler, "rows"):
                sampler.rows, sampler.picks, sampler.plain, sampler.plain_picks = [], [], [], []
                self.samplers.append(sampler)
            state = (list(sampler._ids), sampler.text)
            t0 = time.perf_counter()
            tid = pick(sampler, logits)
            self.pick_ms.append(1e3 * (time.perf_counter() - t0))
            sampler.rows.append(torch.from_numpy(np.asarray(logits, np.float32).copy()))
            sampler.picks.append(tid)
            if self.plain:
                own = (sampler._ids, sampler.text)
                sampler._ids, sampler.text = list(state[0]), state[1]
                self._quiet = True
                sampler.plain.append(self._plain_row)
                sampler.plain_picks.append(pick(sampler, self._plain_row.numpy()))
                self._quiet = False
                sampler._ids, sampler.text = own
            if self.target is None:
                return tid
            sampler._ids, sampler.text = state
            i = len(state[0])
            return sampler._accept(int(self.target[i])) if i < len(self.target) else None

        def timed_mask(tok, automaton):
            n = len(mod._MASK_CACHE)
            t0 = time.perf_counter()
            m = mask(tok, automaton)
            if not self._quiet:
                self.mask_ms.append(1e3 * (time.perf_counter() - t0))
                self.misses += len(mod._MASK_CACHE) > n
            return m

        mod.JsonConstrainedSampler.pick, mod.grammar_token_mask = probed_pick, timed_mask
        eng = self.engine
        if eng is not None:
            prefill, step = eng._prefill, eng._decode_one

            def plain_prefill(ids, valid, media, media_pos, cache, prompt_len):
                with plain_versions():
                    want, _ = prefill(ids, valid, media, media_pos, _cache_copy(cache),
                                      prompt_len)
                self._plain_row = want[0].float().cpu()
                return prefill(ids, valid, media, media_pos, cache, prompt_len)

            def probed_step(tok, cache, pos):
                if self.plain:
                    with plain_versions():
                        want, _ = step(tok, _cache_copy(cache), pos)
                    self._plain_row = torch.from_numpy(want)
                if self.tick is not None:
                    self.ticks.setdefault(threading.get_ident(), []).append(self.tick())
                t0 = time.perf_counter()
                out = step(tok, cache, pos)
                self.step_ms.append(1e3 * (time.perf_counter() - t0))
                return out

            if self.plain:
                eng._prefill = plain_prefill
            eng._decode_one = probed_step
        return self

    def __exit__(self, *exc):
        self.mod.JsonConstrainedSampler.pick, self.mod.grammar_token_mask = self.saved
        if self.engine is not None:
            for name in ("_prefill", "_decode_one"):  # the class's methods again
                self.engine.__dict__.pop(name, None)
        return False


def _held(rows, picks, want_rows, want_picks):
    """One constrained stream's logits rows and own picks against another's
    on the same steps: (the largest max |d| / max|want| of a row, the steps
    where the picks differ, each with whether the two picks lie within
    K1's band of the want row)."""
    gaps, parts = [], []
    for i, (got, want, a, b) in enumerate(zip(rows, want_rows, picks, want_picks)):
        scale = float(want.abs().max())
        gaps.append(float((got - want).abs().max()) / scale)
        if a != b:
            gap = None if a is None or b is None else float(want[b] - want[a])
            parts.append(dict(step=i, got=a, want=b, gap=gap,
                              tie=gap is not None and gap <= K1_BAND * scale))
    n = min(len(rows), len(want_rows))
    return dict(gap_max=max(gaps, default=0.0), parts=parts, compared=n,
                ok=len(rows) == len(want_rows) and max(gaps, default=0.0) <= CONSISTENCY_TOL
                and all(p["tie"] for p in parts))


def _scalar_prefix(text):
    """A bare top-level number or literal prefix such as "-", "1.", "2e",
    "t" or "fal": the reference's validator calls it complete (its scan
    ends inside a number or literal at depth 0), so the sampler stops
    there, though `json.loads` rejects it (ROADMAP §3)."""
    import re

    return re.fullmatch(r"\s*(-?[0-9]*\.?[0-9]*([eE][-+]?[0-9]*)?|t(r(ue?)?)?|f(a(l(se?)?)?)?"
                        r"|n(u(ll?)?)?)\s*", text) is not None


def _schema_fault(value, schema):
    """How a complete answer misses what its request asked for in the way
    the reference's guide lets it (ROADMAP §3), or None: the guide narrows
    only the object keys at depth 1, and holds neither a top-level object
    (for `json_object`, `schema` None, too), nor the required keys, nor an
    enum's values."""
    if not isinstance(value, dict):
        return "not an object"
    if schema is None:
        return None
    missing = [k for k in schema.get("required", ()) if k not in value]
    if missing:
        return f"required keys missing: {missing}"
    outside = [k for k, p in schema.get("properties", {}).items()
               if "enum" in p and k in value and value[k] not in p["enum"]]
    return f"values outside their enum: {outside}" if outside else None


def phase_constrained(torch, engine, seed, new_tokens=48, dev="cuda"):
    """JSON-constrained decoding (`GenerationConfig.response_format`)
    through the serial engine: the e2e engine (NVILA-8B, ByteTokenizer)
    with {"type": "json_object"} and a JSON schema of two required
    properties (a string and an enum), 48 new tokens on a 448² image and a
    question; then the committed quant probe through `entry.load` (its
    `tokenizer.json`, vocab 512), its LLM quantized to W4 on the card, a
    pope-mini image and question with a schema whose property is the
    yes/no enum. The request as served (the random weights' own answer,
    which may end after one token): a valid JSON prefix, complete and
    parsed where the sampler says done (or the reference's scalar-prefix
    fault, `_scalar_prefix`, reported), an object's keys in the schema's
    order (an answer the guide lets miss its schema reported as the
    reference's fault, `_schema_fault`), the stream equal to the same
    request's under `plain_versions` or parting only at a step where the
    plain logits put the two picks within K1's band, exact launches. Then
    the same request through the engine's own loop taught along a JSON
    text (`constrained_probe`: one K3 step a token): its text, exact
    launches (K2 for the prefill, per step K3 a layer and K1 twice), and
    at every step the logits against the plain versions' on a copy of the
    cache (CONSISTENCY_TOL) and the sampler's own pick on each row equal or
    within K1's band. Reported: TTFT; the vocab table's and each new
    state's grammar mask's build time; per taught token the device's busy
    ms (`profiled_busy`: the taught stream less a one-token request, over
    its steps) and its logits copy's share, the host's ms in the step, the
    sampler's pick (mask and validator) and the mask alone."""
    from vila_tpu_torch import entry
    from vila_tpu_torch.eval import benchmarks, quant_acc
    from vila_tpu_torch.inference import constrained
    from vila_tpu_torch.inference.generate import GenerationConfig, GenerationEngine
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.ops.quant import quantize_llm_params

    probe = entry.load(quant_acc.PROBE, device=dev)
    probe = GenerationEngine(dict(probe.params, llm=quantize_llm_params(
        probe.params["llm"], bits=4, fuse=True, cfg=probe.cfg.llm)), probe.cfg,
        probe.tokenizer, device=dev)
    ds_path = benchmarks.resolve_dataset(quant_acc.DATASET)
    row = benchmarks.load_dataset(ds_path)[0]
    from PIL import Image

    with Image.open(os.path.join(os.path.dirname(ds_path), row["image"])) as img:
        img.load()
        probe_prompt = [img, row["question"] + " Answer in JSON."]
    image = _images(seed + 21, 1)[0]
    requests = [  # (tag, engine, prompt, response_format, schema, teacher text)
        ("json_object", engine, [image, "Describe the image as JSON."],
         {"type": "json_object"}, None, '{"objects": ["cube", "ball"], "count": 2}'),
        ("json_schema", engine, [image, "Name the main object and its colour in JSON."],
         {"type": "json_schema", "json_schema": CONSTRAINED_SCHEMA}, CONSTRAINED_SCHEMA,
         '{"name": "red cube", "colour": "red"}'),
        ("probe json_schema", probe, probe_prompt,
         {"type": "json_schema", "json_schema": PROBE_SCHEMA}, PROBE_SCHEMA,
         '{"answer": "yes"}'),
    ]
    ok, out, launches = True, {}, {}
    val = constrained.JsonPrefixValidator()
    f3 = lambda x: "-" if x is None else f"{x:.3f}"  # noqa: E731
    med = lambda xs: statistics.median(xs) if xs else None  # noqa: E731
    for tag, eng, prompt, rf, schema, teacher in requests:
        layers = eng.cfg.llm.num_hidden_layers
        inputs = eng.prepare_inputs(prompt)
        _stream(eng, inputs, GenerationConfig(max_new_tokens=2, stop_token_ids=(-1,)))
        # the grammar's tables from scratch: the vocab texts, then each state's mask
        tok = eng.tokenizer
        constrained._TOKEN_TABLE_CACHE.pop(id(tok), None)
        for key in [k for k in list(constrained._MASK_CACHE) if k[0] == id(tok)]:
            constrained._MASK_CACHE.pop(key, None)
        t0 = time.perf_counter()
        n_texts = len(constrained._token_texts(tok))
        table_ms = 1e3 * (time.perf_counter() - t0)
        # the request as served: the random weights' own answer
        served = GenerationConfig(max_new_tokens=new_tokens, response_format=rf)
        _build.reset_launches()
        with constrained_probe(torch, engine=eng) as pr:
            ids, ttft, _ = _stream(eng, inputs, served)
        counts = dict(_build.LAUNCHES)
        with plain_versions(), constrained_probe(torch) as pp:
            plain_ids, _, _ = _stream(eng, inputs, served)
        steps = len(pr.step_ms)
        want = dict(_no_launches(), w4_gemm=4 * layers, w4_gemv=1 + 2 * steps,
                    fused_layer=layers * steps)
        text = tok.decode(ids, skip_special_tokens=True)
        done = val.is_complete(text)
        parsed = order = fault = schema_fault = None
        if done:
            try:
                value = json.loads(text)
                parsed = True
                schema_fault = _schema_fault(value, schema)
                order = (not isinstance(value, dict) or schema is None
                         or list(value) == [k for k in schema["properties"] if k in value])
            except ValueError:
                parsed, fault = False, _scalar_prefix(text)
        part = dict(step=None, tie=True)
        for i, (a, b) in enumerate(zip(ids, plain_ids)):
            if a != b:  # the plain row that chose b: the two picks within K1's band?
                r = pp.samplers[0].rows[i]
                band = K1_BAND * float(r.abs().max())
                part = dict(step=i, gap=float(r[b] - r[a]), band=band,
                            tie=float(r[b] - r[a]) <= band)
                break
        same_len = part["step"] is not None or len(ids) == len(plain_ids)
        # the same request taught along `teacher`, through the engine's own loop
        target = tok(teacher, add_special_tokens=False).input_ids
        taught = GenerationConfig(max_new_tokens=len(target) + 1, response_format=rf)
        _build.reset_launches()
        with constrained_probe(torch, target, eng, plain=True) as tp:
            t_ids, _, _ = _stream(eng, inputs, taught)
        t_counts = dict(_build.LAUNCHES)
        t_steps = len(tp.step_ms)
        t_want = dict(_no_launches(), w4_gemm=4 * layers, w4_gemv=1 + 2 * t_steps,
                      fused_layer=layers * t_steps)
        s = tp.samplers[0]
        held = _held(s.rows, s.picks, s.plain, s.plain_picks)
        with constrained_probe(torch, target, eng) as tt:  # host times, no plain pass
            _stream(eng, inputs, taught)
        with constrained_probe(torch, target):
            busy, prof = profiled_busy(torch, lambda: _stream(eng, inputs, taught))
        busy_1, prof_1 = profiled_busy(torch, lambda: _stream(
            eng, inputs, GenerationConfig(max_new_tokens=1, stop_token_ids=(-1,))))
        checks = dict(prefix=bool(text) and val.is_valid_prefix(text),
                      complete=not done or bool(parsed) or fault,
                      order=not done or bool(order) or fault,
                      plain=part["tie"] and same_len, launches=counts == want,
                      taught_text=(tok.decode(t_ids, skip_special_tokens=True) == teacher
                                   and len(t_ids) == len(target) and s.done()),
                      taught_launches=t_counts == t_want and t_steps == len(target) - 1,
                      taught_plain=held["ok"])
        rec = dict(new_tokens=len(ids), text=text, done=done, scalar_prefix_fault=fault,
                   schema_fault=schema_fault, ttft_ms=1e3 * ttft, served_steps=steps,
                   vocab_texts=n_texts, table_ms=table_ms,
                   masks_built=pr.misses + tp.misses,
                   mask_build_ms_max=max(pr.mask_ms + tp.mask_ms),
                   teacher=teacher, taught_steps=t_steps, taught_launches=t_counts,
                   taught_gap_max=held["gap_max"], taught_parts=held["parts"],
                   step_device_ms=(busy - busy_1) / t_steps,
                   copy_device_ms=(_dtoh_ms(prof) - _dtoh_ms(prof_1)) / t_steps,
                   step_host_ms=med(tt.step_ms), pick_ms=med(tt.pick_ms),
                   mask_ms=med(tt.mask_ms), plain_ids=plain_ids, parting=part,
                   launches=counts, checks=checks)
        good = all(checks.values())
        ok &= good
        out[tag] = rec
        launches[f"constrained {tag}"] = counts
        launches[f"constrained {tag} taught"] = t_counts
        log(f"[constrained] {tag}: {len(ids)} tokens {text[:60]!r} (done {done}"
            + (", the reference's scalar-prefix fault" if fault else "")
            + (f", the reference's schema-guide fault: {schema_fault}" if schema_fault else "")
            + f"); TTFT {rec['ttft_ms']:.1f} ms; vocab table {n_texts} texts in "
            f"{table_ms:.1f} ms, {rec['masks_built']} masks built (slowest "
            f"{rec['mask_build_ms_max']:.1f} ms); against plain: "
            + ("equal" if part["step"] is None else f"parts at step {part['step']} {part}")
            + f"; launches {counts}. Taught along {teacher!r}: {t_steps} steps, launches "
            f"{t_counts}, logits against plain gap max {held['gap_max']:.4f}, picks parting "
            f"{held['parts']}; per token: device busy {f3(rec['step_device_ms'])} ms "
            f"(logits copy {f3(rec['copy_device_ms'])}), host in the step "
            f"{f3(rec['step_host_ms'])}, pick {f3(rec['pick_ms'])} (mask "
            f"{f3(rec['mask_ms'])}) -> {'OK' if good else 'FAIL ' + str(checks)}")
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    return ok, out, launches

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


def config_from_files(base, top_fields, vision_tower=None, dev="cuda"):
    """A VLMConfig through `entry.build_config` from config.json files alone:
    `base`'s component configs (`entry.save_config`) under the git-ignored
    `runs/`, the vision tower's config.json replaced by `vision_tower` when
    given, the top-level config.json given `top_fields` (its mm_hidden_size
    left to build_config), read back and removed."""
    import shutil
    import tempfile

    from vila_tpu_torch import entry

    os.makedirs("runs", exist_ok=True)
    d = tempfile.mkdtemp(prefix="cfg_", dir="runs")
    try:
        entry.save_config(base, d)
        if vision_tower is not None:
            with open(os.path.join(d, "vision_tower", "config.json"), "w") as f:
                json.dump(vision_tower, f)
        with open(os.path.join(d, "config.json")) as f:
            top = json.load(f)
        top.pop("mm_hidden_size")
        top.update(top_fields)
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(top, f)
        cfg = entry.build_config(d, dtype=base.llm.dtype, device=dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if cfg.llm != base.llm or (vision_tower is None and cfg.vision != base.vision):
        raise RuntimeError(f"build_config read back another model: {cfg}")
    return cfg


def media_config(kind, serving, dev="cuda"):
    """The phase's VLMConfig through `config_from_files`: the serving
    configuration's (`serving`, the e2e engine's) with the phase's
    projector type and top-level fields."""
    import dataclasses

    fields, ptype, _, _ = MEDIA_PHASES[kind]
    base = dataclasses.replace(
        serving, projector=dataclasses.replace(serving.projector, projector_type=ptype))
    return config_from_files(base, fields, dev=dev)


class plain_versions:
    """The reference side of a comparison on the card: while active, the
    W4 wrappers compute their plain versions (`quant._w4_gemv_ref`,
    `_w4_gemm_ref`, `fused_decode._fused_layer_ref`: K1, K2, K3), the
    flash wrappers theirs (`flash_fwd_plain`, `flash_bwd_dq_plain`,
    `flash_bwd_dkv_plain`: K7, K8, K9), the LM head's row kernel its own
    (`cross_entropy.ce_rows_plain`) and the fp8 product the f32 product
    of the same fp8 bytes (`fp8.fp8_mm_plain`, in place of
    `torch._scaled_mm`) on the card's tensors, and no kernel may launch.
    The port's wrappers never do this themselves."""

    def __enter__(self):
        from vila_tpu_torch.ops import (_build, cross_entropy, flash_attention, fp8,
                                        fused_decode, quant)

        self.quant, self.fd, self.fa, self.fp8 = quant, fused_decode, flash_attention, fp8
        self.ce = cross_entropy
        self.saved = (quant.w4_matmul_decode, quant.w4_matmul_prefill, fused_decode.fused_layer,
                      flash_attention.flash_fwd, flash_attention.flash_bwd_dq,
                      flash_attention.flash_bwd_dkv, fp8._fp8_mm, cross_entropy.ce_rows)
        self.before = dict(_build.LAUNCHES)
        cross_entropy.ce_rows = cross_entropy.ce_rows_plain
        flash_attention.flash_fwd = flash_attention.flash_fwd_plain
        flash_attention.flash_bwd_dq = flash_attention.flash_bwd_dq_plain
        flash_attention.flash_bwd_dkv = flash_attention.flash_bwd_dkv_plain
        fp8._fp8_mm = fp8.fp8_mm_plain
        quant.w4_matmul_decode = (lambda x, packed, scales, act_digits=2, layer_index=None:
                                  quant._w4_gemv_ref(x, packed, scales, layer_index,
                                                     act_digits=act_digits))
        quant.w4_matmul_prefill = (lambda x, packed, scales, layer_index=None:
                                   quant._w4_gemm_ref(x, packed, scales, layer_index))
        fused_decode.fused_layer = fused_decode._fused_layer_ref
        return self

    def __exit__(self, *exc):
        from vila_tpu_torch.ops import _build

        (self.quant.w4_matmul_decode, self.quant.w4_matmul_prefill, self.fd.fused_layer,
         self.fa.flash_fwd, self.fa.flash_bwd_dq, self.fa.flash_bwd_dkv,
         self.fp8._fp8_mm, self.ce.ce_rows) = self.saved
        if exc[0] is None and dict(_build.LAUNCHES) != self.before:
            raise RuntimeError("a kernel launched inside plain_versions")
        return False


# each kernel's bar against its plain version on the same inputs (the
# `kernels` phase's): K1 and K2 one bf16 ulp of max|ref|, K3 1e-2 max|ref|
LOCAL_TOL = {"w4_gemv": 2.0 ** -7, "w4_gemm": 2.0 ** -7, "fused_layer": 1e-2}


class tap_calls:
    """While active, K1, K2 and K3 (`quant.w4_matmul_decode`,
    `w4_matmul_prefill`, `fused_decode.fused_layer`, whatever they are on
    entry: the kernels, or inside `plain_versions` their plain versions)
    are wrapped: `h` collects each K3 call's new hidden row (f32), `lm` each
    unstacked output `vocab` wide (the lm_head's logits, f32 on the CPU). With
    `check`, every call is also run through its plain version on the same
    inputs: `local[kernel]` collects (max |d|, max|ref|) per call, K3's
    over h and qkv, and `lm_plain` the lm_head's plain logits."""

    def __init__(self, vocab, check=False):
        self.vocab, self.check = vocab, check
        self.h, self.lm, self.lm_plain = [], [], []
        self.local = {k: [] for k in LOCAL_TOL}

    def _gap(self, name, got, want):
        got, want = got.float(), want.float()
        self.local[name].append((float((got - want).abs().max()), float(want.abs().max())))

    def __enter__(self):
        from vila_tpu_torch.ops import fused_decode, quant

        self.quant, self.fd = quant, fused_decode
        self.saved = k1, k2, k3 = (quant.w4_matmul_decode, quant.w4_matmul_prefill,
                                   fused_decode.fused_layer)

        def gemv(x, packed, scales, act_digits=2, layer_index=None):
            y = k1(x, packed, scales, act_digits=act_digits, layer_index=layer_index)
            ref = None
            if self.check:
                ref = quant._w4_gemv_ref(x, packed, scales, layer_index, act_digits=act_digits)
                self._gap("w4_gemv", y, ref)
            if layer_index is None and y.shape[-1] == self.vocab:
                self.lm.append(y.float().cpu())
                if ref is not None:
                    self.lm_plain.append(ref.float().cpu())
            return y

        def gemm(x, packed, scales, layer_index=None):
            y = k2(x, packed, scales, layer_index=layer_index)
            if self.check:
                self._gap("w4_gemm", y, quant._w4_gemm_ref(x, packed, scales, layer_index))
            return y

        def layer(*args, **kw):
            h, qkv = k3(*args, **kw)
            self.h.append(h[0].float())
            if self.check:
                h_r, qkv_r = fused_decode._fused_layer_ref(*args, **kw)
                self._gap("fused_layer", h[0], h_r[0])
                self._gap("fused_layer", qkv[0], qkv_r[0])
            return h, qkv

        quant.w4_matmul_decode, quant.w4_matmul_prefill, fused_decode.fused_layer = \
            gemv, gemm, layer
        return self

    def __exit__(self, *exc):
        (self.quant.w4_matmul_decode, self.quant.w4_matmul_prefill,
         self.fd.fused_layer) = self.saved
        return False

    def local_ok(self):
        return all(e <= LOCAL_TOL[k] * s for k, calls in self.local.items() for e, s in calls)


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


# VILA-HD's PS3 tower at the repository's defaults (`PS3Config.from_hf_config`
# with no fields of its own: a SigLIP-SO400M trunk, scales 378 / 756 / 1512,
# 64 tokens a high scale, one look-close pass; VILA-HD's own config.json is
# not in the repository): 27² + 2 x 64 = 857 tokens an image
PS3_TOWER = dict(model_type="ps3_vision_model", hidden_size=1152, intermediate_size=4304,
                 num_hidden_layers=27, num_attention_heads=16, patch_size=14,
                 ps3_scales=[378, 756, 1512], num_hires_select=64, num_look_close=1)
PS3_IMAGE = (1134, 1512, 3)  # 4:3, resized to each scale's square
PS3_RUN = (2, 32, 16)  # top-down requests x new tokens, then one one-pass request's tokens


def ps3_engine(torch, e2e, seed, tower, mode, dev="cuda", params=None):
    """(engine, want_cfg): VILA-HD through `config_from_files` (the e2e
    engine's LLM config, `tower` as the vision tower's config.json, an
    mlp2x_gelu projector, `mode` as the top config's ps3_look_close_mode),
    the e2e engine's W4 LLM, a seeded bf16 PS3 tower and projector, or
    `params` when given."""
    import dataclasses

    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import projector, ps3

    base = dataclasses.replace(e2e.cfg, projector=dataclasses.replace(
        e2e.cfg.projector, projector_type="mlp2x_gelu"))
    cfg = config_from_files(base, {"ps3_look_close_mode": mode}, vision_tower=tower, dev=dev)
    vis = cfg.vision
    side = vis.low_grid
    want_cfg = (cfg.vision_tower_type == "ps3" and cfg.ps3_look_close_mode == mode
                and vis.s3_scales == tuple(tower["ps3_scales"])
                and vis.k_per_scale == tower["num_hires_select"]
                and vis.prompt_dim == cfg.llm.hidden_size
                and vis.vit.intermediate_size == tower["intermediate_size"]
                and cfg.projector.mm_hidden_size == tower["hidden_size"]
                and cfg.tokens_per_image == side * side + 2 * vis.k_per_scale
                and cfg.ps3_tokens_low == side * side)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed + 50)
        params = {"llm": e2e.params["llm"],
                  "vision_tower": ps3.init_params(gen, vis, torch.bfloat16),
                  "mm_projector": projector.init_params(gen, cfg.projector, torch.bfloat16)}
    return GenerationEngine(params, cfg, e2e.tokenizer, device=dev), want_cfg


def phase_ps3(torch, e2e, seed, dev="cuda", tower=PS3_TOWER, run=PS3_RUN):
    """VILA-HD's two-pass top-down serving at full width through the entry
    points: `config_from_files` (a PS3 tower config.json, mlp2x_gelu,
    "after_prompt"), `prepare_inputs` (one resized view a scale of a seeded
    1512 x 1134 image, and the pass-1 prompt with the low-res tokens alone),
    `_ps3_top_down_prompt` (pass-1 encode, then the cache-free LLM forward
    over the unpadded prompt: K2 at its M), `encode_media` (the selection
    steered by that prompt, pass 2), K2 prefill, K3 + K1 decode; the W4 LLM
    is the e2e engine's. Checks: the config's widths; the prompt's layout;
    exact K1-K3 launches (K2 twice a request); every K1, K2 and K3 call of
    request 0's teacher-forced path against its plain version on its own
    inputs, with the served tokens in K1's band of the plain lm_head
    (`served_against_plain`; the plain pass takes the kernel pass's
    selection, and the overlap of its own is reported) and, end to end, of
    the plain pass's own top at every step (at this cell's depth and
    draw; the `awq` phase reports it instead: PERF.md §6); the card's top-k
    order equal to the CPU's on the same scores; one "after_image" request
    (one pass) with exact launches. Times the TTFT's parts and K2 at the
    pass-1 M."""
    import numpy as np

    from vila_tpu_torch.inference.generate import (PROMPT_BUCKETS, _bucket, _round_up,
                                                   padded_prompt, sample_token)
    from vila_tpu_torch.models import ps3, qwen2
    from vila_tpu_torch.ops import quant
    from vila_tpu_torch.utils.device import host_to_device

    n_requests, new_tokens, one_pass_tokens = run
    out, ok = {}, True
    torch.cuda.reset_peak_memory_stats()
    engine, want_cfg = ps3_engine(torch, e2e, seed, tower, "after_prompt", dev)
    cfg, vis = engine.cfg, engine.cfg.vision
    ok &= want_cfg
    rng = np.random.default_rng(seed + 51)
    images = [rng.integers(0, 256, PS3_IMAGE, dtype=np.uint8) for _ in range(n_requests + 1)]
    prompt = lambda i: [images[i], QUESTIONS[i % len(QUESTIONS)]]  # noqa: E731
    log(f"[ps3] entry.build_config: tower {cfg.vision_tower_type}, trunk "
        f"{vis.vit.hidden_size} x {vis.vit.num_hidden_layers} layers, scales {vis.s3_scales}, "
        f"{vis.k_per_scale} selected a high scale, prompt head {vis.prompt_dim} -> "
        f"{vis.hidden_size}, projector {cfg.projector.projector_type}, "
        f"{cfg.tokens_per_image} tokens an image ({cfg.ps3_tokens_low} in pass 1), mode "
        f"{cfg.ps3_look_close_mode} {'OK' if want_cfg else 'FAIL'}")

    # the prompt's layout
    t0 = time.perf_counter()
    inputs = engine.prepare_inputs(prompt(0))
    views_ms = (time.perf_counter() - t0) * 1e3
    entry, low = inputs["media"][0], inputs["ps3_low"]
    n_prompt, m1 = int(inputs["input_ids"].shape[0]), int(low["input_ids"].shape[0])
    s_pad = _bucket(n_prompt, PROMPT_BUCKETS)
    scales = vis.s3_scales
    layout = (entry["kind"] == "ps3" and entry["tiles"].shape == (1, scales[0], scales[0], 3)
              and [h.shape for h in entry["tiles_high"]] == [(1, s, s, 3) for s in scales[1:]]
              and len(inputs["media_pos"]) == cfg.tokens_per_image
              and len(low["media_pos"]) == cfg.ps3_tokens_low
              and n_prompt - m1 == cfg.tokens_per_image - cfg.ps3_tokens_low)
    ok &= layout
    out.update(prompt_tokens=n_prompt, pass1_tokens=m1, bucket=s_pad, views_ms=views_ms)
    sides = [entry["tiles"].shape[1]] + [h.shape[1] for h in entry["tiles_high"]]
    log(f"[ps3] prepare_inputs in {views_ms:.1f} ms: views {sides}, prompt {n_prompt} tokens "
        f"-> bucket {s_pad}, pass-1 prompt {m1} tokens (unpadded) {'OK' if layout else 'FAIL'}")

    # serve, with exact launches: the top-down requests, then one in one pass
    good, reqs, launches = phase_e2e(torch, engine, seed, n_requests, new_tokens, tag="ps3",
                                     prompt=prompt, prefill_passes=2)
    ok &= good
    out["requests"] = reqs
    one, want_one = ps3_engine(torch, e2e, seed, tower, "after_image", dev, engine.params)
    ok &= want_one
    good, out["one_pass"], one_launches = phase_e2e(
        torch, one, seed, 1, one_pass_tokens, tag="ps3 one-pass", prompt=prompt)
    ok &= good and "ps3_low" not in one.prepare_inputs(prompt(0))

    # the TTFT's device parts, each as its own calls
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ids1 = host_to_device(np.asarray(low["input_ids"], np.int64)[None], engine.device)
    mp1 = host_to_device(np.asarray(low["media_pos"], np.int64), engine.device)
    pass1_encode = lambda: engine.encode_media(inputs["media"], ps3_num_look_close=0)  # noqa
    low_emb = pass1_encode()
    pass1_llm = lambda: engine._prompt_hidden(ids1, low_emb, mp1)  # noqa: E731
    top_down = pass1_llm()
    pass2_encode = lambda: engine.encode_media(inputs["media"], ps3_prompt=top_down)  # noqa
    emb = pass2_encode()
    ids, valid, mpos = padded_prompt(inputs, s_pad, engine.device)
    cache_len = min(engine.max_cache_len, _round_up(s_pad + new_tokens, 256))

    def prefill():
        cache = qwen2.init_cache(cfg.llm, 1, cache_len, device=engine.device)
        return engine._prefill(ids, valid, emb, mpos, cache, n_prompt)

    logits, _ = prefill()
    first = lambda: sample_token(logits, None, False, 1.0, 1.0, 0)  # noqa: E731
    parts = {name: time_ms(torch, fn, 3) for name, fn in (
        ("pass1_encode", pass1_encode), ("pass1_llm", pass1_llm),
        ("pass2_encode", pass2_encode), ("prefill", prefill), ("first_token", first))}
    feats_ok = (tuple(emb.shape) == (cfg.tokens_per_image, cfg.llm.hidden_size)
                and tuple(top_down.shape) == (1, cfg.llm.hidden_size)
                and bool(torch.isfinite(emb.float()).all())
                and bool(torch.isfinite(top_down.float()).all()))
    ok &= feats_ok
    out["ttft_parts_ms"] = dict(views=views_ms, **parts)
    log(f"[ps3] TTFT parts of request 0 (CUDA events, median of 3; views on the host "
        f"clock): views {views_ms:.1f} ms, pass-1 encode {parts['pass1_encode']:.2f}, pass-1 "
        f"LLM forward over {m1} rows {parts['pass1_llm']:.2f}, pass-2 encode "
        f"{parts['pass2_encode']:.2f}, prefill over {s_pad} rows {parts['prefill']:.2f}, "
        f"first token {parts['first_token']:.3f}; served TTFT {reqs[0]['ttft_ms']:.1f} ms; "
        f"embeddings {tuple(emb.shape)} finite {'OK' if feats_ok else 'FAIL'}")
    del low_emb, emb, logits

    # K2 at the pass-1 M (no bucket), on the served LLM's layer 0
    gen = torch.Generator(device=dev).manual_seed(seed + 52)
    lay, k2_rows = e2e.params["llm"]["layers"], []
    for name in ("qkv", "o", "gate_up", "down"):
        key = name + "_proj"
        good, row = _k2_row(torch, quant, gen, lay[key]["packed"], lay[key]["scales"], 0, m1,
                            name, "ps3 pass 1", flush, "ps3")
        ok &= good
        k2_rows.append(row)
    del flush

    # request 0's teacher-forced path, kernels and plain versions, call by call
    g = served_against_plain(torch, engine, inputs, reqs[0]["ids"])
    sk = g["selection"]
    order_ok = len(sk.own) == len(scales) - 1 and all(
        torch.equal(ps3.top_k_indices(sc.cpu(), vis.k_per_scale), ix.cpu())
        for sc, ix in zip(sk.scores, sk.own))
    tie_ok = g["tie_held"] == len(reqs[0]["ids"])
    ok &= g["ok"] and order_ok and tie_ok
    out.update(greedy_ok=g["ok"], checks=g["checks"], order_equal_cpu=order_ok,
               selection_overlap=g["selection_overlap"],
               **{k: g[k] for k in ("exact", "tie_held", "band", "margins", "local_margins",
                                    "max_dlogit", "max_logit", "local_max", "layer_gap",
                                    "layer_local", "k2_calls")})
    log(f"[ps3] request 0's {len(reqs[0]['ids'])} greedy tokens, the serving path (pass 1 "
        f"included: {g['k2_calls']} K2 calls) fed them through the kernels and through the "
        f"plain versions on the card ({g['seconds']:.1f} s): checks {g['checks']}; every "
        f"call against its plain version on its own inputs, largest |d| / max|ref| "
        + ", ".join(f"{k} {v:.2e}" for k, v in g["local_max"].items())
        + f"; top-k order on the card equal to the CPU's on the same scores "
        f"{'OK' if order_ok else 'FAIL'}; the plain pass's own selection overlaps the "
        f"kernel pass's by {[round(v, 4) for v in g['selection_overlap']]} (reported)")
    log(f"[ps3] request 0, end to end: argmax equal on {g['exact']}/{len(reqs[0]['ids'])} "
        f"(reported); served tokens within K1's band ({g['band']:.4f}) of the plain pass's top "
        f"on {g['tie_held']}/{len(reqs[0]['ids'])} {'OK' if tie_ok else 'FAIL'}, largest margin "
        f"{max(g['margins']):.4f}; max |dlogit| {g['max_dlogit']:.4f} of max|logit| "
        f"{g['max_logit']:.3f}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del engine, one, g, sk
    gc.collect()
    torch.cuda.empty_cache()
    return ok, out, {"ps3": launches, "ps3 one-pass": one_launches}, k2_rows


# The generic ViT towers at their published widths, as the vision tower's
# config.json (the form `entry.build_config` reads): CLIP ViT-L/14-336
# (openai/clip-vit-large-patch14-336), InternViT-6B-448px-V1-5 (VILA1.5-40B's
# tower: OpenGVLab's config.json), RADIO at timm's vit_huge_patch16 widths and
# its preferred 432² (radio_encoder.py)
VIT_TOWERS = {
    "clip": dict(model_type="clip_vision_model", hidden_size=1024, intermediate_size=4096,
                 num_hidden_layers=24, num_attention_heads=16, image_size=336, patch_size=14,
                 hidden_act="quick_gelu", layer_norm_eps=1e-5),
    "internvit": dict(model_type="intern_vit_6b", hidden_size=3200, intermediate_size=12800,
                      num_hidden_layers=45, num_attention_heads=25, image_size=448,
                      patch_size=14, hidden_act="gelu", qk_normalization=True,
                      layer_norm_eps=1e-6),
    "radio": dict(model_type="radio", args={"model": "vit_huge_patch16_224"},
                  preferred_resolution=[432, 432]),
}
# (tokens through the tower, LLM tokens an image after the 2x2 downsample)
VIT_TOKENS = {"clip": (577, 144), "internvit": (1025, 256), "radio": (730, 196)}
W8A8_COS = 0.995  # the W8A8 tower's features against bf16, per token (tests/test_quant.py:310-330)
TOWER_TOKENS_NEW = 16


def phase_towers(torch, e2e, seed, dev="cuda", towers=VIT_TOWERS, tokens=VIT_TOKENS):
    """Each generic ViT tower at full width through the entry points:
    `config_from_files` (the tower's config.json, an mlp_downsample
    projector over its width, select "patch" at layer -2), seeded bf16
    weights (drawn one layer at a time), `quantize_vit_w8a8`; one image
    through `encode_images` in bf16 and W8A8 (CUDA events), the W8A8
    features against bf16 (cosine per token at JAX's bar, and max |d| /
    max|ref|); then one 16-token request through the W8A8 tower and the e2e
    engine's W4 LLM with exact K1-K3 launches. Each tower is freed before
    the next."""
    import numpy as np

    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import projector, vit, vlm

    out, ok, launches = {}, True, {}
    rng = np.random.default_rng(seed + 61)
    images = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(2)]
    for i, (name, tower) in enumerate(towers.items()):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        cfg = config_from_files(e2e.cfg, {"mm_vision_select_feature": "patch",
                                          "mm_vision_select_layer": -2},
                                vision_tower=tower, dev=dev)
        vis = cfg.vision
        n_tok, n_llm = tokens[name]
        want_cfg = (cfg.vision_tower_type == name and vis.num_positions == n_tok
                    and cfg.tokens_per_image == n_llm
                    and cfg.projector.mm_hidden_size == vis.hidden_size)
        t0 = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed + 60 + i)
        vp = vit.init_params(gen, vis, torch.bfloat16)
        proj = projector.init_params(gen, cfg.projector, torch.bfloat16)
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        tree_gib = (torch.cuda.memory_allocated() - base_mem) / 2**30
        t0 = time.perf_counter()
        vt8 = vit.quantize_vit_w8a8(vp)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        engine = GenerationEngine({"llm": e2e.params["llm"], "vision_tower": vt8,
                                   "mm_projector": proj}, cfg, e2e.tokenizer, device=dev)
        inputs = engine.prepare_inputs([images[0], QUESTIONS[0]])
        tiles = torch.as_tensor(inputs["media"][0]["tiles"], device=dev)
        want_cfg &= len(inputs["media_pos"]) == n_llm
        ok &= want_cfg

        def encode(tree):
            return vlm.encode_images({"vision_tower": tree, "mm_projector": proj}, cfg, tiles)

        def feats(tree):
            return vit.forward(tree, vis, tiles, feature_layer=cfg.vision_feature_layer,
                               select=cfg.vision_select).float()

        bf16_ms = time_ms(torch, lambda: encode(vp), 5)
        w8_ms = time_ms(torch, lambda: encode(vt8), 5)
        ref, got = feats(vp), feats(vt8)
        cos = float(((got * ref).sum(-1) / (got.norm(dim=-1) * ref.norm(dim=-1) + 1e-9)).min())
        err, scale = rel_err(torch, got, ref)
        emb = encode(vt8)
        feats_ok = (tuple(got.shape) == (1, n_tok - 1, vis.hidden_size)
                    and tuple(emb.shape) == (1, n_llm, cfg.llm.hidden_size)
                    and bool(torch.isfinite(got).all()) and bool(torch.isfinite(emb.float()).all())
                    and cos > W8A8_COS)
        ok &= feats_ok
        del ref, got, emb
        good, reqs, launches[f"towers {name}"] = phase_e2e(
            torch, engine, seed, 1, TOWER_TOKENS_NEW, tag=f"towers {name}",
            prompt=lambda j: [images[j], QUESTIONS[j]])
        ok &= good
        peak = (torch.cuda.max_memory_allocated() - base_mem) / 2**30
        out[name] = dict(hidden=vis.hidden_size, layers=vis.num_hidden_layers,
                         heads=vis.num_attention_heads, tokens=n_tok, llm_tokens=n_llm,
                         synth_s=synth_s, quantize_s=quant_s, tree_gib=tree_gib,
                         encode_bf16_ms=bf16_ms, encode_w8a8_ms=w8_ms, w8a8_cos_min=cos,
                         w8a8_max_abs_err=err, w8a8_max_abs=scale, peak_above_gib=peak,
                         request=reqs[0] if reqs else None, ok=bool(want_cfg and feats_ok))
        log(f"[towers] {name}: {vis.hidden_size} wide, {vis.num_hidden_layers} layers, "
            f"{vis.num_attention_heads} heads of {vis.head_dim}, {n_tok} tokens -> {n_llm} LLM "
            f"tokens {'OK' if want_cfg else 'FAIL'}; seeded bf16 tree {tree_gib:.2f} GiB in "
            f"{synth_s:.1f} s, quantize_vit_w8a8 {quant_s:.1f} s; encode_images of one image "
            f"(CUDA events, median of 5): bf16 {bf16_ms:.2f} ms, W8A8 {w8_ms:.2f} ms; W8A8 "
            f"features against bf16: cosine min {cos:.5f} (bar {W8A8_COS}), max |d| {err:.3e} "
            f"of max |ref| {scale:.3e} {'OK' if feats_ok else 'FAIL'}; peak {peak:.2f} GiB "
            f"above the {base_mem / 2**30:.2f} GiB before")
        del engine, vp, vt8, proj, tiles
        gc.collect()
        torch.cuda.empty_cache()
    return ok, out, launches


def phase_w8(torch, seed, dev="cuda", rows=(1, 24, 320)):
    """The W8A16 flat slot (`quant.quantize_w8`, the W8 branch of
    `quantized_linear`: dequantize, then `torch.matmul`) at NVILA-8B's
    down_proj (18944 -> 3584, groups of 128): the card's int8 bytes and
    bf16 scales equal to the CPU's (the division by 127 is IEEE on both),
    `dequantize` bit for bit, and `quantized_linear` over the slot against
    the CPU at M = 1, 24 and 320, in f32 (within 1e-5 max|ref|: sums in
    another order) and in bf16 (within 2^-7 max|ref|, one bf16 ulp of the
    largest output). On a generator of its own."""
    from vila_tpu_torch.ops import quant

    D, I = DIMS_8B[0], DIMS_8B[1]
    gen = torch.Generator(device=dev).manual_seed(seed + 31)
    w = (0.02 * torch.randn((I, D), generator=gen, device=dev)).to(torch.bfloat16)
    t0 = time.perf_counter()
    q = quant.quantize_w8(w)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    q_cpu = quant.quantize_w8(w.cpu())
    same = (torch.equal(q["packed"].cpu(), q_cpu["packed"])
            and torch.equal(q["scales"].cpu().view(torch.int16), q_cpu["scales"].view(torch.int16)))
    deq = torch.equal(quant.dequantize(q).cpu().view(torch.int16),
                      quant.dequantize(q_cpu).view(torch.int16))
    ok = same and deq
    out = dict(shape=[I, D], quantize_s=secs, bytes_equal=same, dequantize_bit_exact=deq,
               linear=[])
    log(f"[w8] quantize_w8 of the down_proj ({I} x {D}) on the card in {secs * 1e3:.1f} ms: "
        f"int8 bytes and bf16 scales equal to the CPU's {same}, dequantize bit for bit {deq}")
    slot = {"packed": q["packed"], "scales": q["scales"]}
    slot_cpu = {"packed": q_cpu["packed"], "scales": q_cpu["scales"]}
    for m in rows:
        x = torch.randn((m, I), generator=gen, device=dev).to(torch.bfloat16)
        for dtype, rel in ((torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)):
            got = quant.quantized_linear(x, slot, dtype)
            want = quant.quantized_linear(x.cpu(), slot_cpu, dtype)
            err, scale = rel_err(torch, got.cpu(), want)
            good = got.dtype == dtype and bool(torch.isfinite(got.float()).all()) \
                and err <= rel * scale
            ok &= good
            t = time_ms(torch, lambda: quant.quantized_linear(x, slot, dtype), 10)
            out["linear"].append(dict(m=m, dtype=str(dtype), max_abs_err=err, tol=rel * scale,
                                      ok=good, ms=t))
            log(f"[w8] quantized_linear M={m:<4d} {str(dtype):14s} card vs CPU err {err:.3e} "
                f"(tol {rel * scale:.3e}) {'OK' if good else 'FAIL'}  {t:.3f} ms on the card")
    return ok, out


AWQ_CALIB = (32, 48)  # calibration sequences x tokens (scripts/quant_acc.py:92-96)
AWQ_PAIRS = ("qkv", "o", "gate_up", "down")
AWQ_KERNELS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
CPU_WORKER_THREADS = 4  # the worker's intra-op threads; the card's process keeps the rest
CPU_JOB_TIMEOUT_S = 600


def _cpu_worker_init():
    import torch

    # the lowest priority: the worker takes the cores the run leaves idle,
    # and never slows the host-bound phases beside it (quant_acc, eval)
    os.nice(19)
    torch.set_num_threads(CPU_WORKER_THREADS)


class CpuWorker:
    """One spawned CPU process, started at the top of the run, for a CPU
    reference the card should not wait for: the `awq` phase's layer-0
    searches (`awq.search_awq_scales` sets its process's f32 matmul
    precision, so a thread will not do). It holds no CUDA state. A job that
    raises, or a worker that dies, raises in `Future.result` and fails the
    run; nothing is caught and skipped."""

    def __init__(self):
        import concurrent.futures
        import multiprocessing

        self.pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_worker_init)
        self.pool.submit(_cpu_worker_init)  # start it (its imports) now
        atexit.register(self.close)

    def submit(self, fn, *args):
        return self.pool.submit(fn, *args)

    def close(self):
        procs = list((getattr(self.pool, "_processes", None) or {}).values())
        self.pool.shutdown(wait=False, cancel_futures=True)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5)


def awq_cpu_searches(path):
    """The first layers' AWQ searches on the CPU from the card's kernels and
    calibration rows. `path` holds the `torch.save` of {"lcfg", "layers":
    [(kernels, stats)]}; it is removed once read. Returns (per layer
    {pair: (index of the best, every loss)}, seconds)."""
    import torch

    from vila_tpu_torch.ops import awq

    try:
        job = torch.load(path, weights_only=False)
    finally:
        os.remove(path)
    t0 = time.perf_counter()
    rows = []
    for one, stats in job["layers"]:
        sc = awq.layer_scales(one, job["lcfg"], stats, 0)
        rows.append({p: (int(sc[p][2]), sc[p][3].cpu()) for p in AWQ_PAIRS})
    return rows, time.perf_counter() - t0


def _fold_check(torch, src, folded, stats, sc, cfg, l):
    """Layer l's four folds against the unfolded layer on its calibration
    rows: max |(x / s) @ (W s) c - x @ W| / max|x @ W| per pair, W the
    stored bf16 kernels, W s the stored bf16 folded ones, c the factor a
    later pair divided the columns by (v by the o pair's, up by the down
    pair's), all in f32."""
    grp = cfg.num_attention_heads // cfg.num_key_value_heads
    Hkv, hd = cfg.num_key_value_heads, cfg.head_dim_
    s_g = torch.exp(torch.log(torch.clamp(sc["o"][0].reshape(Hkv, grp, hd), min=1e-8))
                    .mean(dim=1))
    s_o = s_g.repeat_interleave(grp, dim=0).reshape(-1)

    def cat(tree, names):
        return torch.cat([tree[n]["kernel"][l].float() for n in names], dim=-1)

    qkv_n, gu_n = ("q_proj", "k_proj", "v_proj"), ("gate_proj", "up_proj")
    nqk = (cfg.num_attention_heads + Hkv) * hd
    ones = lambda n: torch.ones(n, device=s_g.device)  # noqa: E731
    checks = {
        "qkv": (stats["qkv"][l], sc["qkv"][0], cat(src, qkv_n), cat(folded, qkv_n),
                torch.cat([ones(nqk), s_g.reshape(-1)])),
        "o": (stats["o"][l], s_o, cat(src, ("o_proj",)), cat(folded, ("o_proj",)), None),
        "gate_up": (stats["gate_up"][l], sc["gate_up"][0], cat(src, gu_n), cat(folded, gu_n),
                    torch.cat([ones(cfg.intermediate_size), sc["down"][0]])),
        "down": (stats["down"][l], sc["down"][0], cat(src, ("down_proj",)),
                 cat(folded, ("down_proj",)), None),
    }
    out = {}
    for pair, (x, s, w, ws, c) in checks.items():
        ref = x @ w
        got = (x / s[None, :]) @ ws
        if c is not None:
            got = got * c[None, :]
        out[pair] = float((got - ref).abs().max() / ref.abs().max())
    return out


def phase_awq(torch, seed, worker, defer, dev="cuda", layers=28, check_layers=1,
              n_requests=1, new_tokens=32, fold_tol=2.0 ** -7, cfg=None):
    """AWQ at NVILA-8B width on the card (`ops/awq.py`): a seeded bf16 LLM of
    `layers` layers (with the e2e tower and projector, bf16), 32 x 48 seeded
    calibration ids through `collect_act_stats`, `apply_awq` (20-point grid,
    128 rows) and `quantize_llm_params`, each timed, with the peak memory
    above what was allocated before; every layer's four folds held against
    the unfolded layer on its calibration rows within `fold_tol` x max|ref|
    (the folded kernels are stored in bf16: each product's terms carry a
    relative rounding of at most 2^-9, summed with random signs); the
    first `check_layers` layers' searches run again on the CPU from the
    card's calibration rows, each chosen grid index equal to the card's or
    a tie on the CPU's losses (within 1e-5 relative): in `worker` (a
    `CpuWorker`), judged when the run reads it (`defer(name, check)`: at
    its end); then `n_requests`
    image + question requests x `new_tokens` greedy tokens on the AWQ W4
    engine through K1-K3 (exact launches), each against the same engine's
    serving path through the plain versions on the card
    (`served_against_plain`)."""
    from vila_tpu_torch.inference.generate import GenerationConfig, GenerationEngine
    from vila_tpu_torch.ops import _build, awq, quant

    cfg = cfg or nvila_8b_config(layers)
    lcfg = cfg.llm
    layers = lcfg.num_hidden_layers
    ok, out = True, {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = synth_bf16_params(torch, cfg, seed + 40, dev)
    torch.cuda.synchronize()
    log(f"[awq] seeded bf16 NVILA-8B, {layers} LLM layers, in {time.perf_counter() - t0:.1f} s "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card)")
    gen = torch.Generator(device=dev).manual_seed(seed + 41)
    calib = torch.randint(0, lcfg.vocab_size, AWQ_CALIB, generator=gen, device=dev)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = {}
    t0 = time.perf_counter()
    stats = awq.collect_act_stats(params["llm"], lcfg, calib,
                                  generator=torch.Generator().manual_seed(seed + 42))
    torch.cuda.synchronize()
    times["collect_act_stats_s"] = time.perf_counter() - t0
    searches = []
    t0 = time.perf_counter()
    folded = awq.apply_awq(params["llm"], lcfg, stats, searches=searches)
    torch.cuda.synchronize()
    times["apply_awq_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    w4 = quant.quantize_llm_params(folded, bits=4, cfg=lcfg)
    torch.cuda.synchronize()
    times["quantize_s"] = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    idx, loss = awq.search_summary(searches)
    out.update(times, peak_above_tree_gib=peak, tree_gib=base / 2**30, grid_index=idx)
    log(f"[awq] collect_act_stats {times['collect_act_stats_s']:.1f} s, apply_awq (4 x "
        f"{layers} searches of 20 points, folds) {times['apply_awq_s']:.1f} s, "
        f"quantize_llm_params {times['quantize_s']:.1f} s; peak {peak:.2f} GiB above the "
        f"{base / 2**30:.2f} GiB allocated before; chosen grid indices (qkv, o, gate_up, down) "
        f"of layers 0-3: {idx[:4]}")

    # every fold, on the card
    worst = {p: 0.0 for p in AWQ_PAIRS}
    for l in range(layers):
        for p, e in _fold_check(torch, params["llm"]["layers"], folded["layers"], stats,
                                searches[l], lcfg, l).items():
            worst[p] = max(worst[p], e)
    fold_ok = all(e <= fold_tol for e in worst.values())
    ok &= fold_ok
    out["fold_max_rel_err"] = worst
    log(f"[awq] folds of all {layers} layers, (x / s) @ (W s) against x @ W on the "
        f"calibration rows: max |d| / max|ref| per pair {worst} (tolerance {fold_tol:.4g}) "
        f"{'OK' if fold_ok else 'FAIL'}")

    # the first layers' searches again on the CPU, from the card's rows
    cpu = torch.device("cpu")
    src = params["llm"]["layers"]
    job = dict(lcfg=lcfg, layers=[
        ({n: {"kernel": src[n]["kernel"][l:l + 1].to(cpu)} for n in AWQ_KERNELS},
         {p: stats[p][l:l + 1].to(cpu) for p in AWQ_PAIRS}) for l in range(check_layers)])
    card_side = [{p: (int(searches[l][p][2]), searches[l][p][3].cpu()) for p in AWQ_PAIRS}
                 for l in range(check_layers)]

    def judge(result):
        rows, secs = result
        agree = []
        for l, (got, want) in enumerate(zip(rows, card_side)):
            for p in AWQ_PAIRS:
                (i_cpu, losses_cpu), (i_card, losses_card) = got[p], want[p]
                tie = abs(float(losses_cpu[i_card] - losses_cpu[i_cpu])) <= 1e-5 * float(
                    losses_cpu[i_cpu])
                rel = float(((losses_card - losses_cpu).abs() / losses_cpu.abs()).max())
                agree.append(dict(layer=l, pair=p, card=i_card, cpu=i_cpu,
                                  ok=i_card == i_cpu or tie, losses_max_rel_diff=rel))
        grid_ok = len(agree) == len(AWQ_PAIRS) * check_layers and all(a["ok"] for a in agree)
        out.update(grid_vs_cpu=agree, grid_cpu_s=secs)
        log(f"[awq] layers 0-{check_layers - 1}'s searches on the CPU ({secs:.1f} s in the "
            f"CPU worker): chosen indices card/CPU "
            + ", ".join(f"{a['layer']}.{a['pair']} {a['card']}/{a['cpu']}" for a in agree)
            + f"; largest relative difference of a loss "
            f"{max(a['losses_max_rel_diff'] for a in agree):.2e} {'OK' if grid_ok else 'FAIL'}")
        return grid_ok

    os.makedirs("runs", exist_ok=True)
    path = os.path.join("runs", f"awq_cpu_job_{os.getpid()}.pt")
    torch.save(job, path)
    del job
    future = worker.submit(awq_cpu_searches, path)
    defer("awq cpu searches", lambda: judge(future.result(timeout=CPU_JOB_TIMEOUT_S)))
    del stats, folded, searches
    params["llm"] = None
    gc.collect()
    torch.cuda.empty_cache()

    # the AWQ W4 engine serves, through K1-K3
    engine = GenerationEngine({**params, "llm": w4}, cfg, ByteTokenizer(), device=dev)
    gcfg = GenerationConfig(max_new_tokens=new_tokens, stop_token_ids=(-1,))
    images = _images(seed + 43, n_requests)
    _build.reset_launches()
    reqs = []
    for i in range(n_requests):
        inputs = engine.prepare_inputs([images[i], QUESTIONS[i % len(QUESTIONS)]])
        t0 = time.perf_counter()
        ids = engine.generate_ids(inputs, gcfg)
        reqs.append((inputs, ids, time.perf_counter() - t0))
    launches = dict(_build.LAUNCHES)
    steps = n_requests * (new_tokens - 1)
    want = dict(_no_launches(), w4_gemv=n_requests + 2 * steps,
                w4_gemm=4 * layers * n_requests, fused_layer=layers * steps)
    launch_ok = launches == want and all(len(r[1]) == new_tokens for r in reqs)
    ok &= launch_ok
    log(f"[awq] {n_requests} requests x {new_tokens} tokens on the AWQ W4 engine in "
        + ", ".join(f"{r[2]:.2f} s" for r in reqs) + f"; launches {launches}, expected {want} "
        f"{'OK' if launch_ok else 'FAIL'}")
    out["requests"] = []
    for i, (inputs, ids, secs) in enumerate(reqs):
        g = served_against_plain(torch, engine, inputs, ids)
        ok &= g["ok"]
        out["requests"].append(dict(
            ids=ids, seconds=secs, greedy_ok=g["ok"], checks=g["checks"],
            **{k: g[k] for k in ("exact", "tie_held", "band", "margins", "local_margins",
                                 "max_dlogit", "max_logit", "local_max", "layer_gap",
                                 "layer_local")}))
        log(f"[awq] request {i}'s {len(ids)} greedy tokens, the serving path fed them through "
            f"the kernels and through the plain versions on the card ({g['seconds']:.1f} s): "
            f"checks {g['checks']}; every call against its plain version on its own inputs, "
            f"largest |d| / max|ref| " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                  g["local_max"].items())
            + f"; largest top-minus-served margin of the plain lm_head over the kernel pass's "
            f"hidden state {max(g['local_margins']):.4f} (K1's band 2^-7 max|logit|); "
            f"max |dlogit| between the passes {g['max_dlogit']:.4f} of max|logit| "
            f"{g['max_logit']:.3f} (tolerance {g['tol']:.4f}) {'OK' if g['ok'] else 'FAIL'}")
        log(f"[awq] request {i}, end to end (reported): argmax equal on {g['exact']}/{len(ids)}"
            f"; served tokens within K1's band ({g['band']:.4f}) of the plain pass's top on "
            f"{g['tie_held']}/{len(ids)}, largest margin {max(g['margins']):.4f}; hidden-state "
            f"gap max|h_kernel - h_plain| / max|h_plain| after each layer "
            f"{[round(v, 5) for v in g['layer_gap']]}; each K3 call against its plain version "
            f"on the same inputs {[round(v, 5) for v in g['layer_local']]}")
    del engine, params, w4
    gc.collect()
    torch.cuda.empty_cache()
    return ok, out, launches


QUANT_ACC_JAX = "QUANT_ACC_r05.json"  # the JAX package's numbers (f32, on the CPU)
QUANT_ACC_BAND = 0.03  # 6 of 200 answers: JAX ran f32 on the CPU, the card runs bf16
# questions the plain-version checks take (of 200, cut for the run's time
# limit: all 200 took ≈ 100 s of the card's run)
QUANT_ACC_PLAIN = 40


def phase_quant_acc(torch, dev="cuda", limit=None):
    """The committed quant probe (`vila_tpu/eval/fixtures/quant_probe`, D 256,
    I 512, 4/2 heads of 64, vocab 512, untied W4 lm_head) loaded with
    `entry.load` on the card, with the port's own tokenizer reader (no
    `transformers` may be imported); `eval.quant_acc.measure` over all 200
    pope-mini questions (bf16, W4-RTN, W4-AWQ: accuracy, first-token
    agreement and mean |logit diff| against bf16, the deltas) beside
    `QUANT_ACC_r05.json`, each accuracy within 0.03 of the JAX package's.
    Then, on the first `QUANT_ACC_PLAIN` questions, against the plain
    versions (K1-K3's, no launch): the W4-AWQ engine's predictions again
    under `plain_versions`, which must be equal; the W4-RTN engine through
    the port's task modules (`eval_in_process`: `vqa.run_eval` and
    `smoke.run`, exact launches, predictions equal under `plain_versions`);
    and both W4 engines' logits over those prompts (`_quant_acc_logits`).
    Returns (ok, summary, {path: launches})."""
    from vila_tpu_torch import entry
    from vila_tpu_torch.eval import benchmarks, quant_acc
    from vila_tpu_torch.ops import _build

    ok = True
    t0 = time.perf_counter()
    engine = entry.load(quant_acc.PROBE, device=dev)
    load_s = time.perf_counter() - t0
    no_tf = not any(m.split(".")[0] in ("transformers", "tokenizers") for m in sys.modules)
    ok &= no_tf
    lcfg = engine.cfg.llm
    log(f"[quant_acc] entry.load of the probe in {load_s:.2f} s: D {lcfg.hidden_size}, I "
        f"{lcfg.intermediate_size}, {lcfg.num_hidden_layers} layers, "
        f"{lcfg.num_attention_heads}/{lcfg.num_key_value_heads} heads of {lcfg.head_dim_}, "
        f"vocab {lcfg.vocab_size}; tokenizer {type(engine.tokenizer).__name__}, transformers "
        f"not imported {no_tf}")
    _build.reset_launches()
    timings = {}
    t0 = time.perf_counter()
    out, preds, engines = quant_acc.measure(engine, limit, timings=timings)
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    ran = all(launches[k] > 0 for k in E2E_KERNELS)
    ok &= ran
    log(f"[quant_acc] measure over {out['n_examples']} questions in {secs:.1f} s (RTN "
        f"{timings['w4_rtn']:.2f} s, AWQ {timings['w4_awq']:.2f} s); launches {launches} "
        f"{'OK' if ran else 'FAIL'}")
    ds_path = benchmarks.resolve_dataset(quant_acc.DATASET)
    media_root = os.path.dirname(ds_path)
    dataset = benchmarks.load_dataset(ds_path)[:limit][:QUANT_ACC_PLAIN]
    t0 = time.perf_counter()
    with plain_versions():
        _, plain = quant_acc.accuracy(engines, dataset, media_root, names=("w4_awq",))
    plain_s = time.perf_counter() - t0
    differ = {n: sum(a != b for a, b in zip(preds[n], plain[n])) for n in plain}
    ok &= not any(differ.values())
    log(f"[quant_acc] the W4-AWQ engine's predictions on {len(dataset)} questions under the "
        f"plain versions ({plain_s:.1f} s): answers that differ {differ} "
        f"{'OK' if not any(differ.values()) else 'FAIL'}")
    good, inproc, inproc_launches = eval_in_process(torch, engines["w4_rtn"], ds_path,
                                                    len(dataset))
    ok &= good
    good, logits = _quant_acc_logits(torch, engines, quant_acc.prompts(
        engine, dataset, media_root))
    ok &= good
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), QUANT_ACC_JAX)) as f:
        jax_out = json.load(f)
    acc = "pope/accuracy"
    rows = {}
    for name in quant_acc.ENGINES:
        got, want = out[name][acc], jax_out[name][acc]
        good = abs(got - want) <= QUANT_ACC_BAND + 1e-9
        ok &= good
        rows[name] = dict(card=out[name], jax=jax_out[name], answers_apart=round(
            abs(got - want) * out["n_examples"]), ok=good)
        extra = ""
        if name != "bf16":
            extra = (f"; agreement {out[name]['first_token_top1_agreement']} (JAX "
                     f"{jax_out[name]['first_token_top1_agreement']}), mean |logit diff| "
                     f"{out[name]['mean_abs_logit_diff']} (JAX "
                     f"{jax_out[name]['mean_abs_logit_diff']})")
        log(f"[quant_acc] {name:6s} accuracy {got:.4f} on the card, {want:.4f} in "
            f"{QUANT_ACC_JAX} ({rows[name]['answers_apart']} answers apart; band "
            f"{QUANT_ACC_BAND}) F1 {out[name]['pope/f1']:.4f} (JAX {jax_out[name]['pope/f1']:.4f})"
            f"{extra} {'OK' if good else 'FAIL'}")
    log(f"[quant_acc] deltas bf16 - RTN {out['acc_delta_rtn']} (JAX {jax_out['acc_delta_rtn']}), "
        f"bf16 - AWQ {out['acc_delta_awq']} (JAX {jax_out['acc_delta_awq']})")
    del engines, engine
    gc.collect()
    torch.cuda.empty_cache()
    return ok, dict(result=out, by_engine=rows, predictions_differ_from_plain=differ,
                    eval_modules=inproc, logits_against_plain=logits, seconds=secs,
                    plain_seconds=plain_s, load_s=load_s, quantize_s=timings), \
        dict(inproc_launches, quant_acc=launches)


def _quant_acc_logits(torch, engines, preps, steps=4):
    """The two W4 engines' logits over every prepared prompt, through the
    kernels and under `plain_versions`: the serving path greedy for
    `steps` tokens (pope's max_new_tokens) through the kernels, then fed
    the same tokens through the plain versions; every step of every prompt
    must agree within 2^-7 x that step's max|logit| (K1's bar, and the one
    the CPU tests hold the port's first-token logits to against JAX). Row 0
    is the prompt's first-token logits (the prefill: K2, K1); the later
    rows are decode steps (K3, K1)."""
    ok, out = True, {}
    t0 = time.perf_counter()
    for name in ("w4_rtn", "w4_awq"):
        worst = [0.0, 0.0]  # largest |d| / (2^-7 max|logit|): first token, decode steps
        bad = 0
        for p in preps:
            got, ids = _forced_logits(torch, engines[name], p, steps=steps)
            with plain_versions():
                want, _ = _forced_logits(torch, engines[name], p, ids)
            r = ((got - want).abs().amax(-1) / (2.0 ** -7 * want.abs().amax(-1))).tolist()
            worst = [max(worst[0], r[0]), max([worst[1]] + r[1:])]
            bad += int(max(r) > 1.0)
        out[name] = dict(prompts=len(preps), prompts_outside=bad, first_token_worst=worst[0],
                         decode_worst=worst[1])
        ok &= bad == 0
    secs = time.perf_counter() - t0
    log(f"[quant_acc] the W4 engines' logits over {len(preps)} prompts, {steps} greedy "
        f"steps through the kernels, then the same tokens through the plain versions "
        f"({secs:.1f} s): largest max|dlogit| in units of 2^-7 max|logit| (first token; "
        f"decode steps) " + ", ".join(f"{n} {o['first_token_worst']:.3f}; "
                                      f"{o['decode_worst']:.3f}" for n, o in out.items())
        + f"; prompts outside the bar {[o['prompts_outside'] for o in out.values()]} "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(out, seconds=secs)


# --------------------------------------------------------------------------
# Evaluation through the port's registry (`vila-torch-eval`) and its task
# modules
# --------------------------------------------------------------------------

EVAL_TIMEOUT_S = 600


class count_engine_work:
    """While active, the engine's prefills (`_start`) and decode steps
    (`_decode`'s `steps`) are counted: the serial path's K1-K3 launches
    follow from them (`engine_launches`)."""

    def __init__(self, engine):
        self.engine, self.prefills, self.steps = engine, 0, 0

    def __enter__(self):
        start, decode = self.engine._start, self.engine._decode

        def counted_start(*a, **kw):
            self.prefills += 1
            return start(*a, **kw)

        def counted_decode(tok, cache, pos, gen, steps, gc):
            self.steps += steps
            return decode(tok, cache, pos, gen, steps, gc)

        self.engine._start, self.engine._decode = counted_start, counted_decode
        return self

    def __exit__(self, *exc):
        del self.engine._start, self.engine._decode
        return False


def engine_launches(layers, prefills, steps):
    """K1-K3 launches of the serial W4 path: per prefill K2 on 4 projections
    a layer and K1 on the lm_head; per decode step K3 a layer and K1 on
    layer 0's qkv and the lm_head."""
    return dict(_no_launches(), w4_gemv=prefills + 2 * steps, w4_gemm=4 * layers * prefills,
                fused_layer=layers * steps)


def eval_in_process(torch, w4, ds_path, rows):
    """The port's task modules over a W4 engine of the quant probe, in this
    process: `vqa.run_eval` over pope-mini's first `rows` rows (media_root
    at the fixture) and `smoke.run` (text, image). Each call's K1-K3
    launches must equal what its prefills and decode steps give
    (`engine_launches`), and its predictions those of the same call under
    `plain_versions`. Returns (ok, {call: row}, {path: launches})."""
    from vila_tpu_torch.eval import smoke, vqa
    from vila_tpu_torch.ops import _build

    ok, out = True, {}
    layers = w4.cfg.llm.num_hidden_layers
    dataset = vqa.load_dataset(ds_path)[:rows]
    media_root = os.path.dirname(ds_path)
    for name, fn in (
            ("vqa", lambda: vqa.run_eval(w4, dataset, max_new_tokens=16,
                                         media_root=media_root)),
            ("smoke text", lambda: smoke.run(w4, "text")),
            ("smoke image", lambda: smoke.run(w4, "image"))):
        _build.reset_launches()
        t0 = time.perf_counter()
        with count_engine_work(w4) as work:
            got = fn()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        want = engine_launches(layers, work.prefills, work.steps)
        with plain_versions():
            plain = fn()
        if name == "vqa":
            preds = [r["prediction"] for r in got["results"]]
            plain_preds = [r["prediction"] for r in plain["results"]]
            metrics = got["metrics"]
        else:
            preds, plain_preds = got[2], plain[2]
            metrics = {"pass": got[0], "total": got[1]}
        differ = sum(a != b for a, b in zip(preds, plain_preds))
        good = (launches == want and all(launches[k] > 0 for k in E2E_KERNELS)
                and differ == 0 and len(preds) == len(plain_preds)
                and all(isinstance(p, str) for p in preds))
        ok &= good
        out[name] = dict(seconds=secs, prefills=work.prefills, decode_steps=work.steps,
                         launches=launches, expected=want, differ_from_plain=differ,
                         metrics=metrics, ok=good)
        log(f"[quant_acc] {name} on the W4-RTN engine: {len(preds)} prompts in {secs:.2f} s, "
            f"{work.prefills} prefills + {work.steps} decode steps; launches {launches} "
            f"(expected {want}); predictions that differ from the plain versions' {differ}; "
            f"{metrics} {'OK' if good else 'FAIL'}")
    return ok, out, {f"quant_acc {name}": r["launches"] for name, r in out.items()}


def _cli_fault(name, metrics):
    """What a registry task's resolved metrics fail, or None: a smoke task
    must pass every prompt, loss-regression give a finite loss."""
    if name.startswith("smoke-") and metrics.get("pass_rate") != 1.0:
        return f"pass_rate {metrics.get('pass_rate')}, not 1.0"
    if name == "loss-regression":
        v = metrics.get("loss")
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            return f"loss {v}, not finite"
    return None


def eval_cli(args, out_dir):
    """`python -m vila_tpu_torch.cli.eval ARGS -o out_dir`, started in the
    background (its tasks run as subprocesses on the card)."""
    log_path = os.path.join(out_dir, "cli_log.txt")
    os.makedirs(out_dir, exist_ok=True)
    f = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "vila_tpu_torch.cli.eval", *args,
                             "-o", out_dir], stdout=f, stderr=subprocess.STDOUT,
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            start_new_session=True)
    return proc, f


def kill_group(proc):
    """Kill a process started with `start_new_session` and all it started."""
    if proc.poll() is None:
        try:
            os.killpg(proc.pid, 9)
        except ProcessLookupError:
            pass
        proc.wait()


def eval_cli_results(proc, f, out_dir, model_name, specs, tag):
    """Wait for a CLI run and read its results.json: (ok, {task: row}).
    Each task must exit 0, every metric of its registry entry resolve
    through `json_path` against its metrics.json, and the values pass
    `_cli_fault`."""
    from vila_tpu_torch.cli.eval import json_path

    try:
        rc = proc.wait(timeout=EVAL_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = f"none: still running after {EVAL_TIMEOUT_S} s"
    finally:
        kill_group(proc)
        f.close()
    root = os.path.join(out_dir, model_name)
    path = os.path.join(root, "results.json")
    if rc != 0 or not os.path.exists(path):
        with open(f.name) as fh:
            log(f"[eval] {tag}: the CLI exited {rc}\n{fh.read()[-3000:]}")
        return False, {}
    with open(path) as fh:
        results = json.load(fh)
    ok, rows = set(results) == set(specs), {}
    for name, spec in specs.items():
        r = results.get(name, {"exit_code": None, "metrics": {}})
        fault = None if r["exit_code"] == 0 else f"exit {r['exit_code']}"
        if fault is None:
            with open(os.path.join(root, name, "metrics.json")) as fh:
                raw = json.load(fh)
            try:
                resolved = {m: json_path(raw, p) for m, p in spec["metrics"].items()}
            except (KeyError, TypeError):
                resolved = None
            if resolved != r["metrics"] or any(v is None for v in resolved.values()):
                fault = f"metrics {r['metrics']} against {resolved} through json_path"
            else:
                fault = _cli_fault(name, resolved)
        ok &= fault is None
        rows[name] = dict(r, ok=fault is None, fault=fault)
        if fault is not None:
            with open(os.path.join(root, name, "log.txt")) as fh:
                log(f"[eval] {tag}: {name} FAIL: {fault}\n{fh.read()[-3000:]}")
    log(f"[eval] {tag}: " + "; ".join(
        f"{n} exit {r['exit_code']} {r['metrics']}" for n, r in rows.items())
        + f" {'OK' if ok else 'FAIL'}")
    return ok, rows


def start_eval(dev="cuda"):
    """Start the `eval` phase's two `vila_tpu_torch.cli.eval` runs over the
    quant probe in the background: `--tags mini` (pope-mini, textvqa-mini)
    and `--tasks loss-regression smoke-text smoke-image`. Their task
    processes share the card with whatever runs here until `phase_eval`
    reads them (the default run starts them before `quant_acc`)."""
    import tempfile

    from vila_tpu_torch.cli.eval import load_registry
    from vila_tpu_torch.eval import quant_acc

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    registry = load_registry()
    regression = ("loss-regression", "smoke-text", "smoke-image")
    runs = {"mini": (["--tags", "mini"], {n: s for n, s in registry.items()
                                          if "mini" in s.get("tags", [])}),
            "regression": (["--tasks", *regression], {n: registry[n] for n in regression})}
    cli_args = ["-m", quant_acc.PROBE, "--device", dev]
    started = dict(out_dir=out_dir, runs=runs, procs={}, t0=time.perf_counter())
    atexit.register(stop_eval, started)  # should the run end before `phase_eval`
    for tag, (a, _) in runs.items():
        started["procs"][tag] = eval_cli(cli_args + a, os.path.join(out_dir, tag))
    return started


def stop_eval(started):
    """Kill what is left of `start_eval`'s runs and remove their output."""
    import shutil

    for proc, f in started["procs"].values():
        kill_group(proc)
        f.close()
    shutil.rmtree(started["out_dir"], ignore_errors=True)


def phase_eval(started):
    """Evaluation over the committed quant probe through the port's registry
    (`vila-torch-eval`), as task subprocesses on the card (`start_eval`):
    every task exits 0 and its metrics resolve through `json_path`;
    pope-mini's accuracy (bf16) lies within 0.03 of `QUANT_ACC_r05.json`'s
    bf16 figure; smoke-text and smoke-image pass every prompt;
    loss-regression's loss is finite. (The in-process task modules run in
    `quant_acc`, over its W4-RTN engine.)"""
    ok, cli, got_acc, want_acc = True, {}, None, None
    try:
        for tag, (proc, f) in started["procs"].items():
            good, cli[tag] = eval_cli_results(proc, f, os.path.join(started["out_dir"], tag),
                                              "quant_probe", started["runs"][tag][1], tag)
            ok &= good
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), QUANT_ACC_JAX)) as f:
            want_acc = json.load(f)["bf16"]["pope/accuracy"]
        got_acc = cli["mini"].get("pope-mini", {}).get("metrics", {}).get("accuracy")
        good = got_acc is not None and abs(got_acc - want_acc) <= QUANT_ACC_BAND + 1e-9
        ok &= good
        log(f"[eval] pope-mini through vila-torch-eval on the card (bf16): accuracy {got_acc} "
            f"against {want_acc} in {QUANT_ACC_JAX} (band {QUANT_ACC_BAND}); textvqa-mini "
            f"{cli['mini'].get('textvqa-mini', {}).get('metrics')} {'OK' if good else 'FAIL'}")
    finally:
        stop_eval(started)
    secs = time.perf_counter() - started["t0"]
    log(f"[eval] the CLI runs took {secs:.1f} s from their start")
    return ok, dict(cli=cli, pope_mini_accuracy=got_acc, pope_mini_jax=want_acc,
                    seconds_from_start=secs)


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


def _forced_logits(torch, engine, inputs, ids=None, steps=None):
    """The engine's serving path (prefill into the cache, then one decode
    step a token) fed `ids`, or, with `ids` None, fed its own argmax for
    `steps` tokens (greedy): ((len, vocab) f32 logits on the CPU, the ids),
    the row of step i the one that chose ids[i]."""
    from vila_tpu_torch.inference.generate import GenerationConfig

    n = len(ids) if ids is not None else steps
    # the engine's own prefill (PS3's top-down pass included) and steps
    logits, cache, prompt_len, _ = engine._start(inputs, GenerationConfig(max_new_tokens=n))
    rows = [logits[0].float().cpu()]
    fed = list(ids) if ids is not None else [int(rows[0].argmax())]
    for i in range(n - 1):
        row, cache = engine._decode_one(fed[i], cache, prompt_len + i)
        rows.append(torch.from_numpy(row))
        if ids is None:
            fed.append(int(rows[-1].argmax()))
    return torch.stack(rows), fed


CONSISTENCY_TOL = 5e-2  # max |dlogit| / max|logit| between kernels and plain versions


def _by_layer(rows, layers):
    """Per-call values in call order (step-major, one per layer) -> each
    layer's largest."""
    return [max(rows[i::layers]) for i in range(layers)]


class record_selection:
    """While active, PS3's top-k (`ps3.top_k_indices`) records each
    selection it makes, its scores and indices (`scores`, `own`); given
    `feed` (another record of the same path), it returns that record's
    selections in their order in place of its own. So a plain-version pass
    takes the kernel pass's selection (integers: they cross as they are)
    while its own is kept for the overlap."""

    def __init__(self, feed=None):
        self.feed = feed
        self.scores, self.own = [], []

    def __enter__(self):
        from vila_tpu_torch.models import ps3

        self.ps3, self.real = ps3, ps3.top_k_indices

        def top_k(score, k):
            own = self.real(score, k)
            self.scores.append(score)
            self.own.append(own)
            return own if self.feed is None else self.feed.own[len(self.own) - 1]

        ps3.top_k_indices = top_k
        return self

    def __exit__(self, *exc):
        self.ps3.top_k_indices = self.real
        return False

    def overlap(self):
        """Per selection, the share of the fed (kernel) indices that this
        pass's own top-k also chose."""
        return [len(set(a.flatten().tolist()) & set(b.flatten().tolist())) / b.numel()
                for a, b in zip(self.own, self.feed.own)]


def served_against_plain(torch, engine, inputs, ids):
    """The served greedy tokens `ids` of a prepared request against the same
    engine's serving path fed `ids` twice on the card, once through the
    kernels and once through their plain versions (`plain_versions`).
    Required: the kernel pass reproduces every served token (its argmax);
    every K1, K2 and K3 call of that pass agrees with its plain version on
    the same inputs within the kernel's own bar (`LOCAL_TOL`); each served
    token lies within K1's tie band, 2^-7 max|logit|, of the top of the
    plain lm_head over the kernel pass's own last hidden state; and the two
    passes' logits agree within CONSISTENCY_TOL x max|logit| (the
    `consistency` phase's bar). Reported, not required: how many served
    tokens lie within K1's band of the plain pass's own top (`tie_held`):
    at NVILA-8B's 28 random bf16 layers the two passes' hidden states part
    by a few bf16 ulps a layer, compounded with depth (`layer_gap`, each
    layer's largest max|h_kernel - h_plain| / max|h_plain| over the decode
    steps, grows from ~0.7 % after layer 0 to ~3.5 % after layer 27 on the
    H100, while `layer_local`, each K3 call's gap from its plain version on
    the same inputs, stays at 0.3-0.7 %), so the end-to-end top can move by
    two bf16 ulps, more than K1's band (PERF.md §6). A PS3 engine in
    top-down mode runs its pass-1 forward (K2 at the unpadded prompt's M)
    in both passes, and the plain pass takes the kernel pass's selection
    (`record_selection`): `selection_overlap` says how much of it the plain
    pass's own top-k would have chosen."""
    layers = engine.cfg.llm.num_hidden_layers
    vocab = engine.cfg.llm.vocab_size
    t0 = time.time()
    with tap_calls(vocab, check=True) as tk, record_selection() as sk:
        got, _ = _forced_logits(torch, engine, inputs, ids)
    with plain_versions(), tap_calls(vocab) as tp, record_selection(feed=sk) as sp:
        want, _ = _forced_logits(torch, engine, inputs, ids)
    steps = torch.arange(len(ids))
    scale = float(want.abs().max())
    diff = (got - want).abs().amax(-1)
    band = 2.0 ** -7 * scale
    margins = want.max(-1).values - want[steps, ids]
    lm = torch.cat(tk.lm_plain)
    local_margins = lm.max(-1).values - lm[steps, ids]
    local_band = 2.0 ** -7 * lm.abs().amax(-1)
    gap = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(tk.h, tp.h)]
    k3_local = [e / s for e, s in tk.local["fused_layer"][0::2]]
    checks = dict(
        argmax=got.argmax(-1).tolist() == list(ids),
        local=tk.local_ok() and len(tk.lm_plain) == len(ids),
        lm_tie=bool((local_margins <= local_band).all()),
        consistency=float(diff.max()) <= CONSISTENCY_TOL * scale)
    plain = want.argmax(-1).tolist()
    return dict(plain=plain, exact=sum(p == t for p, t in zip(plain, ids)),
                margins=margins.tolist(), tie_held=int((margins <= band).sum()), band=band,
                local_margins=local_margins.tolist(), max_dlogit=float(diff.max()),
                max_logit=scale, tol=CONSISTENCY_TOL * scale, checks=checks,
                local_max={k: max((e / s for e, s in v), default=0.0)
                           for k, v in tk.local.items()},
                layer_gap=_by_layer(gap, layers), layer_local=_by_layer(k3_local, layers),
                ok=all(checks.values()), seconds=time.time() - t0,
                selection=sk, selection_overlap=sp.overlap(),
                k2_calls=len(tk.local["w4_gemm"]))


def phase_load(torch, seed, dev="cuda", layers=2, n_requests=2, new_tokens=16,
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
    forward on the card (`plain_versions`). Last, the quantizer's peak
    memory on a `full_layers`-deep bf16 LLM. The checkpoint goes under the git-ignored
    `runs/` and is removed at the end, pass or fail."""
    import dataclasses
    import shutil
    import tempfile

    from vila_tpu_torch import entry
    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import qwen2, siglip, vlm
    from vila_tpu_torch.ops import quant

    import numpy as np

    cfg = cfg or nvila_8b_config(layers)
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
        media = engine.encode_media(inputs["media"])
        with plain_versions():
            g = greedy_against_plain(torch, llm_q, got_cfg.llm, inputs, media, ids)
        ok &= g["ok"]
        out.update(greedy_exact=g["exact"], greedy_margins=g["margins"], greedy_tol=g["tol"],
                   greedy_ok=g["ok"], ttft_ms=[r["ttft_ms"] for r in reqs],
                   decode_tok_s=[r["decode_tok_s"] for r in reqs])
        log(f"[load] request 0's first {steps} greedy tokens {ids} against a cache-free "
            f"plain forward on the card ({g['seconds']:.1f} s): its argmax {g['plain']} "
            f"equal on {g['exact']}/{steps} steps; top logit minus the served token's "
            f"{[round(m, 4) for m in g['margins']]} (tolerance 2^-7 max|logit| = "
            f"{g['tol']:.4f}) {'OK' if g['ok'] else 'FAIL'}")
        del engine, served, llm_q, media, vt8, loaded, src, l0, q_cpu
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


EXPORT_KEYS = ("llm_config", "vision_config", "projector_spec", "tokens_per_image")


def trace_decode_step(torch, engine, inputs, logdir, name="decode_step"):
    """One bs=1 decode step of `engine` (K3 a layer, K1 on the lm_head)
    traced by `utils.profiling.trace` inside `annotate(name)`, after a
    prefill and one untraced step. Returns the region's host and device
    spans, the kernels that ran beneath it, and whether the op table names
    it (`ops.txt`)."""
    from vila_tpu_torch.inference.generate import GenerationConfig
    from vila_tpu_torch.utils import profiling

    logits, cache, plen, _ = engine._start(inputs, GenerationConfig(max_new_tokens=4))
    tok = int(logits[0].argmax())
    row, cache = engine._decode_one(tok, cache, plen)
    tok = int(row.argmax())
    with profiling.trace(logdir):
        with profiling.annotate(name):
            engine._decode_one(tok, cache, plen + 1)
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    host = [e for e in events if e.get("name") == name and e.get("cat") == "user_annotation"]
    gpu = [e for e in events if e.get("name") == name and e.get("cat") == "gpu_user_annotation"]
    kernels = []
    if host:  # the kernels launched inside the region, by the launches' correlation ids
        lo, hi = host[0]["ts"], host[0]["ts"] + host[0]["dur"]
        corr = {e["args"].get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "args" in e
                and lo <= e["ts"] <= hi}
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and e.get("args", {}).get("correlation") in corr]
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)
            if kernels else 0.0)
    with open(os.path.join(logdir, "ops.txt")) as f:
        in_table = any(line.split() and line.split()[0] == name for line in f)
    return dict(host_us=host[0]["dur"] if host else 0.0,
                device_us=gpu[0]["dur"] if gpu else span, gpu_annotation=bool(gpu),
                kernels=len(kernels), kernel_us=sum(e.get("dur", 0.0) for e in kernels),
                in_op_table=in_table,
                by_kernel={k: sum(1 for e in kernels if e["name"] == k)
                           for k in sorted({e["name"] for e in kernels})})


def phase_export(torch, seed, dev="cuda", layers=2, n_requests=2, new_tokens=16, cfg=None):
    """The single-repo HF export at NVILA-8B width (LLM depth cut to
    `layers`, as `load`): a seeded bf16 tree on the card written with
    `export.export_hf_repo` (≈ 8 GB of f32 safetensors under the
    git-ignored `runs/`, removed at the end), timed; `model.safetensors`
    read back with the port's reader, every tensor bit for bit equal to the
    state dict it came from (`hf_remote.export_state_dict`), and
    config.json's `EXPORT_KEYS` equal to what `entry.build_config` gives
    for the source config; the tree rebuilt from the export's `llm.*` /
    `vision_tower.*` / `mm_projector.*` through the port's converters, cast
    to bf16 (bit for bit the source) and quantized W4 as the loader does;
    `n_requests` image + prompt requests x `new_tokens` through the engine
    over it (K2, K3, K1: exact launches) whose greedy tokens must equal the
    engine's over the source tree; and one decode step traced inside
    `profiling.annotate("decode_step")`, the region in the trace with the
    card's kernels beneath it and in the op table."""
    import shutil
    import tempfile

    from vila_tpu_torch import entry
    from vila_tpu_torch.eval.quant_acc import PROBE
    from vila_tpu_torch.export import hf_remote
    from vila_tpu_torch.inference.generate import GenerationConfig, GenerationEngine
    from vila_tpu_torch.ops import quant
    from vila_tpu_torch.utils import hf_import
    from vila_tpu_torch.utils.device import host_to_device

    cfg = cfg or nvila_8b_config(layers)
    dev = torch.device(dev)
    out, ok = {}, True
    os.makedirs("runs", exist_ok=True)
    root = tempfile.mkdtemp(prefix="export_", dir="runs")
    try:
        # 1-2. a bf16 tree on the card, exported
        t0 = time.time()
        params = synth_bf16_params(torch, cfg, seed + 110, dev)
        torch.cuda.synchronize()
        out["synth_s"] = time.time() - t0
        repo = os.path.join(root, "hf_repo")
        t0 = time.time()
        hf_remote.export_hf_repo(params, cfg, entry.load_tokenizer(PROBE), repo)
        out["export_s"] = time.time() - t0
        weights_path = os.path.join(repo, hf_remote.WEIGHTS)
        out["bytes"] = nbytes = os.path.getsize(weights_path)
        files = sorted(os.listdir(repo))
        with open(hf_remote.REMOTE_CODE, "rb") as f, \
                open(os.path.join(repo, "modeling_vila.py"), "rb") as g:
            code_ok = f.read() == g.read()
        files_ok = code_ok and {"config.json", "tokenizer.json"} <= set(files)
        ok &= files_ok
        log(f"[export] export_hf_repo wrote {nbytes / 1e9:.3f} GB of f32 safetensors in "
            f"{out['export_s']:.1f} s ({nbytes / 1e9 / out['export_s']:.2f} GB/s, host clock; "
            f"the bf16 tree synthesised on the card in {out['synth_s']:.1f} s); files {files}; "
            f"remote code the package's copy {code_ok} {'OK' if files_ok else 'FAIL'}")

        # 3. read back, bit for bit; the config against build_config's
        want = hf_remote.export_state_dict(params, cfg)
        t0 = time.time()
        got = hf_import.read_safetensors(weights_path)
        out["read_s"] = time.time() - t0
        bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
               or not torch.equal(got[k], want[k])] + [k for k in got if k not in want]
        out.update(tensors=len(want), tensors_unequal=bad)
        del want
        src_dir = os.path.join(root, "source_config")
        entry.save_config(cfg, src_dir)
        built = entry.build_config(src_dir, dtype=cfg.llm.dtype, device=dev)
        with open(os.path.join(repo, "config.json")) as f:
            written = json.load(f)
        expect = hf_remote.export_config(built)
        cfg_bad = [k for k in EXPORT_KEYS if written[k] != expect[k]]
        out["config_unequal"] = cfg_bad
        ok &= not bad and not cfg_bad
        log(f"[export] read back with the port's reader in {out['read_s']:.1f} s "
            f"({nbytes / 1e9 / out['read_s']:.2f} GB/s): {len(got) - len(bad)}/{len(got)} "
            f"tensors bit-equal to the state dict they came from; config.json's "
            f"{', '.join(EXPORT_KEYS)} equal to entry.build_config's for the source config: "
            f"{not cfg_bad} {'OK' if not bad and not cfg_bad else 'FAIL ' + str((bad[:4], cfg_bad))}")

        # 4. the tree again, through the port's converters
        def part(prefix):
            return {k[len(prefix):]: host_to_device(v, dev) for k, v in got.items()
                    if k.startswith(prefix)}

        t0 = time.time()
        rebuilt = {"llm": hf_import.convert_llm_state_dict(part("llm."), cfg.llm),
                   "vision_tower": hf_import.convert_siglip_state_dict(part("vision_tower."),
                                                                       cfg.vision),
                   "mm_projector": hf_import.convert_projector_state_dict(part("mm_projector."))}
        rebuilt = cast_tree(rebuilt, torch.bfloat16)
        torch.cuda.synchronize()
        out["rebuild_s"] = time.time() - t0
        del got
        src_leaves, new_leaves = dict(_leaves(params)), dict(_leaves(rebuilt))
        tree_bad = [k for k in src_leaves if k not in new_leaves
                    or not torch.equal(new_leaves[k], src_leaves[k])]
        tree_bad += [k for k in new_leaves if k not in src_leaves]
        ok &= not tree_bad
        log(f"[export] rebuilt through convert_llm_state_dict / convert_siglip_state_dict / "
            f"convert_projector_state_dict and cast to bf16 in {out['rebuild_s']:.1f} s: "
            f"{len(src_leaves) - len(tree_bad)}/{len(src_leaves)} leaves bit-equal to the "
            f"source tree {'OK' if not tree_bad else 'FAIL ' + str(tree_bad[:4])}")
        del src_leaves, new_leaves

        # 5. serve the export's W4 engine and the source's; greedy tokens equal
        def w4_engine(tree):
            llm = quant.quantize_llm_params(tree["llm"], fuse=True, cfg=cfg.llm)
            return GenerationEngine(dict(tree, llm=llm), cfg, ByteTokenizer(), device=dev)

        exported = w4_engine(rebuilt)
        del rebuilt
        good, reqs, launches = phase_e2e(torch, exported, seed + 111, n_requests, new_tokens,
                                         tag="export")
        ok &= good
        source = w4_engine(params)
        del params
        images = _images(seed + 111, n_requests + 1)
        gcfg = GenerationConfig(max_new_tokens=new_tokens, stop_token_ids=(-1,))
        source_ids = [source.generate_ids(source.prepare_inputs(
            [images[i], QUESTIONS[i % len(QUESTIONS)]]), gcfg) for i in range(n_requests)]
        equal = [r["ids"] == ids for r, ids in zip(reqs, source_ids)]
        ok &= len(equal) == n_requests and all(equal)
        out.update(requests=reqs, launches=launches, tokens_equal_source=equal,
                   ttft_ms=[r["ttft_ms"] for r in reqs],
                   decode_tok_s=[r["decode_tok_s"] for r in reqs])
        log(f"[export] {n_requests} requests x {new_tokens} greedy tokens through the "
            f"exported W4 engine (K2 prefill, K3 decode, K1 qkv and lm_head): equal to the "
            f"source engine's {equal} {'OK' if all(equal) else 'FAIL'}")
        del source

        # 7. one decode step inside annotate("decode_step"), traced
        inputs = exported.prepare_inputs([images[0], QUESTIONS[0]])
        logdir = os.path.join(OUT_DIR, "export_decode_step")
        region = trace_decode_step(torch, exported, inputs, logdir)
        fused = sum(n for k, n in region["by_kernel"].items() if "decode_layer" in k)
        good = (region["host_us"] > 0 and region["device_us"] > 0 and region["kernel_us"] > 0
                and region["in_op_table"])
        ok &= good
        out["annotate"] = region
        log(f"[export] one decode step inside annotate('decode_step'), traced: the region "
            f"{region['host_us']:.0f} us on the host, {region['device_us']:.0f} us on the "
            f"card, {region['kernels']} kernels beneath it ({region['kernel_us']:.0f} us; "
            f"{fused} of them K3's), in the op table {region['in_op_table']} "
            f"{'OK' if good else 'FAIL'}; trace in {logdir}")
        del exported
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return ok, out, launches


def phase_consolidate(torch, run_dir, cfg, dev="cuda"):
    """`weights_tools.consolidate_checkpoint` on a `Trainer` run's newest
    checkpoint (the `train` phase's step 3, f32 master weights): the
    component checkpoint it writes (the base model: `cfg`'s config files
    and the quant probe's tokenizer) loads back through
    `entry.load_params` on the card, every leaf bit for bit the
    checkpoint's params; seconds and bytes reported."""
    import shutil
    import tempfile

    from vila_tpu_torch import entry
    from vila_tpu_torch.eval.quant_acc import PROBE
    from vila_tpu_torch.train.checkpoint import CheckpointManager
    from vila_tpu_torch.utils import weights_tools

    dev = torch.device(dev)
    root = tempfile.mkdtemp(prefix="consolidate_", dir="runs")
    out = {}
    try:
        base = os.path.join(root, "base")
        entry.save_config(cfg, base, entry.load_tokenizer(PROBE))
        dest = os.path.join(root, "consolidated")
        torch.cuda.synchronize()
        t0 = time.time()
        weights_tools.consolidate_checkpoint(run_dir, base, dest, map_location=dev)
        out["consolidate_s"] = time.time() - t0
        out["bytes"] = nbytes = sum(os.path.getsize(os.path.join(d, f))
                                    for d, _, fs in os.walk(dest) for f in fs
                                    if f.endswith(".safetensors"))
        mgr = CheckpointManager(run_dir)
        step, state = mgr.restore_latest(dev)
        got_cfg = entry.build_config(dest, dtype="float32", device=dev)
        t0 = time.time()
        loaded = entry.load_params(dest, got_cfg, device=dev)
        out["load_s"] = time.time() - t0
        want, got = dict(_leaves(state["params"])), dict(_leaves(loaded))
        bad = [k for k in want if k not in got or got[k].dtype != want[k].dtype
               or not torch.equal(got[k], want[k])] + [k for k in got if k not in want]
        out.update(step=step, leaves=len(want), leaves_unequal=bad)
        ok = step is not None and not bad
        log(f"[consolidate] step {step}'s checkpoint of the train run consolidated in "
            f"{out['consolidate_s']:.1f} s ({nbytes / 1e9:.3f} GB of f32 safetensors written); "
            f"entry.load_params on the card in {out['load_s']:.1f} s: "
            f"{len(want) - len(bad)}/{len(want)} leaves bit-equal to the checkpoint's params "
            f"{'OK' if ok else 'FAIL ' + str(bad[:4])}")
        del state, loaded, want, got
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return ok, out


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


TRAIN_LAYERS = 8  # the LLM depth of `train` and `train_data` (28 cut for the run's time)


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


def phase_train_kernels(torch, seed, dev="cuda", heads=(12, 2), seq=2048, row_seg=None,
                        only=None, tp=None):
    """K7, K8 and K9 against their plain versions (same inputs, on the
    card), each timed beside its plain version and, as the yardstick,
    `scaled_dot_product_attention` (GQA; causal, or not for the cross shape)
    forward and backward. Shapes: B 1, heads of 128, S `seq` with three
    packed segments and a padding tail (the main one); the same at S - 48
    (ragged tiles); causal alone (SDPA's own work); the `train` phase's first
    packed row; short runs of shuffled segment ids; Sq seq/2 against Skv seq,
    not causal. The bound counts this run's work: 2, 3 and 4 products over
    the (q, k) pairs the masks allow. `only` keeps the shapes of those tags;
    `tp` labels rows of a tensor-parallel rank's heads (off the main rows)."""
    import torch.nn.functional as F

    from vila_tpu_torch.ops import flash_attention as fa

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    hq, hkv = heads
    d = fa.HEAD_DIM
    scale = d ** -0.5
    bf16 = torch.bfloat16
    if row_seg is None and (only is None or "train row" in only):
        row_seg = train_row_segments(torch, seq, dev)
    shapes = [  # (tag, Sq, Skv, causal, segment ids)
        ("3 segments", seq, seq, True, _packed_segments(torch, seq, dev)),
        ("3 segments, ragged", seq - 48, seq - 48, True, _packed_segments(torch, seq - 48, dev)),
        ("causal only", seq, seq, True, None),
        ("train row", seq, seq, True, None if row_seg is None else row_seg.to(dev)),
        ("shuffled ids", seq, seq, True, _shuffled_runs(torch, seq, dev, seed)),
        ("cross, not causal", seq // 2, seq, False, None),
    ]
    if only is not None:
        shapes = [sh for sh in shapes if sh[0] in only]
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
                m=s, main=tag == "3 segments" and tp is None, max_abs_err=max(errs), ok=good,
                ms=t, **({"tp": tp} if tp else {}),
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
            log(f"[train_kernels] {name:13s} {tag:18s} Sq={s} {hq}/{hkv} heads: err "
                f"{max(errs):.3e} "
                f"{'OK' if good else 'FAIL'}{'' if name != 'flash_bwd_dq' else f' (repeat bit-exact {same})'}"
                f"  kernel {t:.4f} ms ({flops / t / 1e9:.1f} "
                f"TFLOP/s on allowed pairs; tiles {live}/{walk} of "
                f"{FLASH_TILES[name][0]}x{FLASH_TILES[name][1]})  plain {t_plain:.3f} ms  "
                f"{results[name][-1]['library']} {lib:.4f} ms  bound {b_ms:.4f} ms ({b_by}; "
                f"causal-only {results[name][-1]['bound_ms_causal']:.4f})")
        del out_g, qg, kg, vg
    if tp is None:
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


TRAIN_DIR = os.path.join("runs", "chip_smoke_train")


def phase_train(torch, seed, cfg=None, dev="cuda", steps=6, save_steps=3, seq=2048,
                out_dir=TRAIN_DIR):
    """`Trainer` on the card at full NVILA-Lite-2B width, stage sft: `steps`
    steps with one checkpoint, at `save_steps` (the later saves skipped:
    each took ≈ 17 s at LLM depth 8); then a fresh `Trainer` resumes from
    it and must reproduce the first run's losses. K7-K9 must launch 28 times per step
    (one per LLM layer; no remat) and nothing else. The run's directory
    stays (`phase_consolidate` reads it); the caller removes it."""
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

    def run(tag, keep):
        """One `Trainer` run; its checkpoint saves at the steps in `keep`
        are written and timed, the others skipped (the resume reads step
        `save_steps`'s)."""
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
            if step not in keep:
                return
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
        want = dict(_no_launches(), **{k: layers * n_steps for k in FLASH_KERNELS},
                    **want_ce(n_steps, seq - 1, cfg.llm.vocab_size))
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

    ok1, rows1, launches1, info1 = run("train", keep={save_steps})
    ok2, rows2, launches2, info2 = run("train resumed", keep=set())
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


def cast_tree(tree, dtype):
    """A nested dict of tensors with every leaf cast to `dtype`."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def copy_tree(tree, dev):
    """A copy of a nested dict of tensors on `dev` (a copy even on the
    same device)."""
    if isinstance(tree, dict):
        return {k: copy_tree(v, dev) for k, v in tree.items()}
    return tree.to(dev, copy=True)


def phase_train_consistency(torch, seed, cfg=None, card="cuda", seq=512, batch=None,
                            name="train_consistency", optimizer="adamw"):
    """One `train_step` (stage sft, constant learning rates so that the
    step moves every tuned tensor) at full widths and reduced depth: on the
    card through K7-K9, and from the same parameters and batch on the card
    through their plain versions (`plain_versions`). The batch is the
    `train` phase's first sample in one row of `seq` unless `batch` (a
    collated row) is given. Tolerances: loss 1e-2 and grad_norm 5e-2
    relative (bf16 attention rounded in another order by the kernels and
    by the plain versions); the updated tensors: each update is at most lr
    per element (Adam's first step is lr * g / (|g| + eps)), so the two
    sides' may differ by up to 2 lr where a gradient near zero changes
    sign, and at least 90 % of the elements must agree within 0.1 lr. With `optimizer="fp8_adamw"` the
    first step divides fp8 moments, and a small gradient whose E5M2 second
    moment underflows to 0 in its block steps by far more than lr on either
    side: the largest difference is reported, not bounded."""
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step

    cfg = cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
    layers = cfg.llm.num_hidden_layers
    if batch is None:
        examples, _, collator, _ = train_data(torch, cfg, seq)
        batch = collator(examples[:1])
    ocfg = topt.OptimizerConfig(learning_rate=2e-5, vision_tower_lr=2e-6,
                                schedule="constant", warmup_ratio=0.0, optimizer=optimizer)
    named = {"llm.layers.q_proj.kernel": (("llm", "layers", "q_proj", "kernel"), 2e-5),
             "vision_tower.layers.fc1.kernel": (("vision_tower", "layers", "fc1", "kernel"), 2e-6),
             "mm_projector.2.kernel": (("mm_projector", "2", "kernel"), 2e-5)}

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    cpu, dev = torch.device("cpu"), torch.device(card)
    params_cpu = vlm.init_params(torch.Generator().manual_seed(seed), cfg, torch.float32)
    before = {n: get(params_cpu, p).detach().clone() for n, (p, _) in named.items()}
    out = {}
    for tag, impl in (("card", "auto"), ("plain", "flash")):
        _build.reset_launches()
        with plain_versions() if tag == "plain" else contextlib.nullcontext():
            params = copy_tree(params_cpu, dev)
            opt = topt.make_optimizer(ocfg)
            _, params, state = make_train_step(cfg, params, opt)
            t0 = time.perf_counter()
            params, state, m = train_step(params, state, batch_to_device(batch, dev), cfg=cfg,
                                          optimizer=opt, attn_impl=impl)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            out[tag] = dict(loss=loss, grad_norm=gnorm, s=time.perf_counter() - t0,
                            launches=dict(_build.LAUNCHES),
                            delta={n: (get(params, p).detach().to(cpu) - before[n])
                                   for n, (p, _) in named.items()})
            del params, state, opt
    card, host = out["card"], out["plain"]
    want = dict(_no_launches(), **{k: layers for k in FLASH_KERNELS},
                **want_ce(1, loss_rows(batch), cfg.llm.vocab_size))
    ok = card["launches"] == want and all(v == 0 for v in host["launches"].values())
    rel_loss = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    rel_gn = abs(card["grad_norm"] - host["grad_norm"]) / abs(host["grad_norm"])
    ok &= rel_loss <= 1e-2 and rel_gn <= 5e-2
    tensors = {}
    for n, (_, lr) in named.items():
        diff = (card["delta"][n] - host["delta"][n]).abs()
        agree = float((diff <= 0.1 * lr).float().mean())
        moved = bool((host["delta"][n] != 0).any())
        bounded = optimizer == "fp8_adamw" or float(diff.max()) <= 2 * lr * (1 + 1e-3)
        good = bounded and agree >= 0.9 and moved
        ok &= good
        tensors[n] = dict(max_abs_diff=float(diff.max()), lr=lr, share_within_0p1_lr=agree)
        log(f"[{name}] {n}: max |d update| {float(diff.max()):.3e} "
            f"(lr {lr:g}), {100 * agree:.2f}% within 0.1 lr -> {'OK' if good else 'FAIL'}")
    log(f"[{name}] {layers} LLM + {cfg.vision.num_hidden_layers} SigLIP layers, "
        f"seq {seq}: "
        f"loss kernels {card['loss']:.6f} / plain {host['loss']:.6f} (rel {rel_loss:.2e}, "
        f"limit 1e-2); grad_norm {card['grad_norm']:.5f} / {host['grad_norm']:.5f} "
        f"(rel {rel_gn:.2e}, limit 5e-2); kernel launches {card['launches']}; plain step "
        f"on the card {host['s']:.1f} s -> {'OK' if ok else 'FAIL'}")
    return ok, dict(loss=(card["loss"], host["loss"]), grad_norm=(card["grad_norm"],
                    host["grad_norm"]), tensors=tensors, plain_s=host["s"])


# frames of the video sample and the dynamic image's size: 4 frames x 257
# tokens and 3 tiles (a 1 x 2 grid and its thumbnail) x 257 fill 1.8k of the
# 2048-token row, so both samples keep their answers
TRAIN_MEDIA_FRAMES = 4
TRAIN_MEDIA_IMAGE = (448, 896, 3)


def train_media_data(torch, cfg, seq, seed, frames_dir, frames=TRAIN_MEDIA_FRAMES):
    """Two samples through the port's `BaseDataset` with the smoke's
    ByteTokenizer: a video of 8 seeded 720 x 1280 frames written as a frame
    directory (`frames` of them sampled, each an image marker), and one
    seeded image tiled `dynamic`; and the packing collator of one row.
    Returns (examples, collator, the config with the data fields set)."""
    import dataclasses

    import numpy as np
    from PIL import Image

    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.data.dataset import BaseDataset

    cfg = dataclasses.replace(cfg, image_aspect_ratio="dynamic", num_video_frames=frames)
    rng = np.random.default_rng(seed + 31)
    os.makedirs(frames_dir, exist_ok=True)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, VIDEO_FRAME, dtype=np.uint8)).save(
            os.path.join(frames_dir, f"{i:03d}.png"))
    image = rng.integers(0, 256, TRAIN_MEDIA_IMAGE, dtype=np.uint8)
    tok = ByteTokenizer()
    answer = "A small red cube moves slowly from the left of the table to the right."
    instances = [
        {"video": frames_dir, "conversations": [
            {"from": "human", "value": "<video>\nWhat happens in the video?"},
            {"from": "gpt", "value": answer}]},
        {"image": image, "conversations": [
            {"from": "human", "value": "<image>\nDescribe the picture."},
            {"from": "gpt", "value": answer}]},
    ]
    ds = BaseDataset(tok, cfg, instances=instances, resample_on_failure=False)
    examples = [ds[0], ds[1]]
    collator = PackingCollator(seq_len=seq, rows=1, pad_token_id=tok.pad_token_id,
                               tile_size=cfg.vision.image_size)
    return examples, collator, cfg


def phase_train_media(torch, seed, cfg=None, dev="cuda", steps=3, seq=2048,
                      out_dir=os.path.join("runs", "chip_smoke_train_media"),
                      check_cfg=None, check_seq=1024, check_frames=3):
    """Training over media samples at full NVILA-Lite-2B width (the `train`
    phase's configuration, `image_aspect_ratio="dynamic"`): one packed row
    of 2048 tokens holding a video sample (TRAIN_MEDIA_FRAMES frames of a
    frame directory) and a `dynamic`-tiled image (3 tiles), `steps` steps of
    `train_step` (the trainer's step, without its checkpoint saves); K7-K9
    launch once per LLM layer per step. Reported: step wall, tokens/s, peak
    memory (under 80 GB). Then a `train_consistency` case at 2 + 2 layers
    on a video row: `check_frames` frames at seq `check_seq` (at 257
    tokens a frame, seq 512 holds under two frames and no answer), the
    card's first step against the CPU's."""
    import shutil

    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step

    dev = torch.device(dev)
    try:
        examples, collator, cfg = train_media_data(
            torch, cfg or nvila_lite_2b_config(), seq, seed, os.path.join(out_dir, "frames"))
        batch = collator(examples)
        tiles = [int(e["tiles"].shape[0]) for e in examples]
        lens = [len(e["input_ids"]) for e in examples]
        fill = float(batch["segment_ids"].astype(bool).mean())
        log(f"[train_media] a video sample ({tiles[0]} frames, {lens[0]} tokens) and a "
            f"dynamic image ({tiles[1]} tiles, {lens[1]} tokens) packed in one {seq}-token "
            f"row ({100 * fill:.1f}% filled, {int((batch['labels'] >= 0).sum())} labels)")
        layers = cfg.llm.num_hidden_layers
        params = vlm.init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                                 torch.float32)
        opt = topt.make_optimizer(topt.OptimizerConfig(learning_rate=2e-5,
                                                       vision_tower_lr=2e-6))
        _, params, state = make_train_step(cfg, params, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        rows = []
        for step in range(steps):
            t0 = time.perf_counter()
            params, state, m = train_step(params, state, batch_to_device(batch, dev), cfg=cfg,
                                          optimizer=opt)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # the host waits, as a log
            step_s = time.perf_counter() - t0
            rows.append(dict(step=step + 1, loss=loss, grad_norm=gnorm, step_s=step_s,
                             tokens_per_s=seq / step_s))
            log(f"[train_media] step {step + 1}: loss {loss:.4f} grad_norm {gnorm:.4f} step "
                f"wall {1e3 * step_s:.1f} ms, {seq / step_s:.0f} tokens/s")
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        del params, state, opt
        gc.collect()
        torch.cuda.empty_cache()
        want = dict(_no_launches(), **{k: layers * steps for k in FLASH_KERNELS},
                    **want_ce(steps, loss_rows(batch), cfg.llm.vocab_size))
        ok = (launches == want and peak < 80e9 and all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows))
        steady = rows[1:] or rows
        summary = dict(
            config="NVILA-Lite-2B, sft, dynamic tiles, f32 master weights, bf16 compute",
            seq=seq, frames=tiles[0], image_tiles=tiles[1], sample_tokens=lens, row_fill=fill,
            steps=rows, step_s_median=statistics.median(r["step_s"] for r in steady),
            tokens_per_s_median=statistics.median(r["tokens_per_s"] for r in steady),
            peak_bytes=peak, launches=launches)
        log(f"[train_media] steps 2..{steps}: step wall median "
            f"{1e3 * summary['step_s_median']:.1f} ms, {summary['tokens_per_s_median']:.0f} "
            f"tokens/s, peak {peak / 2**30:.2f} GiB; launches {launches} (expected {want}) "
            f"-> {'OK' if ok else 'FAIL'}")
        # the consistency case: a video row at 2 + 2 layers, card against CPU
        ccfg = check_cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
        cexamples, ccollator, ccfg = train_media_data(
            torch, ccfg, check_seq, seed, os.path.join(out_dir, "frames"), frames=check_frames)
        good, summary["consistency"] = phase_train_consistency(
            torch, seed, cfg=ccfg, card=dev, seq=check_seq, batch=ccollator(cexamples[:1]),
            name="train_media consistency")
        ok &= good
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return ok, summary, {"train_media": launches}


# --------------------------------------------------------------------------
# The other training modes: fp8, LoRA / DoRA, DPO, reward / PPO, PS3
# --------------------------------------------------------------------------


def train_master(torch, seed, dev="cuda", cfg=None):
    """The f32 NVILA-Lite-2B tree the training-mode phases copy: drawn once
    on the card from the `train` phase's seed (the same values)."""
    from vila_tpu_torch.models import vlm

    return vlm.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg or nvila_lite_2b_config(), torch.float32)


def want_flash(forwards, backwards, layers):
    """K7-K9 launch counts of `forwards` forward passes and `backwards`
    backward passes of `layers` LLM layers (one launch each a layer)."""
    return {"flash_fwd": forwards * layers, "flash_bwd_dq": backwards * layers,
            "flash_bwd_dkv": backwards * layers}


def want_ce(losses, rows, vocab, chunk=None):
    """Launches of the LM head's row kernel (`ce_rows`) for `losses` fused
    losses (`train.losses.chunked_causal_lm_loss` on a dense bf16 head, no
    vocabulary split) over `rows` rows each, in chunks of `chunk` rows
    (`cross_entropy.chunk_rows`' for None). The paths that take the
    logits instead (`loss_eval`, DPO's and PPO's log-probabilities, the
    reward model's value head, tp's vocabulary split) launch none."""
    from vila_tpu_torch.ops.cross_entropy import chunk_rows

    return {"ce_rows": losses * -(-rows // (chunk or chunk_rows(rows, vocab)))}


def loss_rows(batch):
    """The shifted rows of a batch's loss: each row's tokens less one."""
    n_rows, row_len = batch["input_ids"].shape
    return n_rows * (row_len - 1)


class NormedOptimizer:
    """A tree optimizer (`optimizer.adamw`) that keeps the global norm of
    the gradients it steps with (before the step, as `train_step`'s
    grad_norm): the DPO, reward and PPO steps return JAX's metrics, which
    hold no norm."""

    def __init__(self, inner):
        self.inner, self.norm = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, state, params):
        from vila_tpu_torch.train.optimizer import global_norm, leaves

        self.norm = global_norm([t.grad for t in leaves(params)])
        return self.inner.update(state, params)


def _rel_diff(a, b, floor=0.0):
    return abs(a - b) / max(abs(b), floor, 1e-30)


def mode_consistency(torch, seed, name, step, bars, card="cuda", cfg=None, params_fn=None):
    """`step(params, dev)` -> dict of floats, run from one seeded tree on the
    card twice: through the kernels (K7-K9, `torch._scaled_mm`) and through
    their plain versions (`plain_versions`): each
    value within its bar, `bars[key] = (relative tolerance, floor)`:
    |card - plain| <= tol * max(|plain|, floor). The tree is a 2 + 2-layer
    NVILA-Lite-2B draw unless `params_fn(cpu_device)` gives one."""
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    cfg = cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
    params_cpu = (params_fn(cpu) if params_fn else
                  vlm.init_params(torch.Generator().manual_seed(seed), cfg, torch.float32))
    out = {}
    dev = torch.device(card)
    for tag in ("card", "plain"):
        _build.reset_launches()
        with plain_versions() if tag == "plain" else contextlib.nullcontext():
            params = copy_tree(params_cpu, dev)
            t0 = time.perf_counter()
            vals = step(params, dev)
            out[tag] = dict(values={k: float(v) for k, v in vals.items()},
                            s=time.perf_counter() - t0, launches=dict(_build.LAUNCHES))
            del params
    gc.collect()
    ok = all(v == 0 for v in out["plain"]["launches"].values()) and any(
        out["card"]["launches"][k] for k in FLASH_KERNELS)
    rows = {}
    for k, (tol, floor) in bars.items():
        a, b = out["card"]["values"][k], out["plain"]["values"][k]
        rel = _rel_diff(a, b, floor)
        good = math.isfinite(a) and rel <= tol
        ok &= good
        rows[k] = dict(card=a, plain=b, rel=rel, tol=tol)
    log(f"[{name}] kernels against the plain versions on the card: " + "; ".join(
        f"{k} {r['card']:.6g} / {r['plain']:.6g} (rel {r['rel']:.2e}, limit {r['tol']:g})"
        for k, r in rows.items()) + f"; kernel launches {out['card']['launches']}; plain "
        f"{out['plain']['s']:.1f} s -> {'OK' if ok else 'FAIL'}")
    return ok, dict(values=rows, card_launches=out["card"]["launches"],
                    plain_s=out["plain"]["s"])


def _sft_batch(torch, cfg, seq, dev, n=None):
    """The `train` phase's data: DummyDataset images packed in one row;
    the per-step sample count unless `n`."""
    from vila_tpu_torch.train.step import batch_to_device

    examples, per_step, collator, _ = train_data(torch, cfg, seq)
    return batch_to_device(collator(examples[:n or per_step]), torch.device(dev)), per_step


def _run_steps(torch, tag, steps, step_fn, seq):
    """`steps` calls of `step_fn(i)` -> dict of floats (the host reads them,
    as a log does): per step its wall and tokens/s."""
    rows = []
    for i in range(steps):
        t0 = time.perf_counter()
        vals = {k: float(v) for k, v in step_fn(i).items()}
        step_s = time.perf_counter() - t0
        rows.append(dict(step=i + 1, step_s=step_s, tokens_per_s=seq / step_s, **vals))
        log(f"[{tag}] step {i + 1}: " + ", ".join(f"{k} {v:.5g}" for k, v in vals.items())
            + f"; step wall {1e3 * step_s:.1f} ms, {seq / step_s:.0f} tokens/s")
    return rows


def _finite(rows, keys):
    return all(math.isfinite(r[k]) for r in rows for k in keys)


FP8_LINEAR = (2048, 1536, 8960)  # NVILA-Lite-2B's gate_proj at seq 2048: M, K, N


def _check_fp8_linear(torch, fp8_mode, seed, dev="cuda", shape=FP8_LINEAR, reps=20):
    """One `fp8_linear` (fp8_mode True) or `fp8_linear_grouped` ("group")
    forward and backward on the card at a real projection, bf16 operands.
    Its quantizers' bytes and scales are held bit for bit against the same
    quantizers on the CPU. The per-tensor route's three `_scaled_mm`
    products (y, dx, dw) are held against the plain version on the same
    fp8 bytes (`fp8.fp8_mm_plain`: f32 products) within 2^-7 max|ref|
    (K1's bar: Hopper's fp8 tensor cores carry fewer bits than f32 between
    the promotions of their sums, and both sides round to bf16, so an
    element can sit two bf16 ulps from the plain value); the per-group
    route's bf16 product of the dequantized operands against the same operands multiplied in f32
    within 2^-6 max|ref| (its operands are rounded to bf16 first, as in
    JAX). Times: each product of the route, the bf16 `torch.matmul` of the
    same shape, and the whole forward + backward against bf16's."""
    from vila_tpu_torch.ops import fp8

    m, k, n = shape
    gen = torch.Generator(device=dev).manual_seed(seed + 70)
    rows = torch.exp(0.5 * torch.randn((m, 1), generator=gen, device=dev))
    x = (torch.randn((m, k), generator=gen, device=dev) * rows).bfloat16()
    w = (0.02 * torch.randn((k, n), generator=gen, device=dev)).bfloat16()
    g = (1e-3 * torch.randn((m, n), generator=gen, device=dev)).bfloat16()
    fn = fp8.fp8_linear_grouped if fp8_mode == "group" else fp8.fp8_linear
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    y = fn(xr, wr)
    y.backward(g)
    torch.cuda.synchronize()
    got = {"y": y.detach(), "dx": xr.grad, "dw": wr.grad}
    cpu = torch.device("cpu")
    if fp8_mode == "group":
        quants = {"x": lambda t: fp8.quantize_grouped(t), "w": lambda t: fp8.quantize_block2d(t),
                  "g": lambda t: fp8.quantize_grouped(t, fp8.E5M2)}
    else:
        quants = {"x": lambda t: fp8.quantize_tensor(t), "w": lambda t: fp8.quantize_tensor(t),
                  "g": lambda t: fp8.quantize_tensor(t, fp8.E5M2)}
    q, bytes_equal = {}, {}
    for name, t in (("x", x), ("w", w), ("g", g)):
        q[name] = quants[name](t)
        qc, sc = quants[name](t.to(cpu))
        bytes_equal[name] = bool(torch.equal(q[name][0].view(torch.uint8).to(cpu),
                                             qc.view(torch.uint8))
                                 and torch.equal(q[name][1].to(cpu), sc))
    (qx, sx), (qw, sw), (qg, sg) = q["x"], q["w"], q["g"]
    bf = torch.bfloat16
    if fp8_mode == "group":
        xd = fp8.dequantize_grouped(qx, sx, k)
        wd = fp8.dequantize_block2d(qw, sw, k, n)
        gd = fp8.dequantize_grouped(qg, sg, n)
        ref = {"y": (xd @ wd).to(bf), "dx": (gd @ wd.T).to(bf), "dw": (xd.T @ gd).to(bf)}
        products = {"y": lambda: fp8.dequantize_grouped(qx, sx, k, bf)
                    @ fp8.dequantize_block2d(qw, sw, k, n, bf)}
        bar = lambda r: 2.0 ** -6 * r.abs().max()  # noqa: E731
    else:
        ref = {"y": fp8.fp8_mm_plain(qx, sx, qw, sw, bf),
               "dx": fp8.fp8_mm_plain(qg, sg, qw.t(), sw, bf),
               "dw": fp8.fp8_mm_plain(qx.t(), sx, qg, sg, bf)}
        products = {"y": lambda: fp8._fp8_mm(qx, sx, qw, sw, bf),
                    "dx": lambda: fp8._fp8_mm(qg, sg, qw.t(), sw, bf),
                    "dw": lambda: fp8._fp8_mm(qx.t(), sx, qg, sg, bf)}
        bar = lambda r: 2.0 ** -7 * r.abs().max()  # noqa: E731
    errs, ok = {}, all(bytes_equal.values())
    for key in ("y", "dx", "dw"):
        r, gt = ref[key].float(), got[key].float()
        diff = (gt - r).abs()
        good = bool((diff <= bar(r)).all())
        ok &= good and bool(torch.isfinite(gt).all())
        errs[key] = dict(max_abs_err=float(diff.max()), ref_max=float(r.abs().max()), ok=good)
    bf16_mm = {"y": lambda: x @ w, "dx": lambda: g @ w.T, "dw": lambda: x.T @ g}
    times = {key: dict(fp8_ms=time_ms(torch, f, reps), bf16_ms=time_ms(torch, bf16_mm[key], reps))
             for key, f in products.items()}

    def fwd_bwd(f):
        def run():
            xr.grad = wr.grad = None
            f(xr, wr).backward(g)
        return run

    whole = dict(fp8_ms=time_ms(torch, fwd_bwd(fn), reps),
                 bf16_ms=time_ms(torch, fwd_bwd(lambda a, b: a @ b), reps))
    log(f"[train_fp8 {fp8_mode}] fp8 linear M={m} K={k} N={n}: quantizer bytes card = CPU "
        f"{bytes_equal}; " + "; ".join(
            f"{key} max|err| {e['max_abs_err']:.3e} of max|ref| {e['ref_max']:.3e} "
            f"{'OK' if e['ok'] else 'FAIL'}" for key, e in errs.items())
        + "; times (ms, fp8 / bf16 matmul): " + ", ".join(
            f"{key} {t['fp8_ms']:.4f} / {t['bf16_ms']:.4f}" for key, t in times.items())
        + f"; forward + backward {whole['fp8_ms']:.3f} / {whole['bf16_ms']:.3f} -> "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(shape=shape, bytes_equal=bytes_equal, errors=errs, times=times, whole=whole)


def phase_train_fp8(torch, seed, master, dev="cuda", steps=3, seq=2048, cfg=None,
                    check_cfg=None, modes=(True, "group"), check_modes=(True,)):
    """COAT fp8 training at full NVILA-Lite-2B width, stage sft, seq 2048:
    `steps` `train_step`s with every decoder projection in fp8
    (`fp8_matmul` True, then "group") and `optimizer="fp8_adamw"` at the
    stage's learning rates held constant (every step updates), each from a
    copy of the master tree on the `train` phase's first packed row.
    Checks: loss and grad norm finite; the first step's loss within 2 % of
    the bf16 loss of the same weights and row; K7-K9 28 launches a step
    each; the fp8 optimizer state under 0.3 x AdamW's (2 f32 moments a
    parameter); peak under 80 GB; `_check_fp8_linear` at the gate_proj
    shape; for the routes in `check_modes` a 2 + 2-layer step at seq 512
    against the CPU (`phase_train_consistency` with the fp8 route and
    optimizer): the per-tensor route, whose products take another library
    on each side (the per-group route runs the same PyTorch ops on both,
    and its quantizers' bytes are held against the CPU's above)."""
    import dataclasses

    from vila_tpu_torch.cli.train import STAGE_PRESETS
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import loss_fn, make_train_step, train_step

    cfg0 = cfg or nvila_lite_2b_config()
    layers = cfg0.llm.num_hidden_layers
    batch, per_step = _sft_batch(torch, cfg0, seq, dev)
    with torch.no_grad():
        bf16_loss = float(loss_fn(master, cfg0, batch)[0])
    sft = STAGE_PRESETS["sft"]
    ocfg = topt.OptimizerConfig(learning_rate=sft["learning_rate"],
                                vision_tower_lr=sft["vision_tower_lr"], schedule="constant",
                                warmup_ratio=0.0, optimizer="fp8_adamw")
    n_params = sum(t.numel() for t in topt.leaves(master))
    ok, summary, launches = True, dict(bf16_loss=bf16_loss, samples=per_step, seq=seq), {}
    for mode in modes:
        tag = f"train_fp8 {'tensor' if mode is True else mode}"
        good, summary[f"linear_{tag.split()[-1]}"] = _check_fp8_linear(torch, mode, seed, dev)
        ok &= good
        cfg = dataclasses.replace(cfg0, llm=dataclasses.replace(cfg0.llm, fp8_matmul=mode))
        opt = topt.make_optimizer(ocfg)
        _, params, state = make_train_step(cfg, copy_tree(master, dev), opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()

        def one(i):
            nonlocal params, state
            params, state, m = train_step(params, state, batch, cfg=cfg, optimizer=opt)
            return {"loss": m["loss"], "grad_norm": m["grad_norm"]}

        rows = _run_steps(torch, tag, steps, one, seq)
        launches[tag] = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        state_bytes = sum(t.numel() * t.element_size() for o in state.adamw.values()
                          for st in o.state.values() for t in st.values()
                          if isinstance(t, torch.Tensor))
        adamw_bytes = 8 * n_params
        rel0 = _rel_diff(rows[0]["loss"], bf16_loss)
        want = dict(_no_launches(), **want_flash(steps, steps, layers),
                    **want_ce(steps, loss_rows(batch), cfg.llm.vocab_size))
        good = (_finite(rows, ("loss", "grad_norm")) and rel0 <= 0.02
                and launches[tag] == want and state_bytes < 0.3 * adamw_bytes and peak < 80e9)
        ok &= good
        steady = rows[1:] or rows
        summary[tag] = dict(
            steps=rows, first_loss_rel_to_bf16=rel0, peak_bytes=peak, launches=launches[tag],
            optimizer_state_bytes=state_bytes, adamw_state_bytes=adamw_bytes,
            step_s_median=statistics.median(r["step_s"] for r in steady),
            tokens_per_s_median=statistics.median(r["tokens_per_s"] for r in steady))
        log(f"[{tag}] {steps} steps: first loss {rows[0]['loss']:.5f} against bf16 "
            f"{bf16_loss:.5f} (rel {rel0:.2e}, limit 0.02); step wall median "
            f"{1e3 * summary[tag]['step_s_median']:.1f} ms; optimizer state "
            f"{state_bytes / 2**30:.2f} GiB = {state_bytes / adamw_bytes:.3f} x AdamW's "
            f"(limit 0.3); peak {peak / 2**30:.2f} GiB; launches {launches[tag]} (expected "
            f"{want}) -> {'OK' if good else 'FAIL'}")
        del params, state, opt
        gc.collect()
        torch.cuda.empty_cache()
        if mode not in check_modes:
            continue
        small = check_cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
        small = dataclasses.replace(small, llm=dataclasses.replace(small.llm, fp8_matmul=mode))
        good, summary[f"{tag} consistency"] = phase_train_consistency(
            torch, seed, cfg=small, card=dev, name=f"{tag} consistency", optimizer="fp8_adamw")
        ok &= good
    return ok, summary, launches


def phase_train_lora(torch, seed, master, dev="cuda", steps=3, seq=2048, cfg=None,
                     check_cfg=None, lr=2e-4):
    """LoRA, then DoRA, at full NVILA-Lite-2B width: rank 16 on all seven
    projections over the frozen master tree (`lora_loss_fn`), `steps`
    `apply_gradients` steps of AdamW over the factors on the `train`
    phase's first packed row. Checks: with B = 0 the adapted model's hidden
    states equal the base model's bit for bit (DoRA's kernels w / |w| x |w|
    within 1e-6 of max |w|, its hidden states reported); the base tree unchanged and without gradients, the
    factors moved; `merge_lora`'s forward equal to the LoRA forward; K7-K9
    28 a step each; loss and grad norm finite; a 2 + 2-layer DoRA step
    against the CPU."""
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import lora as lora_lib
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import apply_gradients

    cfg = cfg or nvila_lite_2b_config()
    layers = cfg.llm.num_hidden_layers
    batch, _ = _sft_batch(torch, cfg, seq, dev)
    layers_p = master["llm"]["layers"]
    keep = {n: layers_p[n]["kernel"].detach().clone() for n in ("q_proj", "gate_proj")}
    ok, summary, launches = True, {}, {}
    with torch.no_grad():
        h_base = vlm.forward_batch(master, cfg, batch, return_hidden=True)
    for dora in (False, True):
        tag = "train_lora dora" if dora else "train_lora"
        lcfg = lora_lib.LoRAConfig(rank=16, use_dora=dora)
        lora = lora_lib.init_lora(torch.Generator(device=dev).manual_seed(seed + 80),
                                  master["llm"], lcfg)
        with torch.no_grad():
            adapted = lora_lib.apply_lora(master, lora, lcfg)
            h0 = vlm.forward_batch(adapted, cfg, batch, return_hidden=True)
            kernel_rel = max(float((adapted["llm"]["layers"][n]["kernel"] - layers_p[n]["kernel"])
                                   .abs().max() / layers_p[n]["kernel"].abs().max())
                             for n in lcfg.targets)
            del adapted
        same0 = bool(torch.equal(h0, h_base))
        rel0 = float((h0.float() - h_base.float()).abs().max() / h_base.float().abs().max())
        # DoRA's w / |w| x |w| is w within f32 rounding, which the bf16
        # forward can round to the next bf16 value
        identity = kernel_rel <= 1e-6 if dora else same0
        fn = lora_lib.lora_loss_fn(master, cfg, lcfg)
        opt = topt.adamw(lr, weight_decay=0.0)
        state = opt.init(lora)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()

        def one(i):
            nonlocal state
            loss, _, grad_norm, state = apply_gradients(lora, lambda: fn(lora, batch), opt,
                                                        state)
            return {"loss": loss, "grad_norm": grad_norm}

        rows = _run_steps(torch, tag, steps, one, seq)
        launches[tag] = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        base_same = all(torch.equal(layers_p[n]["kernel"], v) for n, v in keep.items()) and all(
            t.grad is None and not t.requires_grad for t in topt.leaves(master))
        moved = all(bool(e["b"].any()) for e in lora.values())
        with torch.no_grad():
            h_lora = vlm.forward_batch(lora_lib.apply_lora(master, lora, lcfg), cfg, batch,
                                       return_hidden=True)
            merged = lora_lib.merge_lora(master, {k: {kk: vv.detach() for kk, vv in e.items()}
                                                  for k, e in lora.items()}, lcfg)
            h_merged = vlm.forward_batch(merged, cfg, batch, return_hidden=True)
        merge_same = bool(torch.equal(h_lora, h_merged))
        del merged, h_lora, h_merged
        want = dict(_no_launches(), **want_flash(steps, steps, layers),
                    **want_ce(steps, loss_rows(batch), cfg.llm.vocab_size))
        good = (identity and base_same and moved and merge_same and launches[tag] == want
                and _finite(rows, ("loss", "grad_norm")) and peak < 80e9)
        ok &= good
        n_factors = sum(t.numel() for t in topt.leaves(lora))
        steady = rows[1:] or rows
        summary[tag] = dict(steps=rows, identity_bit_exact=same0, identity_rel=rel0,
                            identity_kernel_rel=kernel_rel,
                            base_unchanged=base_same, factors_moved=moved,
                            merge_equal=merge_same, factor_params=n_factors, peak_bytes=peak,
                            launches=launches[tag],
                            step_s_median=statistics.median(r["step_s"] for r in steady))
        log(f"[{tag}] rank 16 x 7 projections ({n_factors} factor parameters): step 0 "
            f"hidden equal to the base model's {same0} (max rel {rel0:.2e}; kernels' max rel "
            f"{kernel_rel:.2e}); base unchanged "
            f"{base_same}; factors moved {moved}; merged forward equal {merge_same}; peak "
            f"{peak / 2**30:.2f} GiB; launches {launches[tag]} (expected {want}) -> "
            f"{'OK' if good else 'FAIL'}")
        del lora, state, opt
        gc.collect()
        torch.cuda.empty_cache()
    del h_base, keep

    lcfg = lora_lib.LoRAConfig(rank=16, use_dora=True)
    small = check_cfg or nvila_lite_2b_config(layers=2, vision_layers=2)
    cbatch = train_data(torch, small, 512)
    cbatch = cbatch[2](cbatch[0][:1])

    def check_step(params, d):
        from vila_tpu_torch.train.step import batch_to_device

        lora = copy_tree(lora_lib.init_lora(torch.Generator().manual_seed(seed + 81),
                                            copy_tree(params["llm"], torch.device("cpu")),
                                            lcfg), d)
        fn = lora_lib.lora_loss_fn(params, small, lcfg)
        opt = topt.adamw(lr, weight_decay=0.0)
        b = batch_to_device(cbatch, d)
        loss, _, grad_norm, _ = apply_gradients(lora, lambda: fn(lora, b), opt, opt.init(lora))
        return {"loss": loss, "grad_norm": grad_norm}

    good, summary["consistency"] = mode_consistency(
        torch, seed, "train_lora dora consistency", check_step,
        {"loss": (1e-2, 0.0), "grad_norm": (5e-2, 0.0)}, card=dev, cfg=small)
    return ok & good, summary, launches


def _preference_pairs(examples, n):
    """n (chosen, rejected) pairs: each example as chosen, and as rejected
    the same prompt and image with the answer's tokens reversed."""
    import numpy as np

    pairs = []
    for e in examples[:n]:
        ans = np.nonzero(e["labels"] >= 0)[0]
        ids = e["input_ids"].copy()
        ids[ans] = ids[ans[::-1]]
        labels = e["labels"].copy()
        labels[ans] = labels[ans[::-1]]
        pairs.append({"chosen": e, "rejected": dict(e, input_ids=ids, labels=labels)})
    return pairs


def _pair_batch(torch, cfg, seq, dev, n=2, base=None):
    """n `DPOCollator` pairs of DummyDataset image samples, one a row of
    `seq` tokens, on `dev` (the collated numpy batch when `dev` is None)."""
    from vila_tpu_torch.data.collate import Collator
    from vila_tpu_torch.train.dpo import DPOCollator
    from vila_tpu_torch.train.step import batch_to_device

    examples, _, _, _ = train_data(torch, cfg, seq)
    tok = ByteTokenizer()
    pairs = DPOCollator(Collator(seq_len=seq, pad_token_id=tok.pad_token_id,
                                 tile_size=cfg.vision.image_size))(
        _preference_pairs(examples, n))
    if dev is None:
        return pairs
    return {k: batch_to_device(v, torch.device(dev)) for k, v in pairs.items()}


def _remat(cfg):
    import dataclasses

    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, remat=True))


def phase_train_dpo(torch, seed, master, dev="cuda", steps=2, seq=1024, cfg=None,
                    check_cfg=None, check_seq=512, lr=5e-6):
    """DPO at full NVILA-Lite-2B width, `remat=True`: 2 `DPOCollator` pairs
    of 1024-token rows (a DummyDataset image sample as chosen, its answer
    reversed as rejected), `steps` `dpo_step_fn` steps of the policy (a
    copy of the master tree) against the master tree as the frozen
    reference. Checks: at step 0 (reference = policy) the loss is log 2
    and the reward margin 0 (within 1e-6); the margin rises; K7 6 x 28 a
    step (4 forwards, 2 recomputed), K8 and K9 2 x 28; peak under 80 GB;
    at 2 + 2 layers (one pair at seq 512) the policy's log-probs and the
    step's grad norm against the CPU."""
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import dpo
    from vila_tpu_torch.train import optimizer as topt

    cfg = _remat(cfg or nvila_lite_2b_config())
    layers = cfg.llm.num_hidden_layers
    batch = _pair_batch(torch, cfg, seq, dev)
    policy = copy_tree(master, dev)
    opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
    state = opt.init(policy)
    dcfg = dpo.DPOConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()

    def one(i):
        nonlocal policy, state
        policy, state, m = dpo.dpo_step_fn(policy, master, batch, cfg=cfg, dcfg=dcfg,
                                           optimizer=opt, opt_state=state)
        return dict(m, grad_norm=opt.norm)

    rows = _run_steps(torch, "train_dpo", steps, one, 2 * 2 * seq)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del policy, state, opt
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(_no_launches(), **want_flash(6 * steps, 2 * steps, layers))
    at0 = (abs(rows[0]["loss"] - math.log(2.0)) <= 1e-6
           and abs(rows[0]["reward_margin"]) <= 1e-6)
    rises = rows[-1]["reward_margin"] > rows[0]["reward_margin"]
    ok = (at0 and rises and launches == want and peak < 80e9
          and _finite(rows, ("loss", "grad_norm")))
    log(f"[train_dpo] step 0: loss {rows[0]['loss']:.7f} (log 2 = {math.log(2.0):.7f}), "
        f"margin {rows[0]['reward_margin']:.3e}; margin after {steps - 1} updates "
        f"{rows[-1]['reward_margin']:.4e} (rises: {rises}); peak {peak / 2**30:.2f} GiB; "
        f"launches {launches} (expected {want}) -> {'OK' if ok else 'FAIL'}")
    summary = dict(config="NVILA-Lite-2B, remat, beta 0.1, sigmoid, 2 pairs x 1024 tokens",
                   steps=rows, peak_bytes=peak, launches=launches,
                   step_s_median=statistics.median(r["step_s"] for r in rows))

    small = _remat(check_cfg or nvila_lite_2b_config(layers=2, vision_layers=2))
    cpairs = _pair_batch(torch, small, check_seq, None, n=1)

    def check_step(params, d):
        from vila_tpu_torch.train.step import batch_to_device

        b = {k: batch_to_device(v, d) for k, v in cpairs.items()}
        ref = copy_tree(params, d)
        with torch.no_grad():
            lp = {k: dpo.sequence_logp(params, small, b[k]).sum() for k in b}
        opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
        _, _, m = dpo.dpo_step_fn(params, ref, b, cfg=small, dcfg=dcfg, optimizer=opt,
                                  opt_state=opt.init(params))
        return {"logp_chosen": lp["chosen"], "logp_rejected": lp["rejected"],
                "loss": m["loss"], "grad_norm": opt.norm}

    good, summary["consistency"] = mode_consistency(
        torch, seed, "train_dpo consistency", check_step,
        {"logp_chosen": (1e-2, 0.0), "logp_rejected": (1e-2, 0.0), "loss": (1e-6, 0.0),
         "grad_norm": (5e-2, 0.0)}, card=dev, cfg=small)
    return ok and good, summary, {"train_dpo": launches}


def _ppo_rows(torch, cfg, seq, dev, n=2, seed=0):
    """n DummyDataset image samples, one a row (Collator), on `dev`; the
    response mask (the answer's next-token positions) and seeded scores."""
    from vila_tpu_torch.data.collate import Collator
    from vila_tpu_torch.train.step import batch_to_device

    examples, _, _, _ = train_data(torch, cfg, seq)
    batch = Collator(seq_len=seq, pad_token_id=ByteTokenizer().pad_token_id,
                     tile_size=cfg.vision.image_size)(examples[:n])
    mask = torch.tensor(batch["labels"][:, 1:] >= 0, dtype=torch.float32, device=dev)
    scores = torch.randn((n,), generator=torch.Generator().manual_seed(seed + 91)).to(dev)
    return batch_to_device(batch, torch.device(dev)), mask, scores


def phase_train_rlhf(torch, seed, master, dev="cuda", seq=1024, reward_steps=2, ppo_steps=2,
                     cfg=None, check_cfg=None, check_seq=512, lr=1e-6):
    """Reward modeling and PPO at full NVILA-Lite-2B width, `remat=True`,
    rows of 1024: a reward model (a copy of the master tree and a value
    head) takes `reward_steps` pairwise steps on 2 preference pairs; then a
    policy (another copy) and a fresh value head make one
    `make_experience` against the master tree as the frozen reference and
    take `ppo_steps` `ppo_step_fn` steps on 2 rows. Checks: at the first
    PPO step new logp equals old, so `clipfrac` is 0, the ratio's mean 1
    and `pg_loss` -mean(advantage) over the response mask; K7-K9 as
    counted (a reward step 4 x 28 / 2 x 28, the experience 2 x 28 / 0, a
    PPO step 2 x 28 / 1 x 28); losses and grad norms finite; peak under 80
    GB; at 2 + 2 layers (one pair, one row, seq 512) a reward step and an
    experience + PPO step against the CPU."""
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train import rlhf

    cfg = _remat(cfg or nvila_lite_2b_config())
    layers = cfg.llm.num_hidden_layers
    d_model = cfg.llm.hidden_size
    pairs = _pair_batch(torch, cfg, seq, dev)
    rcfg, pcfg = rlhf.RewardConfig(), rlhf.PPOConfig()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    params = copy_tree(master, dev)
    head = rlhf.init_value_head(torch.Generator(device=dev).manual_seed(seed + 90), d_model)
    opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
    state = opt.init((params, head))

    def reward_one(i):
        nonlocal params, head, state
        params, head, state, m = rlhf.reward_step_fn(params, head, pairs, cfg=cfg, rcfg=rcfg,
                                                     optimizer=opt, opt_state=state)
        return dict(m, grad_norm=opt.norm)

    rrows = _run_steps(torch, "train_rlhf reward", reward_steps, reward_one, 2 * 2 * seq)
    launches = {"train_rlhf reward": dict(_build.LAUNCHES)}
    del params, head, state, opt
    gc.collect()
    torch.cuda.empty_cache()

    batch, mask, scores = _ppo_rows(torch, cfg, seq, dev, seed=seed)
    policy = copy_tree(master, dev)
    vh = rlhf.init_value_head(torch.Generator(device=dev).manual_seed(seed + 92), d_model)
    _build.reset_launches()
    t0 = time.perf_counter()
    exp = rlhf.make_experience(policy, master, vh, batch, mask, scores, cfg=cfg, pcfg=pcfg)
    exp_kl = float(exp["kl"])
    exp_s = time.perf_counter() - t0
    opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
    state = opt.init((policy, vh))

    def ppo_one(i):
        nonlocal policy, vh, state
        policy, vh, state, m = rlhf.ppo_step_fn(policy, vh, batch, mask, exp, cfg=cfg,
                                                pcfg=pcfg, optimizer=opt, opt_state=state)
        return dict(m, grad_norm=opt.norm)

    prows = _run_steps(torch, "train_rlhf ppo", ppo_steps, ppo_one, 2 * seq)
    launches["train_rlhf ppo"] = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    pg_want = float(-(exp["advantages"] * mask).sum() / mask.sum())
    del policy, vh, state, opt, exp
    gc.collect()
    torch.cuda.empty_cache()
    first = prows[0]
    at_init = (first["clipfrac"] == 0.0 and abs(first["ratio_mean"] - 1.0) <= 1e-6
               and _rel_diff(first["pg_loss"], pg_want, 1.0) <= 1e-6)
    want_r = dict(_no_launches(), **want_flash(4 * reward_steps, 2 * reward_steps, layers))
    want_p = dict(_no_launches(), **want_flash(2 + 2 * ppo_steps, ppo_steps, layers))
    ok = (at_init and launches["train_rlhf reward"] == want_r
          and launches["train_rlhf ppo"] == want_p and peak < 80e9 and exp_kl == 0.0
          and _finite(rrows, ("loss", "grad_norm")) and _finite(prows, ("loss", "grad_norm")))
    log(f"[train_rlhf] experience {1e3 * exp_s:.1f} ms (kl against the reference "
        f"{exp_kl:.3g}); first PPO step: clipfrac {first['clipfrac']}, ratio mean "
        f"{first['ratio_mean']:.7f}, pg_loss {first['pg_loss']:.6g} against "
        f"-mean(advantage) {pg_want:.6g}; peak {peak / 2**30:.2f} GiB; launches {launches} "
        f"(expected reward {want_r}, ppo {want_p}) -> {'OK' if ok else 'FAIL'}")
    summary = dict(config="NVILA-Lite-2B, remat, rows of 1024, value head on the trunk",
                   reward_steps=rrows, ppo_steps=prows, experience_s=exp_s, peak_bytes=peak,
                   launches=launches)

    small = _remat(check_cfg or nvila_lite_2b_config(layers=2, vision_layers=2))
    cpairs = _pair_batch(torch, small, check_seq, None, n=1)
    crows = _ppo_rows(torch, small, check_seq, "cpu", n=1, seed=seed)

    def check_step(params, d):
        from vila_tpu_torch.train.step import batch_to_device

        b = {k: batch_to_device(v, d) for k, v in cpairs.items()}
        h = copy_tree(rlhf.init_value_head(torch.Generator().manual_seed(seed + 93), d_model), d)
        ref = copy_tree(params, d)
        opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
        _, h, _, rm = rlhf.reward_step_fn(params, h, b, cfg=small, rcfg=rcfg, optimizer=opt,
                                          opt_state=opt.init((params, h)))
        rnorm = opt.norm
        rb, rmask, rscores = (copy_tree(t, d) for t in crows)
        exp = rlhf.make_experience(params, ref, h, rb, rmask, rscores, cfg=small, pcfg=pcfg)
        opt = NormedOptimizer(topt.adamw(lr, weight_decay=0.0))
        _, _, _, pm = rlhf.ppo_step_fn(params, h, rb, rmask, exp, cfg=small, pcfg=pcfg,
                                       optimizer=opt, opt_state=opt.init((params, h)))
        return {"reward_loss": rm["loss"], "reward_margin": rm["reward_margin"],
                "reward_grad_norm": rnorm, "ppo_loss": pm["loss"], "vf_loss": pm["vf_loss"],
                "pg_loss": pm["pg_loss"], "ppo_grad_norm": opt.norm}

    # a reward reads one token's hidden state and the value loss squares
    # each token's value, so the bf16 differences a mean over the row
    # would average stay whole there: 2e-2 for those, 1e-2 for the rest
    good, summary["consistency"] = mode_consistency(
        torch, seed, "train_rlhf consistency", check_step,
        {"reward_loss": (2e-2, 0.0), "reward_margin": (2e-2, 1.0),
         "reward_grad_norm": (5e-2, 0.0), "ppo_loss": (2e-2, 1.0), "vf_loss": (2e-2, 0.0),
         "pg_loss": (1e-2, 1.0), "ppo_grad_norm": (5e-2, 0.0)}, card=dev, cfg=small)
    return ok and good, summary, launches


PS3_TRAIN_ROWS = 2  # one 4:3 image a row


def ps3_train_config(torch, layers=28, tower_layers=None, dev="cuda"):
    """VILA-HD for training through `entry.build_config`: the `ps3` phase's
    tower (PS3_TOWER), "after_image" selection, an mlp2x_gelu projector and
    the e2e engine's Qwen2-7B (dense bf16 here); `tower_layers` cuts the
    trunk."""
    import dataclasses

    base = nvila_8b_config(layers)
    base = dataclasses.replace(base, projector=dataclasses.replace(
        base.projector, projector_type="mlp2x_gelu"))
    tower = dict(PS3_TOWER, **({"num_hidden_layers": tower_layers} if tower_layers else {}))
    return config_from_files(base, {"ps3_look_close_mode": "after_image"}, vision_tower=tower,
                             dev=dev)


def ps3_train_params(torch, cfg, seed, dev):
    """A seeded VILA-HD tree: the LLM in bf16 (frozen in stage 1.5), the
    tower and projector f32 master weights."""
    from vila_tpu_torch.models import projector, ps3, qwen2

    gen = torch.Generator(device=dev).manual_seed(seed + 60)
    return {"llm": qwen2.init_params(gen, cfg.llm, torch.bfloat16),
            "vision_tower": ps3.init_params(gen, cfg.vision, torch.float32),
            "mm_projector": projector.init_params(gen, cfg.projector, torch.float32)}


def ps3_train_batch(torch, cfg, seq, seed, rows=PS3_TRAIN_ROWS):
    """`rows` rows of one seeded 4:3 image each (resized to every scale's
    square as the engine does), a question and an answer, through the
    port's `Collator`, with gt selection maps (a 108 x 108 map a tile, one
    seeded rectangle marked); `pixel_values_high` then becomes a list, one
    (B, 1, s, s, 3) array a high scale, since the collators carry one
    array (the reference's fault)."""
    import numpy as np

    from vila_tpu_torch.constants import MEDIA_TOKENS
    from vila_tpu_torch.data import preprocess
    from vila_tpu_torch.data.collate import Collator

    tok = ByteTokenizer()
    rng = np.random.default_rng(seed + 61)
    tpi = cfg.tokens_per_image
    img_id = tok.convert_tokens_to_ids(MEDIA_TOKENS["image"])
    examples, highs = [], []
    for i in range(rows):
        img = rng.integers(0, 256, PS3_IMAGE, dtype=np.uint8)
        views = [preprocess.process_image(img, image_size=s, image_aspect_ratio="resize")[0]
                 for s in cfg.vision.s3_scales]
        q = tok("<|im_start|>user\n").input_ids
        a = tok(f"\nWhat is in region {i}?<|im_end|>\n<|im_start|>assistant\n").input_ids
        ans = tok(f"A seeded pattern of noise, row {i}, with no object in it.<|im_end|>"
                  ).input_ids
        ids = np.array(q + [img_id] * tpi + a + ans, np.int32)
        labels = np.full(len(ids), -100, np.int32)
        labels[-len(ans):] = ans
        gt = np.zeros((1, 108, 108), np.float32)
        r0, c0 = rng.integers(0, 80, 2)
        gt[0, r0:r0 + 24, c0:c0 + 24] = 1.0
        examples.append({"input_ids": ids, "labels": labels, "tiles": views[0],
                         "media_positions": np.arange(len(q), len(q) + tpi, dtype=np.int32),
                         "tiles_high": views[1], "gt_selection_map": gt})
        highs.append(views[1:])
    batch = Collator(seq_len=seq, pad_token_id=tok.pad_token_id,
                     tile_size=cfg.vision.image_size)(examples)
    batch["pixel_values_high"] = [np.stack([h[j] for h in highs])
                                  for j in range(len(cfg.vision.s3_scales) - 1)]
    return batch


def phase_train_ps3(torch, seed, dev="cuda", steps=2, seq=1024, cfg=None, check_cfg=None):
    """PS3 / VILA-HD top-down training, stage 1.5 (tower and projector
    tuned, the LLM frozen): the `ps3` phase's tower at full width and the
    e2e engine's Qwen2-7B as a dense bf16 LLM, `steps` `train_step`s on
    `PS3_TRAIN_ROWS` rows of seq 1024 with gt selection maps (teacher-forced
    selection, the BCE + DICE selection loss beside the LM loss). Checks:
    loss, selection loss and grad norm finite; the LLM unchanged, the
    tower moved; K7-K9 28 a step each (the tower's head dim of 72 takes no
    flash kernel); peak under 80 GB; a 2 + 2-layer step (tower 2 layers)
    against the CPU."""
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step

    dev = torch.device(dev)
    cfg = cfg or ps3_train_config(torch, dev=dev)
    layers = cfg.llm.num_hidden_layers
    batch_np = ps3_train_batch(torch, cfg, seq, seed)
    batch = batch_to_device(batch_np, dev)
    ocfg = topt.OptimizerConfig(learning_rate=5e-5, schedule="constant", warmup_ratio=0.0,
                                tune_language_model=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = ps3_train_params(torch, cfg, seed, dev)
    llm_before = params["llm"]["layers"]["q_proj"]["kernel"].clone()
    tower_before = params["vision_tower"]["select_head"]["kernel"].clone()
    opt = topt.make_optimizer(ocfg)
    _, params, state = make_train_step(cfg, params, opt)
    _build.reset_launches()

    def one(i):
        nonlocal params, state
        params, state, m = train_step(params, state, batch, cfg=cfg, optimizer=opt)
        return {k: m[k] for k in ("loss", "token_selection_loss", "grad_norm")}

    rows = _run_steps(torch, "train_ps3", steps, one, PS3_TRAIN_ROWS * seq)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    frozen = bool(torch.equal(params["llm"]["layers"]["q_proj"]["kernel"], llm_before))
    moved = not torch.equal(params["vision_tower"]["select_head"]["kernel"], tower_before)
    del params, state, opt, llm_before, tower_before
    gc.collect()
    torch.cuda.empty_cache()
    want = dict(_no_launches(), **want_flash(steps, steps, layers),
                **want_ce(steps, loss_rows(batch), cfg.llm.vocab_size))
    ok = (_finite(rows, ("loss", "token_selection_loss", "grad_norm")) and frozen and moved
          and launches == want and peak < 80e9)
    fill = float(batch_np["segment_ids"].astype(bool).mean())
    log(f"[train_ps3] VILA-HD ({cfg.vision.s3_scales}, {cfg.vision.k_per_scale} a high "
        f"scale, {cfg.tokens_per_image} tokens an image), Qwen2-7B bf16 frozen, "
        f"{PS3_TRAIN_ROWS} rows of {seq} ({100 * fill:.1f}% filled): LLM unchanged {frozen}, "
        f"tower moved {moved}; peak {peak / 2**30:.2f} GiB; launches {launches} (expected "
        f"{want}) -> {'OK' if ok else 'FAIL'}")
    summary = dict(config="VILA-HD (PS3-1.5K tower, Qwen2-7B bf16 frozen), stage15",
                   steps=rows, row_fill=fill, peak_bytes=peak, launches=launches,
                   step_s_median=statistics.median(r["step_s"] for r in rows))

    small = check_cfg or ps3_train_config(torch, layers=2, tower_layers=2, dev=dev)
    cbatch = ps3_train_batch(torch, small, seq, seed, rows=1)

    def check_step(params, d):
        opt = topt.make_optimizer(ocfg)
        _, params, state = make_train_step(small, params, opt)
        _, _, m = train_step(params, state, batch_to_device(cbatch, d), cfg=small,
                             optimizer=opt)
        return {k: m[k] for k in ("loss", "token_selection_loss", "grad_norm")}

    good, summary["consistency"] = mode_consistency(
        torch, seed, "train_ps3 consistency", check_step,
        {"loss": (1e-2, 0.0), "token_selection_loss": (1e-2, 0.0), "grad_norm": (5e-2, 0.0)},
        card=dev, cfg=small,
        params_fn=lambda d: copy_tree(ps3_train_params(torch, small, seed, dev), d))
    return ok and good, summary, {"train_ps3": launches}


# --------------------------------------------------------------------------
# Training on a mixture read from the port's registry (NVILA-Lite-2B)
# --------------------------------------------------------------------------

# samples of each kind in the seeded corpus (`write_corpus`)
CORPUS = dict(pairs=8, sft=4, docs=4, caption_pairs=8, textocr=4, lita=2, frames=4)
CORPUS_IMAGE = (96, 128, 3)  # every image is resized to the tower's 448² anyway
CORPUS_MIXTURE = "corpus_interleaved+corpus_pairs+corpus_wds*2+corpus_textocr+corpus_lita"
TRAIN_DATA_FRAMES = 2  # a LITA video's frames (the config's 8 would fill a row alone)
# loss_eval through K7 against its plain version, relative (1.95e-6 on the
# H100; the loss stays near ln V whatever attention does, so the last
# layer's output is held too, within CONSISTENCY_TOL x max|ref|)
LOSS_EVAL_TOL = 1e-4


def write_corpus(root, seed, sizes=CORPUS, image_shape=CORPUS_IMAGE):
    """A seeded training corpus under `root`, written with the port's `prep`:
    image + caption tar shards (`TarShardWriter`), an SFT json turned into
    shards (`sft_json_to_shards`; its records carry a caption), MMC4-style
    documents with 2-4 images each, caption pairs, TextOCR records in tar
    shards (the image and its annotations) and LITA records over frame
    directories; and its registry, `root/corpus.yaml` (the port's YAML
    writer), with `data_path` under `${VILA_DATA_ROOT}` or `shards`. Returns
    (the registry's path, every tar shard written)."""
    import numpy as np
    from PIL import Image

    from vila_tpu_torch.data import prep
    from vila_tpu_torch.utils import io as vio

    rng = np.random.default_rng(seed)
    media = os.path.join(root, "media")
    os.makedirs(media, exist_ok=True)
    words = ("red", "cube", "table", "river", "sign", "open", "cat", "street", "two", "blue")

    def text(n):
        return " ".join(words[i] for i in rng.integers(0, len(words), n))

    def image(path):
        Image.fromarray(rng.integers(0, 256, image_shape, dtype=np.uint8)).save(path)
        return path

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    with prep.TarShardWriter(os.path.join(root, "pairs"), prefix="pairs",
                             samples_per_shard=4) as w:
        for i in range(sizes["pairs"]):
            png = read(image(os.path.join(media, f"pair{i}.png")))
            w.add(f"pair-{i:05d}", prep.caption_sample(png, text(6), "png"))
        pair_shards = list(w.shard_paths)
    sft = [{"id": i, "image": os.path.basename(image(os.path.join(media, f"sft{i}.png"))),
            "caption": text(8),
            "conversations": [{"from": "human", "value": "<image>\nDescribe it."},
                              {"from": "gpt", "value": text(8)}]}
           for i in range(sizes["sft"])]
    vio.save(os.path.join(root, "sft.json"), sft)
    sft_shards = prep.sft_json_to_shards(os.path.join(root, "sft.json"), media,
                                         os.path.join(root, "sft"), samples_per_shard=2)
    docs = []
    for i in range(sizes["docs"]):
        n_img = int(rng.integers(2, 5))
        n_sent = n_img + 2
        docs.append({"texts": [text(5) + "." for _ in range(n_sent)],
                     "images": [image(os.path.join(media, f"doc{i}_{j}.png"))
                                for j in range(n_img)],
                     "matched_idx": sorted(rng.integers(0, n_sent, n_img).tolist())})
    vio.save(os.path.join(root, "mmc4.json"), docs)
    vio.save(os.path.join(root, "pairs.json"),
             [{"image": image(os.path.join(media, f"cap{i}.png")), "caption": text(7)}
              for i in range(sizes["caption_pairs"])])
    h, w_img = image_shape[:2]
    with prep.TarShardWriter(os.path.join(root, "textocr"), prefix="ocr",
                             samples_per_shard=2) as w:
        for i in range(sizes["textocr"]):
            anns = [{"utf8_string": text(1).upper(),
                     "bbox": [int(rng.integers(0, w_img // 2)), int(rng.integers(0, h // 2)),
                              20, 10]} for _ in range(3)]
            w.add(f"ocr-{i:05d}", {"png": read(image(os.path.join(media, f"ocr{i}.png"))),
                                   "json": json.dumps({"anns": anns, "width": w_img,
                                                       "height": h})})
        ocr_shards = list(w.shard_paths)
    lita = []
    for i in range(sizes["lita"]):
        frames = os.path.join(media, f"video{i}")
        os.makedirs(frames, exist_ok=True)
        for j in range(sizes["frames"]):
            image(os.path.join(frames, f"{j:04d}.png"))
        dur = float(rng.integers(8, 30))
        cuts = sorted(float(x) for x in rng.uniform(0, dur, 4))
        lita.append({"video": frames, "duration": dur, "events": [
            {"start": cuts[0], "end": cuts[1], "caption": text(4)},
            {"start": cuts[2], "end": cuts[3], "caption": text(4)}]})
    vio.save(os.path.join(root, "lita.json"), lita)
    registry = {
        "corpus_interleaved": {"type": "interleaved", "max_images": 4,
                               "data_path": "${VILA_DATA_ROOT}/mmc4.json"},
        "corpus_pairs": {"type": "caption_pairs", "n_samples_per_idx": 2,
                         "data_path": "${VILA_DATA_ROOT}/pairs.json"},
        "corpus_wds": {"type": "webdataset", "shard_paths": pair_shards + sft_shards},
        "corpus_textocr": {"type": "textocr", "shards": ocr_shards},
        "corpus_lita": {"type": "lita", "data_path": "${VILA_DATA_ROOT}/lita.json"},
    }
    path = os.path.join(root, "corpus.yaml")
    vio.save(path, registry)
    return path, pair_shards + sft_shards + ocr_shards


def phase_train_data(torch, seed, dev="cuda", cfg=None, steps=3, seq=2048, fill=0.85,
                     sizes=CORPUS):
    """`Trainer` at full NVILA-Lite-2B width (LLM depth `TRAIN_LAYERS`, the
    f32 tree of `train_master`) on a mixture read from the port's registry:
    `write_corpus`, its entries added to the registry from their YAML file,
    `build_dataset(CORPUS_MIXTURE)`; each tar shard's native index against
    the Python index (names and bytes); `steps` steps of packed `seq`-token
    rows (exact K7-K9 launches, finite losses), each batch on the card bit
    for bit against the same mixture built afresh and collated on the CPU;
    then `loss_eval.loss` on the trained tree at `seq` (K7 once a layer),
    within `LOSS_EVAL_TOL` (relative) of the same call under
    `plain_versions`, and the last layer's output on its batch within
    `CONSISTENCY_TOL` x max|ref| of the plain versions'."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from vila_tpu_torch.cli.train import STAGE_PRESETS
    from vila_tpu_torch.data import builder
    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.data.tario import IndexedTar
    from vila_tpu_torch.eval import loss_eval
    from vila_tpu_torch.models import vlm
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer, _batch_iterator
    from vila_tpu_torch.utils import io as vio

    cfg = cfg or dataclasses.replace(nvila_lite_2b_config(layers=TRAIN_LAYERS),
                                     num_video_frames=TRAIN_DATA_FRAMES)
    layers = cfg.llm.num_hidden_layers
    dev = torch.device(dev)
    root = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    env_before = os.environ.get("VILA_DATA_ROOT")
    entries = {}
    ok = True
    try:
        t0 = time.perf_counter()
        reg_path, shards = write_corpus(root, seed, sizes)
        entries = vio.load(reg_path)
        os.environ["VILA_DATA_ROOT"] = root
        builder.DATASETS.update(entries)
        write_s = time.perf_counter() - t0
        same_index = []
        for p in shards:
            nat, py = IndexedTar(p), IndexedTar(p, force_python=True)
            same_index.append(nat.is_native and [(nat.name(i), nat.read(i)) for i in range(
                len(nat))] == [(py.name(i), py.read(i)) for i in range(len(py))])
            nat.close()
        ok &= all(same_index)
        tok = ByteTokenizer()

        def mixture():
            return builder.build_dataset(CORPUS_MIXTURE, tok, cfg)

        probe = mixture()
        lengths = [len(probe[i]["input_ids"]) for i in range(len(probe))]
        per_step = max(1, math.ceil(fill * seq / statistics.mean(lengths)))
        collator = PackingCollator(seq_len=seq, rows=1, pad_token_id=tok.pad_token_id,
                                   tile_size=cfg.vision.image_size)
        log(f"[train_data] corpus written and registered in {write_s:.2f} s: "
            f"{len(shards)} tar shards, native index equal to the Python index on "
            f"{sum(same_index)} of {len(shards)}; mixture {CORPUS_MIXTURE!r}: "
            f"{len(probe)} samples, {[len(d) for d in probe.datasets]} a part, lengths "
            f"{min(lengths)}-{max(lengths)} (mean {statistics.mean(lengths):.1f}); "
            f"{per_step} samples a {seq}-token row")
        params = train_master(torch, seed, dev, cfg)
        args = TrainArgs(output_dir=os.path.join(root, "run"), max_steps=steps,
                         per_device_batch_size=per_step, seq_len=seq, pack_rows=1,
                         logging_steps=1, save_steps=steps + 1, seed=seed,
                         **STAGE_PRESETS["sft"])
        trainer = Trainer(cfg, params, mixture(), collator, args, device=dev)
        trainer._save = lambda step: None  # the `train` phase times and checks saves
        seen = []
        put = trainer._put
        trainer._put = lambda batch: seen.append(put(batch)) or seen[-1]
        _build.reset_launches()
        t1 = time.perf_counter()
        hist = trainer.train()["log_history"]
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
        want = dict(_no_launches(), **want_flash(steps, steps, layers),
                    **want_ce(steps, seq - 1, cfg.llm.vocab_size))
        ref = _batch_iterator(mixture(), collator, per_step, seed)
        equal = []
        for got in seen:
            host = next(ref)
            equal.append(sorted(got) == sorted(host) and all(
                got[k].dtype == torch.as_tensor(host[k]).dtype
                and np.array_equal(got[k].cpu().numpy(), host[k]) for k in host))
        fills = [float((b["segment_ids"] > 0).float().mean()) for b in seen]
        good = (launches == want and len(hist) == steps and all(equal) and len(equal) == steps
                and _finite(hist, ("loss", "grad_norm")))
        ok &= good
        for h, f in zip(hist, fills):
            log(f"[train_data] step {h['step']}: loss {h['loss']:.4f} grad_norm "
                f"{h['grad_norm']:.4f}, row fill {100 * f:.1f}%")
        log(f"[train_data] {steps} steps in {train_s:.2f} s (set-up and the first step's "
            f"warm-up included); launches {launches} (expected {want}); each batch on the "
            f"card against the mixture collated afresh on the CPU: {equal} "
            f"{'OK' if good else 'FAIL'}")
        _build.reset_launches()
        t2 = time.perf_counter()
        loss_k, n_k = loss_eval.loss(trainer.params, cfg, seq, dev)
        eval_s = time.perf_counter() - t2
        eval_launches = dict(_build.LAUNCHES)
        with plain_versions():
            loss_p, n_p = loss_eval.loss(trainer.params, cfg, seq, dev)
        rel = _rel_diff(loss_k, loss_p)
        # the last layer's output on loss_eval's batch, through K7 and its
        # plain version: the loss alone sits near ln V whatever attention does
        batch = loss_eval.fixed_batch(cfg, seq, dev)
        with torch.no_grad():
            h_k = vlm.forward_batch(trainer.params, cfg, batch, return_hidden=True)
            with plain_versions():
                h_p = vlm.forward_batch(trainer.params, cfg, batch, return_hidden=True)
        gap = float((h_k.float() - h_p.float()).abs().max() / h_p.float().abs().max())
        want_eval = dict(_no_launches(), flash_fwd=layers)
        good = (eval_launches == want_eval and n_k == n_p and math.isfinite(loss_k)
                and rel <= LOSS_EVAL_TOL and gap <= CONSISTENCY_TOL)
        ok &= good
        log(f"[train_data] loss_eval on the trained tree at seq {seq}: {loss_k:.6f} over {n_k} "
            f"tokens in {eval_s:.2f} s, plain versions {loss_p:.6f} (rel {rel:.2e}, limit "
            f"{LOSS_EVAL_TOL:g}); the last layer's output max|d| / max|ref| against the plain "
            f"versions {gap:.2e} (limit {CONSISTENCY_TOL:g}); launches {eval_launches} "
            f"(expected {want_eval}) {'OK' if good else 'FAIL'}")
        del h_k, h_p
        del trainer, params, seen
    finally:
        for name in entries:
            builder.DATASETS.pop(name, None)
        if env_before is None:
            os.environ.pop("VILA_DATA_ROOT", None)
        else:
            os.environ["VILA_DATA_ROOT"] = env_before
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    summary = dict(shards=len(shards), native_index_equal=same_index, samples=len(probe),
                   samples_per_step=per_step, steps=[dict(h, row_fill=f) for h, f in zip(
                       hist, fills)], batches_equal_cpu=equal, train_s=train_s,
                   loss_eval=dict(loss=loss_k, plain=loss_p, rel=rel, hidden_gap=gap,
                                  n_tokens=n_k,
                                  seconds=eval_s, launches=eval_launches),
                   seconds=time.perf_counter() - t0)
    return ok, summary, {"train_data": launches, "train_data loss_eval": eval_launches}


# --------------------------------------------------------------------------
# LongVILA's long-context stack (MM-SP ring steps, context extension, the
# sequence-sharded engine, NIAH) at Qwen2-7B width
# --------------------------------------------------------------------------

RING_HEADS = (28, 4)  # Qwen2-7B's attention: 28 query and 4 KV heads of 128
RING_SEQ = 32768
RING_RANKS = 4  # virtual ranks of the ring, driven in one process
EXTEND_SEQ = 32768  # half of the 64k recipe's sequence
EXTEND_STEPS = 2
LONG_CTX = dict(max_cache_len=65536, prefill_chunk=4096, prompt=32768, new_tokens=16)
PARAM_SPECS_TOKENS = 8  # the long_ctx engine with param_specs against the replicated one
NIAH_CONTEXTS = (8192, 32768)
NIAH_DEPTHS = (0.0, 0.5, 1.0)


def one_rank_mesh(torch, dev):
    """A process group of this one rank (NCCL on the card, gloo on the
    CPU, 127.0.0.1 and a free port) and its (1, 1, 1) mesh, opened once:
    the long-context phases run the code the CPU tests run over gloo."""
    import socket

    import torch.distributed as dist

    from vila_tpu_torch.parallel import distributed, mesh as mesh_lib

    if not dist.is_initialized():
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        distributed.init_distributed(f"tcp://127.0.0.1:{port}", 1, 0,
                                     backend="nccl" if dev.type == "cuda" else "gloo")
    return mesh_lib.make_mesh()


def qwen2_7b_config(layers=28, dtype="bfloat16", **over):
    """Qwen2-7B's published widths (Qwen/Qwen2-7B config.json: hidden
    3584, intermediate 18944, 28 layers, 28 query and 4 KV heads of 128,
    vocab 152064, untied lm_head), bf16."""
    from vila_tpu_torch.models import qwen2

    kw = dict(vocab_size=152064, hidden_size=3584, intermediate_size=18944,
              num_hidden_layers=layers, num_attention_heads=28, num_key_value_heads=4,
              rope_theta=1e6, tie_word_embeddings=False, dtype=dtype)
    kw.update(over)
    return qwen2.LLMConfig(**kw)


def ring_segments(torch, s, dev):
    """Three packed segments of 45 %, 35 % and 20 % of the sequence."""
    a, b = int(0.45 * s), int(0.8 * s)
    seg = torch.ones((1, s), dtype=torch.int32, device=dev)
    seg[:, a:b] = 2
    seg[:, b:] = 3
    return seg


def _by_group(fn, hq, hkv):
    """fn(query head slice, KV head slice) for each KV head group: a plain
    version run one group at a time (its score tensors at 1 / hkv of the
    memory)."""
    g = hq // hkv
    return [fn(slice(j * g, (j + 1) * g), slice(j, j + 1)) for j in range(hkv)]


def phase_sp_ring(torch, seed, dev="cuda", heads=RING_HEADS, seq=RING_SEQ, n=RING_RANKS):
    """The ring's steps at Qwen2-7B attention widths, bf16, S `seq` with
    three packed segments, for `n` virtual ranks in one process: the port's
    `_ring_step_fwd`, `_merge` and `_ring_step_bwd` for every (my, src)
    pair, the rotation by list indexing (P2P is held on the CPU over
    gloo), in the contiguous and the zigzag layouts. The merged output,
    LSE and gradients are held against one K7 / K8 / K9 call over the whole
    sequence (K7's and K9's bars: 1e-2 x max|ref| on bf16, 1e-3 on the
    LSE); each step kind's K7 / K8 / K9 against its plain version (one KV
    head group at a time), timed beside it and SDPA on the same block; the
    step kernels' ms summed over the ring against the single call's."""
    import torch.nn.functional as F

    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.ops import flash_attention as fa
    from vila_tpu_torch.parallel import ring_attention as ra

    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    hq, hkv = heads
    d = fa.HEAD_DIM
    scale = d ** -0.5
    bf16 = torch.bfloat16
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev).to(bf16)  # noqa: E731
    q, k, v, do = rnd(1, seq, hq, d), rnd(1, seq, hkv, d), rnd(1, seq, hkv, d), rnd(1, seq, hq, d)
    seg = ring_segments(torch, seq, dev)
    kw = dict(causal=True, scale=scale)
    # the single calls over the whole sequence: the ring's reference
    out1, lse1 = fa.flash_fwd(q, k, v, seg, seg, **kw)
    delta1 = (do.float() * out1.float()).sum(-1).transpose(1, 2).contiguous()
    dq1 = fa.flash_bwd_dq(q, k, v, do, lse1, delta1, seg, seg, **kw)
    dk1, dv1 = fa.flash_bwd_dkv(q, k, v, do, lse1, delta1, seg, seg, **kw)
    single = {
        "flash_fwd": time_ms(torch, lambda: fa.flash_fwd(q, k, v, seg, seg, **kw), 10, flush),
        "flash_bwd_dq": time_ms(torch, lambda: fa.flash_bwd_dq(
            q, k, v, do, lse1, delta1, seg, seg, **kw), 10, flush),
        "flash_bwd_dkv": time_ms(torch, lambda: fa.flash_bwd_dkv(
            q, k, v, do, lse1, delta1, seg, seg, **kw), 10, flush)}
    sl = seq // n
    ok = True
    summary, launches, results = {"single_ms": single}, {}, {name: [] for name in FLASH_KERNELS}
    for layout in ("contiguous", "zigzag"):
        order = torch.as_tensor(ra.zigzag_order(seq, n) if layout == "zigzag"
                                else list(range(seq)), device=dev)
        part = lambda x: [x[:, order][:, r * sl:(r + 1) * sl].contiguous()  # noqa: E731
                          for r in range(n)]
        qs, ks, vs, dos, ss = part(q), part(k), part(v), part(do), part(seg)
        step_kw = dict(causal=True, impl="flash", layout=layout)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs, lses = [], []
        for my in range(n):
            out = torch.zeros((1, sl, hq, d), dtype=torch.float32, device=dev)
            lse = torch.full((1, hq, sl), ra._NEG_INF, dtype=torch.float32, device=dev)
            for step in range(n):
                src = (my - step) % n
                o, l = ra._ring_step_fwd(qs[my], ks[src], vs[src], ss[my], ss[src], src=src,
                                         my=my, **step_kw)
                out, lse = ra._merge(out, lse, o, l)
            outs.append(out)
            lses.append(lse)
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in qs]
        dk = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in ks]
        dv = [torch.zeros(x.shape, dtype=torch.float32, device=dev) for x in vs]
        deltas = []
        for my in range(n):  # the ring's backward: O rounded to bf16, as the ring saves it
            deltas.append((dos[my].float() * outs[my].to(bf16).float()).sum(-1)
                          .transpose(1, 2).contiguous())
            for src in range(n):
                a, b_, c = ra._ring_step_bwd(qs[my], ks[src], vs[src], dos[my], lses[my],
                                             deltas[my], ss[my], ss[src], src=src, my=my,
                                             **step_kw)
                dq[my] += a
                dk[src] += b_
                dv[src] += c
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"sp_ring {layout}"] = counts = dict(_build.LAUNCHES)
        steps = n * n if layout == "zigzag" else n * (n + 1) // 2
        want = dict(_no_launches(), **{name: steps for name in FLASH_KERNELS})
        inv = torch.empty_like(order)
        inv[order] = torch.arange(seq, device=dev)
        back = lambda xs, dim=1: torch.cat(xs, dim)[:, inv] if dim == 1 else \
            torch.cat(xs, dim)[:, :, inv]  # noqa: E731
        errs = {}
        for tag, got, ref, tol in (
                ("out", back(outs), out1, 1e-2), ("lse", back(lses, 2), lse1, None),
                ("dq", back(dq), dq1, 1e-2), ("dk", back(dk), dk1, 1e-2),
                ("dv", back(dv), dv1, 1e-2)):
            err, sc = rel_err(torch, got, ref)
            errs[tag] = err
            ok &= bool(torch.isfinite(got).all()) and err <= (1e-3 if tol is None else tol * sc)
        ok &= counts == want
        def step_kind(my, src):
            if src == my:
                return "diag"
            if layout == "zigzag":
                return "earlier" if src < my else "later"
            return "full" if src < my else None  # None: the step launches nothing

        def step_inputs(my, src):
            """(q, k, v, dO, lse, delta, q seg, kv seg) as the step hands them
            to the kernels."""
            kind, h = step_kind(my, src), sl // 2
            qq, kk, vv, dd = qs[my], ks[src], vs[src], dos[my]
            qseg, kseg, ll, de = ss[my], ss[src], lses[my], deltas[my]
            if kind == "earlier":
                kk, vv, kseg = kk[:, :h], vv[:, :h], kseg[:, :h]
            if kind == "later":
                qq, dd, qseg = qq[:, h:], dd[:, h:], qseg[:, h:]
                ll, de = ll[:, :, h:], de[:, :, h:]
            return tuple(x.contiguous() for x in (qq, kk, vv, dd, ll, de, qseg, kseg))

        # every step's kernels timed, summed over the ring
        step_sum = {name: 0.0 for name in FLASH_KERNELS}
        count_of = {}
        for my in range(n):
            for src in range(n):
                kind = step_kind(my, src)
                if kind is None:
                    continue
                count_of[kind] = count_of.get(kind, 0) + 1
                qq, kk, vv, dd, ll, de, qseg, kseg = step_inputs(my, src)
                kkw = dict(causal=kind == "diag", scale=scale)
                bwd = (qq, kk, vv, dd, ll, de, qseg, kseg)
                for name, fn in (
                        ("flash_fwd", lambda: fa.flash_fwd(qq, kk, vv, qseg, kseg, **kkw)),
                        ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*bwd, **kkw)),
                        ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*bwd, **kkw))):
                    step_sum[name] += time_ms(torch, fn, 5, flush)
        # each step kind once (ranks 1 and 2): against its plain version, SDPA
        kinds = {"diag": (1, 1), "later": (1, 2)} if layout == "zigzag" else {"diag": (1, 1)}
        kinds[("earlier" if layout == "zigzag" else "full")] = (2, 1)
        for kind, (my, src) in kinds.items():
            qq, kk, vv, dd, ll, de, qseg, kseg = step_inputs(my, src)
            causal = kind == "diag"
            kkw = dict(causal=causal, scale=scale)
            bwd = (qq, kk, vv, dd, ll, de, qseg, kseg)

            def plain(fn, with_grad):
                def one(qs_, ks_):
                    args = (qq[:, :, qs_], kk[:, :, ks_], vv[:, :, ks_])
                    if with_grad:
                        args += (dd[:, :, qs_], ll[:, qs_], de[:, qs_])
                    return fn(*args, qseg, kseg, **kkw)
                return lambda: _by_group(one, hq, hkv)

            cases = {
                "flash_fwd": (lambda: fa.flash_fwd(qq, kk, vv, qseg, kseg, **kkw),
                              plain(fa.flash_fwd_plain, False), 2),
                "flash_bwd_dq": (lambda: fa.flash_bwd_dq(*bwd, **kkw),
                                 plain(fa.flash_bwd_dq_plain, True), 3),
                "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(*bwd, **kkw),
                                  plain(fa.flash_bwd_dkv_plain, True), 4),
            }
            qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (qq, kk, vv, dd))
            qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
            out_g = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                   enable_gqa=True)
            t_sdpa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 10, flush)
            t_sdpa_bwd = time_ms(torch, lambda: torch.autograd.grad(
                out_g, (qg, kg, vg), dot, retain_graph=True), 10, flush)
            mask = fa._mask(1, qq.shape[1], kk.shape[1], causal, qseg, kseg, dev)
            pairs = int(mask.sum())
            del mask
            in_bytes = 2 * (qq.numel() + kk.numel() + vv.numel()) + 4 * (qseg.numel()
                                                                        + kseg.numel())
            for name, (fn, ref, products) in cases.items():
                got = fn()
                got = got if isinstance(got, tuple) else (got,)
                groups = ref()
                if name == "flash_fwd":
                    want_t = (torch.cat([g[0] for g in groups], 2), torch.cat(
                        [g[1] for g in groups], 1))
                elif name == "flash_bwd_dq":
                    want_t = (torch.cat(groups, 2),)
                else:
                    want_t = (torch.cat([g[0] for g in groups], 2),
                              torch.cat([g[1] for g in groups], 2))
                del groups
                torch.cuda.synchronize()
                good, kerrs = True, []
                for g, w in zip(got, want_t):
                    err, sc = rel_err(torch, g, w)
                    tol = 1e-3 if g.dtype == torch.float32 else 1e-2 * sc
                    good &= bool(torch.isfinite(g.float()).all()) and err <= tol
                    kerrs.append(err)
                del want_t
                ok &= good
                t = time_ms(torch, fn, 10, flush)
                t_plain = time_ms(torch, ref, 1, flush)
                out_bytes = sum(g.numel() * g.element_size() for g in got)
                extra = 0 if name == "flash_fwd" else 2 * dd.numel() + 8 * qq.shape[2] * qq.shape[1]
                b_ms, b_by = bound(in_bytes + extra + out_bytes, products * 2 * hq * d * pairs,
                                   BF16_FLOPS)
                results[name].append(dict(
                    shape=f"B 1, Sq {qq.shape[1]}, Skv {kk.shape[1]}, {hq}/{hkv} heads of {d}, "
                          f"{'causal' if causal else 'not causal'}, ring {layout} {kind} (ranks {my}, {src})",
                    m=qq.shape[1], main=False, ring=f"{layout} {kind} (ranks {my}, {src})",
                    steps=count_of[kind],
                    max_abs_err=max(kerrs), ok=good, ms=t, plain_ms=t_plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=t_sdpa if name == "flash_fwd" else t_sdpa_bwd,
                    library=("sdpa forward" if name == "flash_fwd" else "sdpa backward")
                            + (", causal" if causal else ", not causal"),
                    allowed_pairs=pairs))
                log(f"[sp_ring] {layout:10s} {kind:7s} {name:13s} Sq {qq.shape[1]} Skv "
                    f"{kk.shape[1]} (ranks {my}, {src}): err {max(kerrs):.3e} "
                    f"{'OK' if good else 'FAIL'}  kernel {t:.4f} ms  plain {t_plain:.2f} ms  sdpa "
                    f"{results[name][-1]['library_ms']:.4f} ms  bound {b_ms:.4f} ms ({b_by}); "
                    f"{count_of[kind]} steps of this kind")
            del out_g, qg, kg, vg
        summary[layout] = dict(errors=errs, launches=counts, expected=want, wall_s=wall,
                               step_kernel_ms=step_sum)
        log(f"[sp_ring] {layout}: {n} virtual ranks of {sl} tokens; merged against the single "
            f"call: " + ", ".join(f"{t} {e:.3e}" for t, e in errs.items())
            + f"; launches {counts} (expected {want}); ring wall {wall:.2f} s; step kernels "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in step_sum.items())
            + " against the single call " + ", ".join(f"{k} {v:.3f} ms" for k, v in single.items()))
        del outs, lses, dq, dk, dv, qs, ks, vs, dos, ss, deltas
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[sp_ring] -> {'OK' if ok else 'FAIL'}")
    return ok, summary, launches, results


def _extend_draw(torch, cfg, seed, dev):
    from vila_tpu_torch.models import qwen2

    return qwen2.init_params(torch.Generator(device=dev).manual_seed(seed), cfg, torch.bfloat16)


def phase_extend(torch, seed, base=None, dev="cuda", seq=EXTEND_SEQ, steps=EXTEND_STEPS,
                 cfg=None, check_cfg=None, check_seq=1024):
    """LongVILA stage 4 on one card: `context_extend.extend_llm` over a
    seeded bf16 Qwen2-7B (rope_theta 15.3e6, LoRA rank 16 on the seven
    projections, remat, CE chunk 1024), `steps` steps of one `seq`-token
    row of random text. Reports each step's wall, the peak memory and the
    K7-K9 launches (28 a layer and step for K8 / K9, twice that for K7:
    remat recomputes each layer's forward); the losses finite. Then the
    first loss (the base model's: B = 0) of a 2-layer cut at S `check_seq`
    on the card against the same tree in f32 on the CPU (within 1e-2)."""
    import dataclasses

    import numpy as np

    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import context_extend as ce
    from vila_tpu_torch.train import lora as lora_lib

    dev = torch.device(dev)
    cfg = cfg or qwen2_7b_config()
    layers = cfg.num_hidden_layers
    args = ce.ContextExtendArgs(target_context=65536, seq_len=seq, steps=steps)
    rng = np.random.default_rng(seed)
    rows = [rng.integers(0, cfg.vocab_size, (1, seq)).astype(np.int32) for _ in range(steps)]
    base = base if base is not None else _extend_draw(torch, cfg, seed, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []

    def timed_rows():
        for r in rows:
            torch.cuda.synchronize()
            walls.append(time.perf_counter())
            yield r

    _build.reset_launches()
    merged, ext_cfg, losses = ce.extend_llm(base, cfg, timed_rows(), args, seed=seed)
    torch.cuda.synchronize()
    walls.append(time.perf_counter())
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del merged
    gc.collect()
    torch.cuda.empty_cache()
    step_s = [b - a for a, b in zip(walls, walls[1:])]
    want = dict(_no_launches(), flash_fwd=2 * steps * layers, flash_bwd_dq=steps * layers,
                flash_bwd_dkv=steps * layers,
                **want_ce(steps, seq, cfg.vocab_size, chunk=args.ce_chunk_size))
    ok = all(math.isfinite(x) for x in losses) and launches == want
    log(f"[extend] Qwen2-7B bf16, {layers} layers, LoRA rank 16, remat, rope_theta "
        f"{ext_cfg.rope_theta:g}, {steps} steps of {seq} tokens: losses {losses}; step wall "
        + ", ".join(f"{s:.2f}" for s in step_s) + f" s; {seq / step_s[-1]:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB; launches {launches} (expected {want})")
    summary = dict(config=f"Qwen2-7B bf16 {layers} layers", seq=seq, losses=losses,
                   step_s=step_s, peak_bytes=peak, launches=launches)

    # the first loss of a 2-layer cut, card against the CPU
    small = check_cfg or qwen2_7b_config(layers=2)
    tree = _extend_draw(torch, small, seed + 1, dev)
    ids = rng.integers(0, small.vocab_size, (1, check_seq)).astype(np.int32)
    lcfg = lora_lib.LoRAConfig(rank=16, alpha=32.0)
    vals = {}
    for tag, d, dtype in (("card", dev, small.dtype), ("cpu", torch.device("cpu"), "float32")):
        p = tree if tag == "card" else copy_tree(tree, d)
        if tag == "cpu":
            p = {k: v for k, v in _float_tree(torch, p).items()}
        c = ce.extended_config(dataclasses.replace(small, dtype=dtype), args)
        lo = lora_lib.init_lora(torch.Generator(device=d).manual_seed(seed), p, lcfg)
        arrs = [torch.as_tensor(x).to(d) for x in ce.host_chunk(ids)]
        with torch.no_grad():
            loss, _ = ce.extend_loss(lo, {"llm": p}, lcfg, c, *arrs,
                                     ce_chunk_size=args.ce_chunk_size)
        vals[tag] = float(loss)
    rel = abs(vals["card"] - vals["cpu"]) / abs(vals["cpu"])
    good = math.isfinite(vals["card"]) and rel <= 1e-2
    log(f"[extend] 2-layer first loss at S {check_seq}: card (bf16) {vals['card']:.6f}, CPU "
        f"(f32) {vals['cpu']:.6f}, rel {rel:.2e} (limit 1e-2) -> {'OK' if ok and good else 'FAIL'}")
    summary["first_loss_check"] = dict(card=vals["card"], cpu=vals["cpu"], rel=rel)
    del tree
    gc.collect()
    torch.cuda.empty_cache()
    return ok and good, summary, {"extend": launches}


def _float_tree(torch, tree):
    return {k: (_float_tree(torch, v) if isinstance(v, dict) else v.float())
            for k, v in tree.items()}


def phase_long_ctx(torch, seed, dev="cuda", cfg=None, run=None):
    """`LongContextEngine` on a one-rank mesh over the seeded W4 NVILA-8B
    LLM (`bench.py:30-48`): max_cache_len 65536, prefill chunks of 4096, a
    32768-token prompt of embeddings, 16 greedy tokens. Prefill runs K2 at
    M = 4096 on every projection and K1 on the lm_head's last row; decode K1
    at M = 1 on every projection (no K3 in the deferred mode); the launches
    are held to those counts. Held against the port's serial `qwen2.forward`
    cache path on the same weights: the first logits within 5e-2 x max|ref|
    and each token, fed to the serial path, within K1's tie band (2^-7
    max|logit|) of its top. Reports TTFT, decode tokens/s and peak memory.
    Then the engine built with `param_specs` (the JAX package's
    `llm_param_specs`: on a W4 tree only the dense embedding has a spec, and
    on one rank nothing splits) and the replicated engine over a one-chunk
    prompt: the same tokens."""
    from vila_tpu_torch.inference.long_context import LongContextEngine
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.parallel.mesh import llm_param_specs

    dev = torch.device(dev)
    run = dict(LONG_CTX, **(run or {}))
    lcfg = cfg or nvila_8b_config().llm
    layers = lcfg.num_hidden_layers
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = synth_llm_params(torch, lcfg, gen, dev)
    embeds = (0.02 * torch.randn((1, run["prompt"], lcfg.hidden_size), generator=gen,
                                 device=dev)).to(torch.bfloat16)
    mesh = one_rank_mesh(torch, dev)
    eng = LongContextEngine(params, lcfg, mesh, max_cache_len=run["max_cache_len"],
                            prefill_chunk=run["prefill_chunk"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    logits, cache, s = eng.prefill(embeds)
    first_logits = logits.float()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = eng.decode(logits, cache, s, run["new_tokens"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del cache
    gc.collect()
    torch.cuda.empty_cache()
    chunks = -(-run["prompt"] // run["prefill_chunk"])
    want = dict(_no_launches(), w4_gemm=chunks * 4 * layers,
                w4_gemv=chunks + (len(toks) - 1) * (4 * layers + 1))
    # the serial path: qwen2.forward over one cache, chunk by chunk, then the
    # engine's tokens fed one at a time (bs=1: the fused K3 route)
    cache = qwen2.init_cache(lcfg, batch=1, max_len=run["max_cache_len"], device=dev)
    with torch.no_grad():
        c = run["prefill_chunk"]
        for start in range(0, s, c):
            chunk = embeds[:, start:start + c]
            ref, cache = qwen2.forward(params, lcfg, inputs_embeds=chunk, cache=cache,
                                       last_token_only=True)
        rows = [ref[0, -1].float()]
        for t in toks[:-1]:
            ref, cache = qwen2.forward(params, lcfg, input_ids=torch.tensor([[t]], device=dev),
                                       cache=cache)
            rows.append(ref[0, -1].float())
    del cache
    err, sc = rel_err(torch, first_logits[0], rows[0])
    margins = [float(r.max() - r[t]) for r, t in zip(rows, toks)]
    bands = [K1_BAND * float(r.abs().max()) for r in rows]
    exact = sum(int(r.argmax()) == t for r, t in zip(rows, toks))
    ok = (err <= CONSISTENCY_TOL * sc and len(toks) == run["new_tokens"]
          and all(m <= b for m, b in zip(margins, bands)) and launches == want)
    # the engine with `param_specs` against the replicated one, a one-chunk prompt
    short = embeds[:, :run["prefill_chunk"]]
    eng_specs = LongContextEngine(params, lcfg, mesh, max_cache_len=run["max_cache_len"],
                                  prefill_chunk=run["prefill_chunk"],
                                  param_specs=llm_param_specs(lcfg, mesh))
    spec_toks = [e.generate(short, PARAM_SPECS_TOKENS) for e in (eng, eng_specs)]
    same_specs = spec_toks[0] == spec_toks[1] and len(spec_toks[0]) == PARAM_SPECS_TOKENS
    ok = ok and same_specs
    del eng_specs
    ttft = t1 - t0
    tok_s = (len(toks) - 1) / (t2 - t1)
    log(f"[long_ctx] NVILA-8B W4 LLM ({layers} layers), cache {run['max_cache_len']} on one "
        f"rank, prompt {s} in chunks of {run['prefill_chunk']}: TTFT {ttft:.2f} s, decode "
        f"{tok_s:.2f} tok/s ({len(toks)} tokens), peak {peak / 2**30:.2f} GiB; first logits "
        f"against the serial path {err:.3e} of max {sc:.3g}; tokens exact {exact}/{len(toks)}, "
        f"largest margin {max(margins):.4g} (band {min(bands):.4g}); launches {launches} "
        f"(expected {want}); with param_specs over {short.shape[1]} tokens the replicated "
        f"engine's {PARAM_SPECS_TOKENS} tokens {same_specs} -> {'OK' if ok else 'FAIL'}")
    summary = dict(prompt=s, ttft_s=ttft, decode_tok_s=tok_s, tokens=toks, peak_bytes=peak,
                   first_logits_err=err, first_logits_max=sc, exact=exact, margins=margins,
                   launches=launches, expected=want, param_specs_tokens=spec_toks,
                   param_specs_same=same_specs)
    del params, eng, embeds
    gc.collect()
    torch.cuda.empty_cache()
    return ok, summary, {"long_ctx": launches}


def phase_niah(torch, seed, base=None, dev="cuda", cfg=None, contexts=NIAH_CONTEXTS,
               depths=NIAH_DEPTHS):
    """`niah.run_niah` over a seeded bf16 Qwen2-7B on the one-rank mesh:
    contexts x depths, a haystack of embedded random tokens, an 8-token
    needle and a 4-token answer (random weights: the accuracy is reported
    and judged by nothing). Each forward's ms; K7 launches (28 a forward,
    no backward). At the first context, every K7 call of the 28-layer
    `forward_embeds_sharded` against its plain version on the same inputs
    (`tap_flash`: within 1e-2 x max|ref|, the LSE within 1e-3): each layer
    judged on its own inputs, so the bar holds at full depth."""
    import numpy as np

    from vila_tpu_torch.eval import niah
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.ops import _build

    dev = torch.device(dev)
    cfg = cfg or qwen2_7b_config()
    p = base if base is not None else _extend_draw(torch, cfg, seed, dev)
    mesh = one_rank_mesh(torch, dev)
    rng = np.random.default_rng(seed)
    emb = lambda n: qwen2.embed_tokens(p, cfg, torch.as_tensor(  # noqa: E731
        rng.integers(0, cfg.vocab_size, (1, n)), device=dev))[0]
    haystack, needle = emb(max(contexts)), emb(8)
    answers = rng.integers(0, cfg.vocab_size, 4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    timings = []
    grid = niah.run_niah(p, cfg, haystack, needle, answers,
                         niah.NIAHConfig(context_lengths=contexts, depths=depths), mesh=mesh,
                         timings=timings)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict(_no_launches(), flash_fwd=len(grid) * cfg.num_hidden_layers)
    # every K7 call of the 28-layer forward at the first context against its
    # plain version on the same inputs (the layers' own inputs: the bar holds
    # at full depth, where the two sides' summation orders part the logits)
    full = torch.cat([haystack[:contexts[0] - 8], needle])[None]
    with torch.no_grad(), tap_flash(torch) as tap:
        niah.forward_embeds_sharded(p, cfg, full, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    calls = tap.calls
    worst = max(calls, key=lambda c: c["max_abs_err"]) if calls else None
    ok = (launches == want and tap.ok() and len(calls) == cfg.num_hidden_layers
          and len(grid) == len(contexts) * len(depths))
    log(f"[niah] Qwen2-7B bf16 ({cfg.num_hidden_layers} layers), contexts {contexts} x depths "
        f"{depths}: " + "; ".join(f"{c} @ {d:.1f}: {1e3 * t:.1f} ms" for c, d, t in timings)
        + f"; accuracy (random weights) {[r['acc'] for r in grid]}; peak {peak / 2**30:.2f} "
        f"GiB; at {contexts[0]} every K7 call against its plain version: "
        f"{sum(c['ok'] for c in calls)}/{len(calls)} within the bars (worst "
        f"{worst['max_abs_err'] if worst else float('nan'):.3e}); launches {launches} "
        f"(expected {want}) -> {'OK' if ok else 'FAIL'}")
    summary = dict(grid=grid, forward_ms={f"{c}@{d}": 1e3 * t for c, d, t in timings},
                   peak_bytes=peak, launches=launches, k7_calls=calls)
    return ok, summary, {"niah": launches}


# --------------------------------------------------------------------------
# Tensor parallelism on the (dp, sp, su, tp) mesh, and the sharded step's
# other optimizers and PS3
# --------------------------------------------------------------------------

TP_RANKS = 2  # NVILA-Lite-2B's tp ranks, two processes sharing the card
TP_LAYERS = 4  # their LLM depth
# their tower depth: each rank process holds a one-device reference step
# beside its own, and two full-depth towers' activations overflow the card
TP_VISION_LAYERS = 6
TP_SEQ = 2048
# K7-K9 at a tp rank's heads: (query heads, KV heads, the configuration)
TP_RANK_HEADS = ((6, 1, "NVILA-Lite-2B at tp 2"), (7, 1, "Qwen2-7B at tp 4"))
TP_TIMEOUT_S = 300
# part (a)'s step runs as it is and with the decoder layers rematerialised
TP_REMAT = (False, True)


class tap_flash:
    """While active, K7, K8 and K9 (`flash_attention.flash_fwd`,
    `flash_bwd_dq`, `flash_bwd_dkv`, whatever they are on entry) are
    wrapped: every call also runs its plain version on the same inputs and
    is judged with `train_kernels`' bars (bf16 outputs within 1e-2 x
    max|ref|, the f32 LSE within 1e-3). `calls` holds (kernel, heads,
    Sq, largest |d| over the outputs, ok) per call."""

    def __init__(self, torch):
        self.torch, self.calls = torch, []

    def __enter__(self):
        from vila_tpu_torch.ops import flash_attention as fa

        self.fa = fa
        self.saved = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)
        plains = (fa.flash_fwd_plain, fa.flash_bwd_dq_plain, fa.flash_bwd_dkv_plain)

        def wrap(name, kernel, plain):
            def fn(*args, **kw):
                got = kernel(*args, **kw)
                self._judge(name, args, got, plain(*args, **kw))
                return got
            return fn

        fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv = (
            wrap(n, k, p) for n, k, p in zip(FLASH_KERNELS, self.saved, plains))
        return self

    def _judge(self, name, args, got, want):
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        ok, errs = True, []
        for g, w in zip(got, want):
            err, sc = rel_err(torch, g, w)
            tol = 1e-3 if g.dtype == torch.float32 else 1e-2 * sc
            ok &= bool(torch.isfinite(g.float()).all()) and err <= tol
            errs.append(err)
        self.calls.append(dict(kernel=name, heads=(args[0].shape[2], args[1].shape[2]),
                               sq=args[0].shape[1], max_abs_err=max(errs), ok=ok))

    def __exit__(self, *exc):
        self.fa.flash_fwd, self.fa.flash_bwd_dq, self.fa.flash_bwd_dkv = self.saved
        return False

    def ok(self):
        return bool(self.calls) and all(c["ok"] for c in self.calls)


class KeepGrads:
    """A tree optimizer for `make_sharded_train_step` that leaves the shards
    as they are and returns, as its state, each shard's gradient in
    `leaves` order: the step's gradients, read after its own
    reductions."""

    def init(self, params, layouts=None):
        return []

    def update(self, opt_state, params):
        from vila_tpu_torch.train.optimizer import leaves

        return [t.grad.detach().clone() for t in leaves(params)]


def leaf_paths(tree, path=()):
    """The path of every tensor of a tree, in `leaves` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in leaf_paths(v, path + (i,))]
    return [path]


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tp_rank(rank, world, port, out_path, seed, layers, seq, dev="cuda", cfg=None):
    """One tensor-parallel rank of the `tp` phase's part (a), a process of
    its own on the shared card (gloo carries the CUDA tensors of the tp
    all-reduces and all-gathers): the one-device loss and gradients on the
    card first (the reference), then one step of the port's
    `make_sharded_train_step` on the (1, 1, 1, world) mesh with `KeepGrads`
    as its optimizer for each `TP_REMAT` setting of the LLM's remat, every
    K7-K9 call held against its plain version; writes the reference's loss
    and grad norm, each run's loss, grad norm, gradient shards' gaps
    against the reference's slices and calls, and the launches of both
    runs to `out_path` (JSON)."""
    import dataclasses
    import traceback

    try:
        import torch
        import torch.distributed as dist

        from vila_tpu_torch.ops import _build
        from vila_tpu_torch.parallel import distributed, mesh as mesh_lib
        from vila_tpu_torch.train.optimizer import global_norm, leaves
        from vila_tpu_torch.train.step import loss_fn, make_sharded_train_step

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev = torch.device(dev)
        card = dev.type == "cuda"
        sync = torch.cuda.synchronize if card else (lambda: None)
        if card:
            torch.cuda.set_device(0)
        distributed.init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
        mesh = mesh_lib.make_mesh(tp=world, device_type="cpu")
        cfg = cfg or nvila_lite_2b_config(layers=layers, vision_layers=TP_VISION_LAYERS)
        params = train_master(torch, seed, dev, cfg)
        batch, _ = _sft_batch(torch, cfg, seq, dev)
        ts = leaves(params)
        for t in ts:
            t.requires_grad_(True)
        loss_ref, _ = loss_fn(params, cfg, batch)
        loss_ref.backward()
        # a leaf the forward leaves unused (the last tower layer): 0, as the step's
        ref = [t.grad if t.grad is not None else torch.zeros_like(t) for t in ts]
        norm_ref = global_norm(ref).item()
        for t in ts:
            t.grad = None

        def detached(tree):
            if isinstance(tree, dict):
                return {k: detached(v) for k, v in tree.items()}
            return tree.detach()

        runs = []
        _build.reset_launches()
        for remat in TP_REMAT:
            rcfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, remat=remat))
            step, shards, state, dims = make_sharded_train_step(rcfg, detached(params),
                                                                KeepGrads(), mesh)
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            with tap_flash(torch) as tap:
                _, grads, m = step(shards, state, batch)
                sync()
            step_s = time.perf_counter() - t0
            rows = []
            for path, g, r in zip(leaf_paths(shards), grads, ref):
                split = _leaf(dims, path)
                want = mesh_lib.shard_leaf(r, split, mesh)
                rows.append(dict(path="/".join(path),
                                 tp_dim=None if split is None else split.tp,
                                 gap=float((g.float() - want.float()).abs().max()),
                                 ref_max=float(r.float().abs().max())))
            runs.append(dict(remat=remat, loss=m["loss"].item(), grad_norm=m["grad_norm"].item(),
                             leaves=rows, calls=tap.calls, step_s=step_s))
            del step, shards, state, grads
        with open(out_path, "w") as f:
            json.dump(dict(loss_ref=loss_ref.item(), norm_ref=norm_ref, runs=runs,
                           launches=dict(_build.LAUNCHES),
                           peak_bytes=torch.cuda.max_memory_allocated() if card else 0), f)
        dist.destroy_process_group()
    except BaseException:
        with open(out_path + ".err", "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def _tp_two_ranks(torch, seed, layers=TP_LAYERS, seq=TP_SEQ, world=TP_RANKS, dev="cuda",
                  cfg=None):
    """Part (a): `world` tp ranks at NVILA-Lite-2B full width, each a
    process on this card over gloo, one step of the port's sharded step for
    each `TP_REMAT` setting. Each step's loss within 1e-3 (relative) of the one-device loss, their grad
    norm within 2e-2, every gradient leaf within 2e-2 x its max|ref| (each
    rank holds a chunk of the split leaves: together the gathered leaf),
    the K biases' within 1e-3 x the tree's largest |ref| (their true
    gradient is 0: both sides hold rounding residue, so their own max is
    no yardstick), every K7-K9 call against its plain version."""
    import multiprocessing as mp
    import shutil
    import socket

    out = os.path.join("runs", "chip_smoke_tp")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    ctx = mp.get_context("spawn")
    paths = [os.path.join(out, f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=_tp_rank, args=(r, world, port, paths[r], seed, layers, seq,
                                                str(dev), cfg))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.time() + TP_TIMEOUT_S
    while any(p.is_alive() for p in procs) and time.time() < deadline:
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.2)
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    wall = time.perf_counter() - t0
    errors = [open(pth + ".err").read() for pth in paths if os.path.exists(pth + ".err")]
    if errors or any(p.exitcode != 0 for p in procs):
        log("[tp] a rank failed (exit codes "
            f"{[p.exitcode for p in procs]}):\n" + "\n".join(errors))
        shutil.rmtree(out, ignore_errors=True)
        return False, dict(exit_codes=[p.exitcode for p in procs], errors=errors), {}
    ranks = [json.load(open(pth)) for pth in paths]
    shutil.rmtree(out, ignore_errors=True)
    loss_ref, norm_ref = ranks[0]["loss_ref"], ranks[0]["norm_ref"]
    layers = (cfg or nvila_lite_2b_config(layers=layers)).llm.num_hidden_layers
    vision = (cfg or nvila_lite_2b_config(vision_layers=TP_VISION_LAYERS)).vision
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in ranks[0]["launches"]}
    # a remat run's forward runs K7 twice (the recompute)
    want = dict(_no_launches(), **{k: world * sum(want_flash(1 + bool(m), 1, layers)[k]
                                                  for m in TP_REMAT)
                                   for k in FLASH_KERNELS})
    ok = launches == want
    summary = dict(loss_ref=loss_ref, norm_ref=norm_ref, launches=launches, wall_s=wall,
                   runs=[])
    for i, remat in enumerate(TP_REMAT):
        runs = [r["runs"][i] for r in ranks]
        loss, norm = runs[0]["loss"], runs[0]["grad_norm"]
        loss_rel = abs(loss - loss_ref) / abs(loss_ref)
        norm_rel = abs(norm - norm_ref) / abs(norm_ref)
        worst = {}
        for r in runs:
            for row in r["leaves"]:
                w = worst.setdefault(row["path"], dict(row, gap=0.0))
                w["gap"] = max(w["gap"], row["gap"])
        # a K bias's gradient is 0 in exact arithmetic (softmax ignores a
        # shift shared by every key): both sides hold rounding residue, held
        # to a small share of the tree's largest gradient
        tree_max = max(w["ref_max"] for w in worst.values())
        residue = [w for w in worst.values() if w["path"].endswith("k_proj/bias")]
        bad = [w for w in worst.values()
               if not w["gap"] <= (1e-3 * tree_max if w in residue else 2e-2 * w["ref_max"])]
        calls = [c for r in runs for c in r["calls"]]
        same = len({(r["loss"], r["grad_norm"]) for r in runs}) == 1
        good = (loss_rel <= 1e-3 and norm_rel <= 2e-2 and not bad and bool(calls)
                and all(c["ok"] for c in calls) and same)
        ok &= good
        split = sum(w["tp_dim"] is not None for w in worst.values())
        ranked = sorted(worst.values(), key=lambda w: -w["gap"] / max(w["ref_max"], 1e-30))
        log(f"[tp] (a) NVILA-Lite-2B, {world} tp ranks (processes on this card, gloo), one "
            f"step of make_sharded_train_step, remat {remat}, LLM {layers} layers, tower "
            f"{vision.num_hidden_layers}, seq {seq}: loss {loss:.6f} against one device's "
            f"{loss_ref:.6f} (rel {loss_rel:.2e}, limit 1e-3), grad norm {norm:.6g} against "
            f"{norm_ref:.6g} (rel {norm_rel:.2e}, limit 2e-2), the same on every rank {same}; "
            f"{len(worst)} gradient leaves ({split} split over tp), worst gap "
            + ", ".join(f"{w['path']} {w['gap']:.3e} of max {w['ref_max']:.3g}"
                        for w in ranked[:3])
            + " (limit 2e-2 x max); K biases (rounding residue) "
            + ", ".join(f"{w['path']} {w['gap']:.2e} of max {w['ref_max']:.2e}"
                        for w in residue)
            + f" (limit 1e-3 x the tree's largest {tree_max:.3g}); {len(bad)} over; K7-K9 "
            f"calls against their plain versions {sum(c['ok'] for c in calls)}/{len(calls)} "
            f"within the bars (heads {sorted({tuple(c['heads']) for c in calls})}, worst "
            f"{max((c['max_abs_err'] for c in calls), default=float('nan')):.3e}); rank step "
            f"{', '.join(f'{r['step_s']:.2f}' for r in runs)} s -> {'OK' if good else 'FAIL'}")
        summary["runs"].append(dict(
            remat=remat, loss=loss, loss_rel=loss_rel, grad_norm=norm, norm_rel=norm_rel,
            tree_max=tree_max, residue=residue, leaves=len(worst), split_leaves=split,
            over=[w["path"] for w in bad], worst=ranked[:5], calls=len(calls),
            calls_ok=sum(c["ok"] for c in calls), step_s=[r["step_s"] for r in runs]))
    log(f"[tp] (a) wall {wall:.1f} s, peak {max(r['peak_bytes'] for r in ranks) / 2**30:.2f} "
        f"GiB a rank; launches {launches} (expected {want}) -> {'OK' if ok else 'FAIL'}")
    return ok, summary, launches


def _tp_one_rank(torch, seed, dev, seq=1024, steps=2, lite=None, ps3=None):
    """Part (c): `make_sharded_train_step` on a (1, 1, 1, 1) NCCL mesh
    against the one-device step from the same tree: `steps` steps of fp8
    AdamW (NVILA-Lite-2B, 2 + 2 layers) and of PS3 stage 1.5 (VILA-HD,
    Qwen2-7B and the PS3 trunk at 2 layers each). Each step's loss (and
    selection loss) within 1e-5, its grad norm within 1e-4 (relative), every
    parameter after the steps within 2 x the learning rate (AdamW turns
    rounding residue into updates of up to lr)."""
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import (
        batch_to_device,
        make_sharded_train_step,
        make_train_step,
        train_step,
    )

    mesh = one_rank_mesh(torch, dev)
    lite = lite or nvila_lite_2b_config(layers=2, vision_layers=2)
    ps3 = ps3 or ps3_train_config(torch, layers=2, tower_layers=2, dev=dev)
    runs = [
        ("fp8_adamw", lite, lambda: train_master(torch, seed, dev, lite),
         lambda: _sft_batch(torch, lite, seq, dev)[0],
         topt.OptimizerConfig(learning_rate=1e-4, schedule="constant", warmup_ratio=0.0,
                              optimizer="fp8_adamw"), ("loss", "grad_norm")),
        ("ps3 stage 1.5", ps3, lambda: ps3_train_params(torch, ps3, seed, dev),
         lambda: batch_to_device(ps3_train_batch(torch, ps3, seq, seed), dev),
         topt.OptimizerConfig(learning_rate=5e-5, schedule="constant", warmup_ratio=0.0,
                              tune_language_model=False),
         ("loss", "token_selection_loss", "grad_norm")),
    ]
    ok, summary, launches = True, {}, {}
    for name, cfg, draw, data, ocfg, keys in runs:
        batch = data()
        got = {}
        for tag in ("one device", "sharded"):
            opt = topt.make_optimizer(ocfg)
            if tag == "one device":
                _, params, state = make_train_step(cfg, draw(), opt)
                step = functools.partial(train_step, cfg=cfg, optimizer=opt)
            else:
                step, params, state, _ = make_sharded_train_step(cfg, draw(), opt, mesh)
                _build.reset_launches()
            rows = []
            for _ in range(steps):
                params, state, m = step(params, state, batch)
                rows.append({k: float(m[k]) for k in keys})
            if tag == "sharded":
                launches[f"tp one-rank {name}"] = dict(_build.LAUNCHES)
            got[tag] = (rows, params)
            del state, opt
        (rows_a, pa), (rows_b, pb) = got["one device"], got["sharded"]
        rels = {k: max(_rel_diff(b[k], a[k]) for a, b in zip(rows_a, rows_b)) for k in keys}
        gap = max(float((x.detach().float() - y.detach().float()).abs().max())
                  for x, y in zip(topt.leaves(pa), topt.leaves(pb)))
        good = (all(rels[k] <= (1e-4 if k == "grad_norm" else 1e-5) for k in keys)
                and gap <= 2 * ocfg.learning_rate
                and all(math.isfinite(r[k]) for r in rows_b for k in keys)
                and any(launches[f"tp one-rank {name}"][k] for k in FLASH_KERNELS))
        ok &= good
        log(f"[tp] (c) {name} on a (1, 1, 1, 1) NCCL mesh, {steps} steps: sharded "
            + "; ".join(f"{k} {[round(r[k], 6) for r in rows_b]}" for k in keys)
            + " against one device's, largest rel " + ", ".join(f"{k} {v:.2e}" for k, v in
                                                               rels.items())
            + f"; parameters within {gap:.3e} (limit {2 * ocfg.learning_rate:g}); launches "
            f"{launches[f'tp one-rank {name}']} -> {'OK' if good else 'FAIL'}")
        summary[name] = dict(sharded=rows_b, one_device=rows_a, rel=rels, param_gap=gap)
        del got, pa, pb, batch
        gc.collect()
        torch.cuda.empty_cache()
    return ok, summary, launches


def phase_tp(torch, seed, dev="cuda", cfg=None, lite=None, ps3=None, heads=TP_RANK_HEADS,
             seq=TP_SEQ):
    """Tensor parallelism: (a) two tp ranks at NVILA-Lite-2B full width
    against the one-device step (`_tp_two_ranks`); (b) K7-K9 at the tp
    ranks' heads (6 / 1: NVILA-Lite-2B at tp 2; 7 / 1: Qwen2-7B at tp 4)
    at S 2048 with three segments, against their plain versions and timed
    beside SDPA (`phase_train_kernels`' main shape); (c) the sharded step's
    other optimizers and PS3 on a one-rank NCCL mesh (`_tp_one_rank`).
    `cfg`, `lite`, `ps3` and `heads` replace the three parts' models (a
    rehearsal on the CPU at small widths)."""
    dev = torch.device(dev)
    ok, summary, launches = True, {}, {}
    good, summary["two_ranks"], two = _tp_two_ranks(torch, seed, seq=seq, dev=dev, cfg=cfg)
    gc.collect()
    ok &= good
    if two:
        launches["tp"] = two
    results = {name: [] for name in FLASH_KERNELS}
    for hq, hkv, label in heads:
        good, rows = phase_train_kernels(torch, seed, dev=dev, heads=(hq, hkv), seq=seq,
                                         only=("3 segments",), tp=f"{label} ({hq}/{hkv} heads)")
        ok &= good
        for name, rs in rows.items():
            results[name].extend(rs)
    good, summary["one_rank"], one = _tp_one_rank(torch, seed, dev, lite=lite, ps3=ps3)
    ok &= good
    launches.update(one)
    return ok, summary, launches, results


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
    # CPU references the card does not wait for: started now, read at the end
    worker = CpuWorker() if "awq" in phases else None
    deferred = []  # (name, check) pairs, run at the end of the run
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

    phase_s = report["phase_s"] = {}  # each phase's wall (the first user builds an engine)

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        phase_s[name] = time.time() - t0
        log(f"[{name}] phase wall {phase_s[name]:.1f} s")
        return out

    if "build" in phases:
        report["build_s"] = timed("build", phase_build)
    if "kernels" in phases:
        good, results = timed("kernels", lambda: phase_kernels(torch, args.seed))
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
        if "k1_one_digit" in phases:
            from vila_tpu_torch.ops import quant

            flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
            good, results["k1_one_digit"], results["k1_one_digit_launches"] = \
                _check_k1_one_digit(torch, quant, args.seed, flush)
            ok &= good
    if "e2e" in phases:
        good, report["requests"], launches["e2e"] = timed("e2e", lambda: phase_e2e(
            torch, engine(args.layers, args.seed), args.seed))
        ok &= good
    if "serve" in phases:
        for max_batch, n_req, new_tokens in SERVE_RUNS:
            good, report[f"serve_b{max_batch}"], launches[f"serve b{max_batch}"] = timed(
                f"serve b{max_batch}", lambda: phase_serve(
                    torch, engine(args.layers, args.seed), args.seed, max_batch, n_req,
                    new_tokens))
            ok &= good
    if "consistency" in phases:
        good, report["consistency"] = timed("consistency", lambda: phase_consistency(
            torch, engine(4, args.seed + 1), args.seed))
        ok &= good
    if "batched_consistency" in phases:
        good, report["batched_consistency"] = timed(
            "batched_consistency", lambda: phase_batched_consistency(
                torch, engine(4, args.seed + 1), args.seed))
        ok &= good
    if "small_consistency" in phases:
        good, report["small_consistency"] = timed(
            "small_consistency", lambda: phase_small_consistency(torch, args.seed))
        ok &= good
    if "http" in phases:
        good, report["http"] = timed("http", lambda: phase_http(
            torch, engine(args.layers, args.seed)))
        ok &= good
    if "spec" in phases:
        good, report["spec"], spec_launches = timed("spec", lambda: phase_spec(
            torch, engine(args.layers, args.seed), args.seed))
        launches.update(spec_launches)
        ok &= good
    if "constrained" in phases:
        good, report["constrained"], json_launches = timed("constrained", lambda: (
            phase_constrained(torch, engine(args.layers, args.seed), args.seed)))
        launches.update(json_launches)
        ok &= good
    if any(p in phases for p in ("s2", "video", "media_profile")):
        from vila_tpu_torch.models import siglip

        e2e = engine(args.layers, args.seed)
        vt8 = siglip.quantize_siglip_w8a8(e2e.params["vision_tower"])
        for kind in ("s2", "video"):
            if kind in phases:
                good, report[kind], launches[kind] = timed(kind, lambda: phase_media(
                    torch, e2e, vt8, args.seed, kind))
                ok &= good
        if "media_profile" in phases:  # not in the default run
            report["media_profile"] = {kind: phase_media_profile(torch, e2e, vt8, args.seed,
                                                                 kind)
                                       for kind in ("s2", "video")}
        del e2e, vt8
    if "ps3" in phases:
        good, report["ps3"], ps3_launches, k2_rows = timed("ps3", lambda: phase_ps3(
            torch, engine(args.layers, args.seed), args.seed))
        launches.update(ps3_launches)
        results.setdefault("w4_gemm", []).extend(k2_rows)
        ok &= good
    if "towers" in phases:
        good, report["towers"], tower_launches = timed("towers", lambda: phase_towers(
            torch, engine(args.layers, args.seed), args.seed))
        launches.update(tower_launches)
        ok &= good
    if "load" in phases:
        good, report["load"], launches["load"] = timed("load", lambda: phase_load(
            torch, args.seed))
        ok &= good
    if "w8" in phases:
        good, report["w8"] = timed("w8", lambda: phase_w8(torch, args.seed))
        ok &= good
    if "export" in phases:
        good, report["export"], launches["export"] = timed("export", lambda: phase_export(
            torch, args.seed))
        ok &= good
    if "awq" in phases:
        good, report["awq"], launches["awq"] = timed("awq", lambda: phase_awq(
            torch, args.seed, worker=worker, defer=lambda name, fn: deferred.append((name, fn))))
        ok &= good
    # the eval phase's CLI runs overlap quant_acc (their own processes)
    eval_started = timed("eval start", start_eval) if "eval" in phases else None
    if "quant_acc" in phases:
        good, report["quant_acc"], acc_launches = timed(
            "quant_acc", lambda: phase_quant_acc(torch))
        launches.update(acc_launches)
        ok &= good
    if "eval" in phases:
        good, report["eval"] = timed("eval", lambda: phase_eval(eval_started))
        ok &= good
    if "profile" in phases:  # not in the default run
        report["profile"] = phase_profile(torch, engine(args.layers, args.seed), args.seed)
        report["profile_batched"] = phase_profile_batched(torch, engine(args.layers, args.seed))
    if any(p.startswith("train") or p == "tp" for p in phases):
        # the serving engines' weights make room for training
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    if "train_kernels" in phases:
        good, train_results = timed("train_kernels", lambda: phase_train_kernels(
            torch, args.seed))
        results.update(train_results)
        ok &= good
    if "train" in phases:
        # LLM depth 8, not 28: its three checkpoint saves dominate the phase
        train_cfg = nvila_lite_2b_config(layers=TRAIN_LAYERS)
        try:
            good, report["train"], train_launches = timed("train", lambda: phase_train(
                torch, args.seed, cfg=train_cfg))
            launches.update(train_launches)
            ok &= good
            if "export" in phases:  # its step-3 checkpoint, consolidated
                good, report["consolidate"] = timed("consolidate", lambda: phase_consolidate(
                    torch, os.path.join(TRAIN_DIR, "checkpoints"), train_cfg))
                ok &= good
        finally:
            import shutil

            shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    if "train_consistency" in phases:
        good, report["train_consistency"] = timed(
            "train_consistency", lambda: phase_train_consistency(torch, args.seed))
        ok &= good
    if "train_media" in phases:
        good, report["train_media"], media_launches = timed(
            "train_media", lambda: phase_train_media(torch, args.seed))
        launches.update(media_launches)
        ok &= good
    modes = [p for p in ("train_fp8", "train_lora", "train_dpo", "train_rlhf") if p in phases]
    if modes:
        master = train_master(torch, args.seed)
        mode_fns = {"train_fp8": phase_train_fp8, "train_lora": phase_train_lora,
                    "train_dpo": phase_train_dpo, "train_rlhf": phase_train_rlhf}
        for name in modes:
            good, report[name], mode_launches = timed(name, lambda: mode_fns[name](
                torch, args.seed, master))
            launches.update(mode_launches)
            ok &= good
        del master
        gc.collect()
        torch.cuda.empty_cache()
    if "train_ps3" in phases:
        good, report["train_ps3"], ps3_train_launches = timed(
            "train_ps3", lambda: phase_train_ps3(torch, args.seed))
        launches.update(ps3_train_launches)
        ok &= good
    if "train_data" in phases:
        good, report["train_data"], data_launches = timed("train_data", lambda: (
            phase_train_data(torch, args.seed)))
        launches.update(data_launches)
        ok &= good
    if "tp" in phases:
        good, report["tp"], tp_launches, tp_results = timed("tp", lambda: phase_tp(
            torch, args.seed))
        launches.update(tp_launches)
        for name, rows in tp_results.items():
            results.setdefault(name, []).extend(rows)
        ok &= good
    long_phases = [p for p in ("sp_ring", "extend", "niah", "long_ctx") if p in phases]
    if long_phases:
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    if "sp_ring" in phases:
        good, report["sp_ring"], ring_launches, ring_results = timed(
            "sp_ring", lambda: phase_sp_ring(torch, args.seed))
        launches.update(ring_launches)
        for name, rows in ring_results.items():
            results.setdefault(name, []).extend(rows)
        ok &= good
    if "extend" in phases or "niah" in phases:
        # one seeded bf16 Qwen2-7B for both (the extension leaves it as it is)
        base = _extend_draw(torch, qwen2_7b_config(), args.seed, torch.device("cuda"))
        for name, fn in (("extend", phase_extend), ("niah", phase_niah)):
            if name in phases:
                good, report[name], long_launches = timed(name, lambda: fn(
                    torch, args.seed, base=base))
                launches.update(long_launches)
                ok &= good
        del base
        gc.collect()
        torch.cuda.empty_cache()
    if "long_ctx" in phases:
        good, report["long_ctx"], long_launches = timed("long_ctx", lambda: phase_long_ctx(
            torch, args.seed))
        launches.update(long_launches)
        ok &= good
    import torch.distributed as dist

    if dist.is_initialized():  # the one-rank NCCL group of tp and the long phases
        dist.destroy_process_group()
    if "train_profile" in phases:  # not in the default run
        report["train_profile"] = phase_train_profile(torch, args.seed)
    for name, check in deferred:
        ok &= timed(name, check)
    if worker is not None:
        worker.close()
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
