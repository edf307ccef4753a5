"""Prompt-lookup speculative decoding, greedy-exact, as
`vila_tpu/inference/speculative.py`.

Decode streams every weight once per forward, so a forward over (1, γ+1)
tokens costs about what (1, 1) costs; when γ tokens can be guessed,
verifying them in one forward multiplies the decode rate by the accepted
length. Prompt-lookup decoding guesses by matching the last 2-gram against
the tokens already seen (prompt and output): effective wherever the answer
quotes the prompt.

One chunk (`spec_chunk`) loops: draft the γ tokens that followed the latest
earlier occurrence of the live 2-gram, run one `qwen2.forward` over
`[cur, draft...]` at positions `pos + 0..γ`, accept the longest prefix of
drafts equal to the forward's argmax (a cumprod over equality), and emit
those k drafts plus one bonus token (the argmax after them). With
`do_sample=False` the emitted stream is the vanilla greedy stream: every
emitted token is an argmax of the logits the one-token loop would compute.

Cache discipline, as JAX's: the verify forward writes K/V and `valid` at
`[fill, fill+γ+1)`; the cursor is then re-pinned to `fill + k + 1`. The
slots after it hold rejected drafts, but the next iteration writes a full
(γ+1)-wide span from the new cursor, which covers them, before attention
reads them. On exit `valid` is re-masked to `[0, fill)`, so a later width-1
decode or another chunk never sees them. RoPE positions are carried apart
from the cursor, as the vanilla loop carries them.

How it differs from JAX, in mechanism, not in result: JAX runs the whole
loop as one on-device `lax.while_loop`. The port's cache cursor is a host
int (`qwen2.forward` writes at `int(cache["fill"])`), so each iteration
reads the forward's γ+1 argmax ids to the host, one synchronisation per
verify forward, and the history, the draft and the acceptance live on the
host (numpy). The verify forward at s = γ+1 takes no fused decode route
(those are for s == 1): on W4 weights each projection of every layer and
the lm_head runs K1 (`quant.w4_matmul_decode`) at M = γ+1, and attention
runs the plain route over the cache.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from vila_tpu_torch.models import qwen2
from vila_tpu_torch.utils.device import host_to_device


def draft_tokens(hist: np.ndarray, hlen: int, cur: int, prev: int, gamma: int) -> np.ndarray:
    """(gamma,) int32: the tokens that followed the latest earlier
    occurrence of the 2-gram (prev, cur) in `hist[0, :hlen]`, the live
    2-gram itself excluded; zeros when it never occurred."""
    hist_l = hist.shape[1]
    j = np.arange(hist_l - 1)
    match = (hist[0, :-1] == prev) & (hist[0, 1:] == cur) & (j < hlen - 2)
    if not match.any():
        return np.zeros((gamma,), np.int32)
    idx = int(j[match].max())
    cols = np.clip(idx + 2 + np.arange(gamma), 0, hist_l - 1)
    return hist[0, cols].astype(np.int32)


def spec_chunk(llm: Dict[str, Any], cfg_llm, cur, prev, pos: int, cache: Dict[str, Any],
               hist: np.ndarray, hlen: int, *, max_out: int, gamma: int):
    """One speculative chunk (batch 1).

    cur, prev: (1,) ints, the last and second-to-last tokens; pos: the true
    position of `cur`; hist (1, L) int32 the prompt and the tokens emitted
    (L with a slack of at least gamma past the emit budget; written in
    place); hlen its live length. Returns (out, out_len, cur, prev, pos,
    cache, hist, hlen, n_iters): out (max_out + gamma,) int32 with
    out[:out_len] live (the last iteration may pass max_out by up to
    gamma; callers truncate), cur / prev (1,) int32. The loop runs while
    out_len < max_out, fill + gamma + 1 <= the cache length and hlen +
    gamma + 1 <= L."""
    b, hist_l = hist.shape
    assert b == 1, "speculative decode is a bs=1 path"
    max_len = cache["k"].shape[2]
    span = gamma + 1
    dev = cache["k"].device
    out = np.zeros((max_out + gamma,), np.int32)
    cur, prev = int(np.asarray(cur).reshape(-1)[0]), int(np.asarray(prev).reshape(-1)[0])
    pos, hlen = int(pos), int(hlen)
    out_len = iters = 0
    while (out_len < max_out and int(cache["fill"]) + span <= max_len
           and hlen + span <= hist_l):
        fill = int(cache["fill"])
        draft = draft_tokens(hist, hlen, cur, prev, gamma)
        seq = np.concatenate([[cur], draft]).astype(np.int64)[None]
        logits, cache = qwen2.forward(
            llm, cfg_llm, input_ids=host_to_device(seq, dev),
            positions=host_to_device((pos + np.arange(span, dtype=np.int32))[None], dev),
            cache=cache)
        preds = logits[0].argmax(-1).to(torch.int32).cpu().numpy()  # the one read-back
        k = int(np.cumprod(preds[:gamma] == draft).sum())
        emit = np.where(np.arange(span) < k, np.concatenate([draft, [0]]), preds)
        count = k + 1
        # re-pin the cursor just past the last accepted slot
        cache = dict(cache, fill=fill + count)
        hist[0, hlen:hlen + span] = emit
        out[out_len:out_len + span] = emit
        prev = int(emit[k - 1]) if k > 0 else cur
        cur = int(emit[k])
        hlen += count
        pos += count
        out_len += count
        iters += 1
    # stale-slot hygiene: later width-1 decodes never overwrite the rejected
    # suffix, so mask it out of `valid` now
    live = torch.arange(max_len, device=dev)[None] < int(cache["fill"])
    cache = dict(cache, valid=cache["valid"] & live)
    return (out, out_len, np.asarray([cur], np.int32), np.asarray([prev], np.int32), pos,
            cache, hist, hlen, iters)


def init_history(prompt_ids, first_token: int, length: int) -> Tuple[np.ndarray, int]:
    """(hist (1, length) int32, hlen) for a decoded prompt whose first
    generated token is already known."""
    n = int(np.asarray(prompt_ids).shape[0])
    hist = np.zeros((1, length), np.int32)
    hist[0, :n] = np.asarray(prompt_ids, np.int32)
    hist[0, n] = first_token
    return hist, n + 1
