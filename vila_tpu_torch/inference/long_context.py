"""Long-context generation over a sequence-sharded KV cache, as
`vila_tpu/inference/long_context.py`: the inference side of LongVILA
(1M-token NIAH over several devices).

The cache is split along its sequence over the mesh's sequence dims (by
default every dim): rank i holds global slots [i·n, (i+1)·n), n =
max_cache_len / shards, and the weights whole. The decoder runs in
`qwen2.forward`'s deferred mode (`cache_append`):

  * chunked prefill: the prompt streams through in `prefill_chunk`
    tokens; each chunk's queries are the same on every rank. Each layer
    attends over the rank's read-only cache shard (`attention_blocked`,
    online softmax, peak (chunk, 1024) scores), the chunk's own rows are
    folded in outside the reduction (the same on every rank, so they count
    once), and the partial results merge by LSE: `all_reduce(MAX)` of the
    row maxima, then one `all_reduce(SUM)` of the rescaled sums and
    accumulators;
  * decode: one token a step through the same attention;
  * append: after the last layer, the rank whose shard holds a new row's
    slot writes it (no collective); a chunk may straddle shards.

On W4 weights the projections run K1 at M = 1 in decode and K2 at M =
`prefill_chunk` in prefill: the fused decode kernels are off in deferred
mode, as in JAX. The weights are replicated (the JAX package can shard
them over the mesh through GSPMD; `param_specs` is not ported).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from vila_tpu_torch.models import qwen2
from vila_tpu_torch.ops.attention import _NEG_INF, attention_blocked

_BLOCK_SCORES = 1 << 22  # the blocked attention's scores a block, at most


class LongContextEngine:
    """Generation over contexts larger than one device's KV budget.

    `mesh` is a `parallel.mesh.Mesh` (one rank a device); `seq_axes` the
    dims the cache is split over: every dim (the default) or one named
    dim."""

    def __init__(self, params: Dict[str, Any], llm_cfg, mesh, *, max_cache_len: int,
                 prefill_chunk: int = 4096, seq_axes: Optional[Sequence[str]] = None) -> None:
        self.params = params
        self.cfg = llm_cfg
        self.mesh = mesh
        axes = tuple(seq_axes or ("dp", "sp", "su"))
        if set(axes) == {"dp", "sp", "su"}:
            axes, self.group = ("dp", "sp", "su"), None  # the whole world
        elif len(axes) == 1:
            self.group = mesh.group(axes[0])
        else:
            raise NotImplementedError("the cache splits over every mesh dim or one")
        self.seq_axes = axes
        n_shards = mesh.axis_size(axes)
        if max_cache_len % n_shards or max_cache_len % prefill_chunk:
            raise ValueError(f"max_cache_len {max_cache_len} must split into {n_shards} shards "
                             f"and into chunks of {prefill_chunk}")
        self.max_cache_len = max_cache_len
        self.prefill_chunk = prefill_chunk
        self.local_len = max_cache_len // n_shards
        self.offset = mesh.axis_index(axes) * self.local_len
        self.device = params["embed_tokens"]["embedding"].device

    def init_cache(self):
        cache = qwen2.init_cache(self.cfg, batch=1, max_len=self.local_len,
                                 device=self.device)
        cache["offset"] = self.offset
        return cache

    def _attend(self, q, k, v, *, causal=True, q_positions=None, kv_positions=None,
                q_segment_ids=None, kv_segment_ids=None, new_k=None, new_v=None,
                new_kv_positions=None, new_kv_seg=None, **_):
        """Attention over the sharded cache plus the chunk's own rows, merged
        by LSE over the ranks (qwen2.forward's deferred mode)."""
        assert causal and q_positions is not None
        assert new_k is not None, "the sharded attend needs qwen2.forward's cache_append mode"
        # blocks of at most _BLOCK_SCORES scores, 1024 keys at least: a decode
        # step's one query row takes the whole shard in one block (each block's
        # skip test reads the device once)
        block = max(1024, _BLOCK_SCORES // (q.shape[0] * q.shape[1] * q.shape[2]))
        acc, l, m = attention_blocked(q, k, v, causal=True, q_positions=q_positions,
                                      kv_positions=kv_positions, q_segment_ids=q_segment_ids,
                                      kv_segment_ids=kv_segment_ids, return_stats=True,
                                      block=block)
        # the chunk's rows: the same on every rank, merged once outside the sum
        acc_c, l_c, m_c = attention_blocked(q, new_k, new_v, causal=True,
                                            q_positions=q_positions,
                                            kv_positions=new_kv_positions,
                                            q_segment_ids=q_segment_ids,
                                            kv_segment_ids=new_kv_seg, return_stats=True)
        m_g = m.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=self.group)
        m_g = torch.maximum(m_g, m_c)  # (B, Hq, Sq)
        w = torch.exp(torch.where(m <= _NEG_INF * 0.5, _NEG_INF, m - m_g))
        w_c = torch.exp(torch.where(m_c <= _NEG_INF * 0.5, _NEG_INF, m_c - m_g))
        part = torch.cat([(acc * w.transpose(1, 2)[..., None]).reshape(-1),
                          (l * w).reshape(-1)])
        dist.all_reduce(part, group=self.group)
        num = part[:acc.numel()].view_as(acc) + acc_c * w_c.transpose(1, 2)[..., None]
        den = part[acc.numel():].view_as(l) + l_c * w_c
        den = den.clamp_min(1e-30).transpose(1, 2)[..., None]
        return (num / den).to(q.dtype)

    def _append(self, ck, cv, valid, k_rows, v_rows, token_valid, fill: int):
        """Write the rows of global slots [fill, fill + s) that fall in this
        rank's shard (L, B, s, Hkv*hd); no collective."""
        s = k_rows.shape[2]
        lo, hi = max(fill, self.offset), min(fill + s, self.offset + self.local_len)
        if lo < hi:
            dst = slice(lo - self.offset, hi - self.offset)
            src = slice(lo - fill, hi - fill)
            ck[:, :, dst] = k_rows[:, :, src].to(ck.dtype)
            cv[:, :, dst] = v_rows[:, :, src].to(cv.dtype)
            valid[:, dst] = token_valid[:, src]
        return ck, cv, valid

    def _forward(self, cache, **kw):
        return qwen2.forward(self.params, self.cfg, cache=cache, attn_impl=self._attend,
                             cache_append=self._append, **kw)

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, cache=None, progress=None):
        """Stream (1, S, D) prompt embeddings through in chunks (the tail
        right-padded). Returns (last_logits (1, V), cache, prompt_len).
        `progress(done, total)` is called after each chunk."""
        s = embeds.shape[1]
        c = self.prefill_chunk
        if cache is None:
            cache = self.init_cache()
        if s > self.max_cache_len:
            raise ValueError(f"a prompt of {s} does not fit a cache of {self.max_cache_len}")
        embeds = torch.as_tensor(embeds).to(self.device)
        logits = None
        n_chunks = (s + c - 1) // c
        for start in range(0, s, c):
            chunk = embeds[:, start:start + c]
            n = chunk.shape[1]
            if n < c:
                chunk = torch.nn.functional.pad(chunk, (0, 0, 0, c - n))
            tv = torch.zeros((1, c), dtype=torch.bool, device=self.device)
            tv[0, :n] = True
            logits, cache = self._forward(
                cache, inputs_embeds=chunk, token_valid=tv,
                gather_position=torch.tensor([n - 1], device=self.device))
            logits = logits[:, 0]
            if n < c:  # the cursor moved over the padding: rewind
                cache["fill"] -= c - n
            if progress is not None:
                progress(start // c + 1, n_chunks)
        return logits, cache, s

    @torch.no_grad()
    def generate(self, embeds: torch.Tensor, max_new_tokens: int, stop_ids: Sequence[int] = (),
                 decode_chunk: int = 8, progress=None) -> List[int]:
        """Greedy generation: chunked sharded prefill, then sharded decode
        in runs of `decode_chunk` tokens read back together, never past the
        cache's capacity."""
        logits, cache, s = self.prefill(embeds, progress=progress)
        return self.decode(logits, cache, s, max_new_tokens, stop_ids, decode_chunk)

    @torch.no_grad()
    def decode(self, logits, cache, s: int, max_new_tokens: int, stop_ids: Sequence[int] = (),
               decode_chunk: int = 8) -> List[int]:
        """Greedy tokens after a prefill's (last logits, cache, prompt
        length)."""
        first = int(torch.argmax(logits[0]))
        stop = set(stop_ids)
        if first in stop:
            return []
        out = [first]
        if max_new_tokens <= 1:
            return out[:max_new_tokens]
        tok = torch.tensor([[first]], device=self.device)
        pos = s
        left = max_new_tokens - 1
        while left > 0 and pos < self.max_cache_len:
            steps = min(decode_chunk, left, self.max_cache_len - pos)
            toks = []
            for _ in range(steps):
                logits, cache = self._forward(
                    cache, input_ids=tok,
                    positions=torch.tensor([[pos]], dtype=torch.int32, device=self.device))
                tok = torch.argmax(logits[:, 0], -1, keepdim=True)
                toks.append(tok)
                pos += 1
            for t in torch.cat(toks, 1)[0].tolist():
                if t in stop:
                    return out
                out.append(t)
            left -= steps
        return out
