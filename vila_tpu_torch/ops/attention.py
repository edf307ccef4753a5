"""Multi-head attention, as `vila_tpu/ops/attention.py`: the plain
("xla") and blocked paths with the mask semantics of `_build_mask`, and the
flash route (`ops/flash_attention.py`, kernels K7-K9).

The flash route serves cache-free causal attention on the card, as the JAX
package's Pallas branch does on a TPU: training and cache-free prefill.
The served path never takes it (prefill against a cache passes
`q_positions`, decode runs the fused layers), nor does SigLIP (head dim
72). Plain matmul + softmax is used rather than SDPA so the mask semantics
stay those of the reference.

Conventions:
  q:    (B, Sq, Hq, D)
  k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0 (GQA)
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def _build_mask(
    q_positions: torch.Tensor,  # (B, Sq) int
    kv_positions: torch.Tensor,  # (B, Skv) int
    causal: bool,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    kv_valid_len: Optional[torch.Tensor],  # (B,)
    skv: int,
    kv_index: Optional[torch.Tensor] = None,  # (Skv,) global slot index
) -> Optional[torch.Tensor]:
    """Boolean mask broadcastable to (B, Sq, Skv); True = attend."""
    masks = []
    if causal:
        masks.append(q_positions[:, :, None] >= kv_positions[:, None, :])
    if q_segment_ids is not None and kv_segment_ids is not None:
        masks.append(q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])
    if kv_valid_len is not None:
        if kv_index is None:
            kv_index = torch.arange(skv, device=kv_valid_len.device)
        masks.append(kv_index[None, None, :] < kv_valid_len[:, None, None])
    if not masks:
        return None
    mask = masks[0]
    for m in masks[1:]:
        mask = mask & m
    return mask


def _default_positions(positions, b, s, device):
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    return positions


def attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Reference attention, float32 softmax.

    bf16 inputs keep the JAX path's roundings: q is scaled in f32 and
    rounded to bf16, products accumulate in f32, and the probabilities are
    rounded to bf16 before the PV product."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    if scale is None:
        scale = d**-0.5
    q_positions = _default_positions(q_positions, b, sq, q.device)
    kv_positions = _default_positions(kv_positions, b, skv, q.device)

    low_prec = q.dtype == torch.bfloat16
    qf = q.float() * scale
    if low_prec:
        qf = qf.to(torch.bfloat16).float()
    qf = qf.reshape(b, sq, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())

    mask = _build_mask(
        q_positions, kv_positions, causal, q_segment_ids, kv_segment_ids,
        kv_valid_len, skv,
    )
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, _NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    if low_prec:
        probs = probs.to(torch.bfloat16).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block: int = 1024,
) -> torch.Tensor:
    """Memory-bounded attention: online softmax over KV blocks (the
    flash-attention recurrence in plain ops), peak intermediate
    B*H*Sq*block floats. Blocks past every query position are skipped."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    groups = hq // hkv
    if scale is None:
        scale = d**-0.5
    q_positions = _default_positions(q_positions, b, sq, q.device)
    kv_positions = _default_positions(kv_positions, b, skv, q.device)

    blk = min(block, skv)
    nb = (skv + blk - 1) // blk
    pad = nb * blk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad))
        if kv_segment_ids is not None:
            kv_segment_ids = torch.nn.functional.pad(kv_segment_ids, (0, pad))
        if kv_valid_len is None:
            kv_valid_len = torch.full((b,), skv, dtype=torch.int32, device=q.device)

    qf = (q.float() * scale).reshape(b, sq, hkv, groups, d)
    m = torch.full((b, hkv, groups, sq), _NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, groups, sq), device=q.device)
    acc = torch.zeros((b, sq, hkv, groups, d), device=q.device)
    q_pos_max = int(q_positions.max())

    for j in range(nb):
        sl = slice(j * blk, (j + 1) * blk)
        p_j = kv_positions[:, sl]
        if causal and int(p_j.min()) > q_pos_max:
            continue
        scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k[:, sl].float())
        mask = _build_mask(
            q_positions, p_j, causal, q_segment_ids,
            kv_segment_ids[:, sl] if kv_segment_ids is not None else None,
            kv_valid_len, blk,
            kv_index=torch.arange(j * blk, (j + 1) * blk, device=q.device),
        )
        if mask is not None:
            scores = torch.where(mask[:, None, None], scores, _NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        alpha = torch.exp(torch.where(m <= _NEG_INF * 0.5, _NEG_INF, m - m_new))
        p = torch.where(
            scores <= _NEG_INF * 0.5, 0.0, torch.exp(scores - m_new[..., None])
        )
        l = l * alpha + p.sum(-1)
        acc = acc * alpha.permute(0, 3, 1, 2)[..., None] + torch.einsum(
            "bhgqk,bkhd->bqhgd", p, v[:, sl].float()
        )
        m = m_new
    l = l.clamp_min(1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(b, sq, hq, d).to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch as `vila_tpu.ops.attention.multi_head_attention`: impl
    "auto" | "xla" | "blocked" | "flash" (the JAX package's "pallas").
    "auto" takes the flash kernels for the shapes they serve on the card
    (`_flash_supported`), else the blocked path for large score matrices,
    else the plain one; on the CPU it never picks "flash", as JAX never
    picks Pallas off a TPU. Forced, "flash" on CPU tensors runs the
    kernels' plain versions."""
    if impl == "auto":
        if _flash_supported(q, k, q_positions):
            impl = "flash"
        elif q.shape[1] >= 256 and q.shape[1] * k.shape[1] >= (1 << 22):
            impl = "blocked"
        else:
            impl = "xla"
    if impl == "flash":
        from vila_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, scale=scale,
        )
    if impl not in ("xla", "blocked"):
        raise ValueError(f"unknown attention impl {impl!r}")
    fn = attention_blocked if impl == "blocked" else attention_xla
    return fn(
        q, k, v,
        causal=causal,
        q_positions=q_positions,
        kv_positions=kv_positions,
        q_segment_ids=q_segment_ids,
        kv_segment_ids=kv_segment_ids,
        kv_valid_len=kv_valid_len,
        scale=scale,
    )


def _flash_supported(q, k, q_positions) -> bool:
    """JAX's `_pallas_supported` with "on a TPU" read as "tensors on the
    card", narrowed to what the kernels take (bf16, head dim 128)."""
    from vila_tpu_torch.ops.flash_attention import HEAD_DIM

    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        return False
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if sq < 128 or skv < 128 or sq != skv:
        return False
    if d != HEAD_DIM or sq % 128 != 0:
        return False
    return q_positions is None
