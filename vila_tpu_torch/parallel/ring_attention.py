"""Ring attention, Ulysses and their 2D hybrid (LongVILA's MM-SP), forward
and backward, as `vila_tpu/parallel/ring_attention.py`.

Each rank holds one sequence shard (B, S_local, H, D). The collectives are
`torch.distributed` over a process group (a mesh dim's, `mesh.Mesh.group`):

  * the ring (`ring_flash_attention`) is a `torch.autograd.Function`. Its
    forward computes one block a step (`_ring_step_fwd`), merges it by LSE
    (`_merge`) and passes K/V (and their segment ids) to the next rank with
    one `batch_isend_irecv` in which every rank posts its send and its
    receive. Its backward rotates K/V with their dK/dV accumulators and
    recomputes each block from the merged LSE (`_ring_step_bwd`), as the
    JAX package's `_ring_bwd`, so memory stays O(S_local); after n steps
    the accumulators are one rank short of home and take one more hop;
  * layout "contiguous" (rank r holds tokens [r·S/n, (r+1)·S/n)) or
    "zigzag" (rank r holds global chunks r and 2n-1-r of a 2n-chunk split,
    `zigzag_order`): a causal step with src < my attends K/V's first half
    ("earlier"), src > my q's second half ("later"), both not causal with
    Sq != Skv;
  * Ulysses (`ulysses_attention`) scatters heads and gathers the sequence
    with `all_to_all_single` (differentiable: the backward is the inverse
    all-to-all), attends the whole sequence locally, and scatters back;
    with fewer K/V heads than ranks the K/V heads are repeated first
    (`expand_kv_heads`; autograd sums the copies' gradients);
  * the hybrid runs Ulysses inside the ring.

The local attention of a ring step is K7 (`flash_attention(...,
return_lse=True)`) and its block backward `flash_block_backward` (K8 + K9)
when `impl` resolves to "flash" (bf16, head dim 128, tensors on the card);
"xla" is the JAX package's f32 reference, the route it takes off a TPU. On
CPU tensors "flash" runs the kernels' plain versions. Step selection
(diag / earlier / later / skip) is host control flow on the ranks' indices.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from vila_tpu_torch.parallel.mesh import gather_tensor

_NEG_INF = -1e30

# KV lengths above this take the chunked "xla" path, so the (Sq, Skv)
# scores never materialise
_XLA_CHUNK_THRESHOLD = 4096
_XLA_KV_CHUNK = 2048


def _resolve_impl(impl: str, q: torch.Tensor) -> str:
    """"auto": the flash kernels for what they take on the card, else the
    f32 reference ("xla")."""
    if impl != "auto":
        return impl
    from vila_tpu_torch.ops.flash_attention import HEAD_DIM

    if q.is_cuda and q.dtype == torch.bfloat16 and q.shape[-1] == HEAD_DIM:
        return "flash"
    return "xla"


def _local_mask(b, sq, skv, causal, q_seg, kv_seg, device) -> Optional[torch.Tensor]:
    """(B or 1, Sq, Skv) bool, True = attend; None = all visible."""
    mask = None
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool, device=device).tril()[None]
    if q_seg is not None:
        seg = q_seg[:, :, None] == kv_seg[:, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _local_attention_with_lse(q, k, v, *, causal, q_segment_ids=None, kv_segment_ids=None,
                              scale=None, impl="auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in q's dtype, lse (B, Hq, Sq) f32, -1e30 on rows with no key)."""
    impl = _resolve_impl(impl, q)
    if impl == "flash":
        from vila_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids, scale=scale, return_lse=True)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if k.shape[1] > _XLA_CHUNK_THRESHOLD:
        return _chunked_attention_with_lse(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                                           kv_segment_ids=kv_segment_ids, scale=scale)
    mask = _local_mask(q.shape[0], q.shape[1], k.shape[1], causal, q_segment_ids,
                       kv_segment_ids, q.device)
    out, lse = _masked_with_lse(q, k, v, mask, scale)
    return out.to(q.dtype), lse


def _chunked_attention_with_lse(q, k, v, *, causal, q_segment_ids=None, kv_segment_ids=None,
                                scale=None, chunk: int = _XLA_KV_CHUNK):
    """The "xla" route over KV chunks with the online LSE merge (peak
    O(Sq · chunk)); the same masks and f32 statistics."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    out = torch.zeros((b, sq, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)
    for c0 in range(0, skv, chunk):
        c1 = min(c0 + chunk, skv)
        mask = None
        if causal:
            cols = torch.arange(c0, c1, device=q.device)
            mask = (rows[:, None] >= cols[None, :])[None]
        if kv_segment_ids is not None:
            seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, c0:c1]
            mask = seg if mask is None else mask & seg
        o, l = _masked_with_lse(q, k[:, c0:c1], v[:, c0:c1], mask, scale)
        out, lse = _merge(out, lse, o, l)
    return out.to(q.dtype), lse


def _masked_with_lse(q, k, v, mask, scale):
    """(out f32, lse) of f32 attention under a (B or 1, Sq, Skv) mask; a
    row with no key has lse -1e30 (and the mean of V as out, which no
    merge weighs)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if scale is None:
        scale = d ** -0.5
    qf = (q.float() * scale).reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if mask is not None:
        scores = torch.where(mask[:, None, None], scores, _NEG_INF)
    m = scores.amax(-1, keepdim=True).clamp_min(_NEG_INF)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p / l.clamp_min(1e-30), v.float())
    lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0].reshape(b, hq, sq)
    return o.reshape(b, sq, hq, d), torch.where(lse <= _NEG_INF / 2, _NEG_INF, lse)


def _block_bwd_xla(q, k, v, do, lse, delta, *, causal, q_segment_ids, kv_segment_ids, scale):
    """(dq, dk, dv) of one KV block from the merged LSE and delta: the f32
    reference of `flash_block_backward`."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(b, sq, hkv, g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    lse_r = lse.float().reshape(b, hkv, g, sq)
    row_valid = lse_r > _NEG_INF / 2
    p = torch.exp(s - torch.where(row_valid, lse_r, 0.0)[..., None])
    p = torch.where(row_valid[..., None], p, 0.0)
    mask = _local_mask(b, sq, skv, causal, q_segment_ids, kv_segment_ids, q.device)
    if mask is not None:
        p = torch.where(mask[:, None, None], p, 0.0)
    do_r = do.float().reshape(b, sq, hkv, g, d)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, do_r)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do_r, vf)
    ds = p * (dp - delta.float().reshape(b, hkv, g, sq)[..., None])
    dq = scale * torch.einsum("bhgqk,bkhd->bqhgd", ds, kf)
    dk = scale * torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    return dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _block_bwd(q, k, v, do, lse, delta, *, causal, q_segment_ids, kv_segment_ids, impl,
               scale=None):
    if impl == "flash":
        from vila_tpu_torch.ops.flash_attention import flash_block_backward

        return flash_block_backward(q, k, v, do, lse, delta, causal=causal,
                                    q_segment_ids=q_segment_ids,
                                    kv_segment_ids=kv_segment_ids, scale=scale)
    return _block_bwd_xla(q, k, v, do, lse, delta, causal=causal, q_segment_ids=q_segment_ids,
                          kv_segment_ids=kv_segment_ids, scale=scale)


def _merge(out, lse, o_new, lse_new):
    """Online softmax merge of two partial results (ring/utils.py:29-63):
    out (B, S, H, D), lse (B, H, S); a row at -1e30 carries no weight."""
    out, o_new = out.float(), o_new.float()
    m = torch.maximum(lse, lse_new)
    m_safe = torch.where(m <= _NEG_INF / 2, 0.0, m)
    w1 = torch.where(lse <= _NEG_INF / 2, 0.0, torch.exp(lse - m_safe))
    w2 = torch.where(lse_new <= _NEG_INF / 2, 0.0, torch.exp(lse_new - m_safe))
    denom = (w1 + w2).clamp_min(1e-30)
    w1b, w2b = w1.transpose(1, 2)[..., None], w2.transpose(1, 2)[..., None]
    merged = (out * w1b + o_new * w2b) / denom.transpose(1, 2)[..., None]
    new_lse = torch.where((w1 + w2) <= 0.0, _NEG_INF, m_safe + torch.log(denom))
    return merged, new_lse


# --------------------------------------------------------------------------
# Zigzag layout (host side)
# --------------------------------------------------------------------------


def zigzag_order(seq_len: int, n: int) -> np.ndarray:
    """Permutation such that a contiguous n-way split of x[..., order, ...]
    gives rank r the global chunks (r, 2n-1-r) of a 2n-chunk split."""
    assert seq_len % (2 * n) == 0, (seq_len, n)
    c = seq_len // (2 * n)
    chunks = np.arange(seq_len).reshape(2 * n, c)
    return np.concatenate([np.concatenate([chunks[r], chunks[2 * n - 1 - r]])
                           for r in range(n)])


def inverse_zigzag_order(seq_len: int, n: int) -> np.ndarray:
    order = zigzag_order(seq_len, n)
    inv = np.empty_like(order)
    inv[order] = np.arange(seq_len)
    return inv


# --------------------------------------------------------------------------
# The ring's steps (plain functions of src / my, as the JAX package's)
# --------------------------------------------------------------------------


def _ring_step_fwd(q, k_cur, v_cur, q_seg, kv_seg_cur, *, src: int, my: int, causal: bool,
                   impl: str, layout: str, scale=None):
    """One ring step's partial (out f32, lse) on rank `my`, K/V from `src`."""
    b, s_loc, hq, d = q.shape
    half = s_loc // 2

    def attend(qq, kk, vv, qs, ks, causal_):
        o, l = _local_attention_with_lse(qq, kk, vv, causal=causal_, q_segment_ids=qs,
                                         kv_segment_ids=ks, impl=impl, scale=scale)
        return o.float(), l

    if not causal:
        return attend(q, k_cur, v_cur, q_seg, kv_seg_cur, False)
    if src == my:
        return attend(q, k_cur, v_cur, q_seg, kv_seg_cur, True)
    if layout == "zigzag":
        if src < my:  # K/V's first chunk precedes all of q; its second follows it
            return attend(q, k_cur[:, :half], v_cur[:, :half], q_seg,
                          None if kv_seg_cur is None else kv_seg_cur[:, :half], False)
        # src > my: only q's second chunk follows both of src's chunks
        o, l = attend(q[:, half:], k_cur, v_cur, None if q_seg is None else q_seg[:, half:],
                      kv_seg_cur, False)
        o_f = torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=q.device)
        o_f[:, half:] = o
        l_f = torch.full((b, hq, s_loc), _NEG_INF, dtype=torch.float32, device=q.device)
        l_f[:, :, half:] = l
        return o_f, l_f
    if src < my:
        return attend(q, k_cur, v_cur, q_seg, kv_seg_cur, False)
    return (torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=q.device),
            torch.full((b, hq, s_loc), _NEG_INF, dtype=torch.float32, device=q.device))


def _ring_step_bwd(q, k_cur, v_cur, do, lse, delta, q_seg, kv_seg_cur, *, src: int, my: int,
                   causal: bool, impl: str, layout: str):
    """One ring step's (dq, dk, dv) contributions, f32, local shapes."""
    b, s_loc, hq, d = q.shape
    hkv = k_cur.shape[2]
    half = s_loc // 2
    f32 = torch.float32

    def bb(qq, kk, vv, ddo, ll, dd, causal_, qs, ks):
        dq, dk, dv = _block_bwd(qq, kk, vv, ddo, ll, dd, causal=causal_, q_segment_ids=qs,
                                kv_segment_ids=ks, impl=impl)
        return dq.float(), dk.float(), dv.float()

    if not causal:
        return bb(q, k_cur, v_cur, do, lse, delta, False, q_seg, kv_seg_cur)
    if src == my:
        return bb(q, k_cur, v_cur, do, lse, delta, True, q_seg, kv_seg_cur)
    if layout == "zigzag":
        if src < my:
            dq, dk_h, dv_h = bb(q, k_cur[:, :half], v_cur[:, :half], do, lse, delta, False,
                                q_seg, None if kv_seg_cur is None else kv_seg_cur[:, :half])
            dk = torch.zeros((b, s_loc, hkv, d), dtype=f32, device=q.device)
            dv = torch.zeros_like(dk)
            dk[:, :half], dv[:, :half] = dk_h, dv_h
            return dq, dk, dv
        dq_h, dk, dv = bb(q[:, half:], k_cur, v_cur, do[:, half:], lse[:, :, half:],
                          delta[:, :, half:], False,
                          None if q_seg is None else q_seg[:, half:], kv_seg_cur)
        dq = torch.zeros((b, s_loc, hq, d), dtype=f32, device=q.device)
        dq[:, half:] = dq_h
        return dq, dk, dv
    if src < my:
        return bb(q, k_cur, v_cur, do, lse, delta, False, q_seg, kv_seg_cur)
    z = torch.zeros((b, s_loc, hkv, d), dtype=f32, device=q.device)
    return torch.zeros((b, s_loc, hq, d), dtype=f32, device=q.device), z, z.clone()


def _rotate(tensors: Sequence[Optional[torch.Tensor]], group) -> List[Optional[torch.Tensor]]:
    """Each tensor from this rank to the next of `group` and from the
    previous into a new buffer: one `batch_isend_irecv` in which every
    rank posts all its sends and receives (None passes through). A group
    of one rank keeps its tensors."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    ops, out = [], []
    for i, t in enumerate(tensors):
        if t is None:
            out.append(None)
            continue
        t = t.contiguous()
        buf = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, nxt, group, tag=i))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group, tag=i))
        out.append(buf)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _ring_fwd(q, k, v, q_seg, kv_seg, group, causal, impl, layout):
    n, my = dist.get_world_size(group), dist.get_rank(group)
    b, s_loc, hq, d = q.shape
    out = torch.zeros((b, s_loc, hq, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, hq, s_loc), _NEG_INF, dtype=torch.float32, device=q.device)
    k_cur, v_cur, seg_cur = k, v, kv_seg
    for step in range(n):
        o_new, l_new = _ring_step_fwd(q, k_cur, v_cur, q_seg, seg_cur, src=(my - step) % n,
                                      my=my, causal=causal, impl=impl, layout=layout)
        out, lse = _merge(out, lse, o_new, l_new)
        if step < n - 1:
            k_cur, v_cur, seg_cur = _rotate((k_cur, v_cur, seg_cur), group)
    return out, lse


class _Ring(torch.autograd.Function):
    """The ring's forward and its O(S_local) backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, group, causal, impl, layout):
        out, lse = _ring_fwd(q, k, v, q_seg, kv_seg, group, causal, impl, layout)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.args = (group, causal, impl, layout)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        group, causal, impl, layout = ctx.args
        n, my = dist.get_world_size(group), dist.get_rank(group)
        do = do.to(q.dtype).contiguous()
        # delta = rowsum(dO * O) over the head dim, (B, Hq, S_local)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur, seg_cur = k, v, kv_seg
        for step in range(n):
            dq_p, dk_p, dv_p = _ring_step_bwd(q, k_cur, v_cur, do, lse, delta, q_seg, seg_cur,
                                              src=(my - step) % n, my=my, causal=causal,
                                              impl=impl, layout=layout)
            dq += dq_p
            dk, dv = dk + dk_p, dv + dv_p
            # dK/dV travel with their K/V shard; after the last step they are
            # one hop from the shard's owner
            if step < n - 1:
                k_cur, v_cur, seg_cur, dk, dv = _rotate((k_cur, v_cur, seg_cur, dk, dv), group)
            else:
                dk, dv = _rotate((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None, None,
                None)


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group, *,
                         causal: bool = True, q_segment_ids: Optional[torch.Tensor] = None,
                         kv_segment_ids: Optional[torch.Tensor] = None, impl: str = "auto",
                         layout: str = "contiguous") -> torch.Tensor:
    """Exact attention over a sequence sharded over `group`;
    differentiable. q (B, S_local, Hq, D), k / v (B, S_local, Hkv, D),
    segment ids (B, S_local) int32."""
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout: {layout}")
    if layout == "zigzag" and q.shape[1] % 2 != 0:
        raise ValueError("zigzag layout needs an even local sequence length")
    impl = _resolve_impl(impl, q)
    return _Ring.apply(q, k, v, q_segment_ids, kv_segment_ids, group, causal, impl, layout)


def expand_kv_heads(k: torch.Tensor, v: torch.Tensor, target_heads: int):
    """Repeat K/V heads so that they divide the Ulysses degree
    (_ExpandKVFunction, ulysses_attn.py:26-94)."""
    hkv = k.shape[2]
    if target_heads <= hkv:
        return k, v
    if target_heads % hkv != 0:
        raise ValueError(f"cannot expand {hkv} KV heads to {target_heads} (not divisible)")
    reps = target_heads // hkv
    return k.repeat_interleave(reps, dim=2), v.repeat_interleave(reps, dim=2)


def _a2a(x: torch.Tensor, group, scatter_heads: bool) -> torch.Tensor:
    """JAX's tiled `all_to_all`: scatter_heads (B, S/n, H, D) -> (B, S,
    H/n, D) (heads split, sequence gathered in rank order), else the
    inverse."""
    n = dist.get_world_size(group)
    if scatter_heads:
        b, s, h, d = x.shape
        send = x.reshape(b, s, n, h // n, d).permute(2, 0, 1, 3, 4).contiguous()
    else:
        b, s, h, d = x.shape
        send = x.reshape(b, n, s // n, h, d).permute(1, 0, 2, 3, 4).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if scatter_heads:  # recv[j]: rank j's tokens, my heads
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * s, h // n, d)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, s // n, n * h, d)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, scatter_heads):
        ctx.args = (group, scatter_heads)
        return _a2a(x, group, scatter_heads)

    @staticmethod
    def backward(ctx, g):
        group, scatter_heads = ctx.args
        return _a2a(g.contiguous(), group, not scatter_heads), None, None


def _local_attention(q, k, v, *, causal, q_segment_ids, kv_segment_ids, impl):
    """Differentiable local attention (no LSE)."""
    if _resolve_impl(impl, q) == "flash":
        from vila_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                               kv_segment_ids=kv_segment_ids)
    from vila_tpu_torch.ops.attention import attention_xla

    return attention_xla(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                         kv_segment_ids=kv_segment_ids)


def _ulysses_in(q, k, v, q_segment_ids, kv_segment_ids, group):
    n = dist.get_world_size(group)
    hq = q.shape[2]
    if hq % n != 0:
        raise ValueError(f"Ulysses degree {n} must divide the {hq} query heads "
                         "(reference replicates KV heads only: ulysses_attn.py:26)")
    k, v = expand_kv_heads(k, v, n if k.shape[2] < n else k.shape[2])
    qg, kg, vg = (_AllToAll.apply(x, group, True) for x in (q, k, v))
    q_seg = kv_seg = None
    if q_segment_ids is not None:
        q_seg = gather_tensor(q_segment_ids, 1, group)
        kv_seg = gather_tensor(kv_segment_ids, 1, group)
    return qg, kg, vg, q_seg, kv_seg


def ulysses_attention(q, k, v, group, *, causal: bool = True, q_segment_ids=None,
                      kv_segment_ids=None, impl: str = "auto") -> torch.Tensor:
    """DeepSpeed-Ulysses attention (ulysses_attn.py:97-178): all-to-all
    heads for sequence, local attention over the whole sequence, inverse
    all-to-all. Differentiable."""
    qg, kg, vg, q_seg, kv_seg = _ulysses_in(q, k, v, q_segment_ids, kv_segment_ids, group)
    out = _local_attention(qg, kg, vg, causal=causal, q_segment_ids=q_seg,
                           kv_segment_ids=kv_seg, impl=impl)
    return _AllToAll.apply(out, group, False)


def hybrid_attention(q, k, v, ulysses_group, ring_group, *, causal: bool = True,
                     q_segment_ids=None, kv_segment_ids=None, impl: str = "auto",
                     ring_layout: str = "contiguous") -> torch.Tensor:
    """MM-SP 2D attention (HybridAttention, hybrid_attn.py:93-190):
    Ulysses inside, the ring outside. Differentiable."""
    qg, kg, vg, q_seg, kv_seg = _ulysses_in(q, k, v, q_segment_ids, kv_segment_ids,
                                            ulysses_group)
    out = ring_flash_attention(qg, kg, vg, ring_group, causal=causal, q_segment_ids=q_seg,
                               kv_segment_ids=kv_seg, impl=impl, layout=ring_layout)
    return _AllToAll.apply(out, ulysses_group, False)
