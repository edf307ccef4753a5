"""MM-SP inside the decoder, as `vila_tpu/parallel/sp.py`:
`qwen2.forward(..., sp=SPConfig)` routes every cache-free attention
through `sp_attention`, which runs the ring, Ulysses or their hybrid over
the mesh's sequence dims.

Where the JAX package's `sp_attention` takes global arrays inside `jit`
and `shard_map`s them, here every rank calls the forward on its own shard:
rows of its dp coordinate and the sequence slice of its (sp, su)
coordinate, ring major (`distributed.host_local_batch`). Positions always
come with the batch (RoPE phases travel with their tokens).

The zigzag layout: the host permutes each row with `zigzag_order(S,
ring)` before slicing (`zigzag_batch`), so that ring rank r holds global
chunks (r, 2·ring-1-r) (ring/zigzag_ring_flash_attn_varlen.py:31-63);
labels are shifted before the permutation, and the loss then takes them
unshifted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from vila_tpu_torch.parallel.ring_attention import (
    hybrid_attention,
    ring_flash_attention,
    ulysses_attention,
    zigzag_order,
)


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """The sequence-parallel plan threaded into `qwen2.forward`: the ring
    dim (`ring_axis`, outer), the Ulysses dim (`ulysses_axis`, inner) and
    the head dim (None: heads replicated; tp is not ported). The batch dim
    needs no name: every rank forwards its own rows."""

    mesh: object  # parallel.mesh.Mesh
    ring_axis: str = "sp"
    ulysses_axis: str = "su"
    head_axis: Optional[str] = None
    ring_layout: str = "zigzag"  # "contiguous" | "zigzag"
    impl: str = "auto"

    @property
    def ring_degree(self) -> int:
        return self.mesh.shape.get(self.ring_axis, 1)

    @property
    def ulysses_degree(self) -> int:
        return self.mesh.shape.get(self.ulysses_axis, 1)

    @property
    def degree(self) -> int:
        return self.ring_degree * self.ulysses_degree

    @property
    def active(self) -> bool:
        return self.degree > 1

    def layout_for(self, seq_len: int) -> str:
        """The ring layout for a global sequence of `seq_len`: zigzag needs
        each ring shard to split in half, else contiguous."""
        if self.ring_layout != "zigzag" or self.ring_degree == 1:
            return "contiguous"
        if seq_len % (2 * self.degree) != 0:
            return "contiguous"
        return "zigzag"


def sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp: SPConfig, *,
                 causal: bool = True, segment_ids: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over this rank's shard: q (B, S_local,
    Hq, D), k / v (B, S_local, Hkv, D), segment ids (B, S_local).
    Differentiable: the ring carries its own backward, the all-to-alls are
    their own inverses."""
    if scale is not None and abs(scale - q.shape[-1] ** -0.5) > 1e-12:
        raise ValueError("sp_attention takes the default scale only")
    if sp.head_axis is not None:
        raise NotImplementedError("head_axis: tensor parallelism is not ported")
    n_u, n_r = sp.ulysses_degree, sp.ring_degree
    hq = q.shape[2]
    if n_u > 1 and hq % n_u != 0:
        raise ValueError(
            f"Ulysses degree {n_u} must divide the {hq} local query heads "
            f"(reference replicates KV heads only: ulysses_attn.py:26)")
    layout = sp.layout_for(q.shape[1] * sp.degree)
    seg = None if segment_ids is None else segment_ids.to(torch.int32)
    kw = dict(causal=causal, q_segment_ids=seg, kv_segment_ids=seg, impl=sp.impl)
    mesh = sp.mesh
    if n_u > 1 and n_r > 1:
        return hybrid_attention(q, k, v, mesh.group(sp.ulysses_axis), mesh.group(sp.ring_axis),
                                ring_layout=layout, **kw)
    if n_u > 1:
        return ulysses_attention(q, k, v, mesh.group(sp.ulysses_axis), **kw)
    return ring_flash_attention(q, k, v, mesh.group(sp.ring_axis), layout=layout, **kw)


# --------------------------------------------------------------------------
# Host-side batch layout for the zigzag ring
# --------------------------------------------------------------------------

SEQ_KEYS = ("input_ids", "labels", "positions", "segment_ids", "token_valid")


def shift_labels(labels: np.ndarray, ignore_index: int = -100) -> np.ndarray:
    """labels[i] := labels[i+1] (the next-token target at position i)."""
    out = np.full_like(labels, ignore_index)
    out[:, :-1] = labels[:, 1:]
    return out


def zigzag_batch(batch: Dict[str, np.ndarray], sp: SPConfig) -> Dict[str, np.ndarray]:
    """A collated global batch in the zigzag ring layout (host side):
    every per-token array permuted with `zigzag_order(S, ring)`, labels
    shifted first (array order is no longer causal order), media positions
    remapped. A batch whose length takes the contiguous layout is
    returned as it is."""
    seq_arrays = [batch[k] for k in SEQ_KEYS if k in batch]
    if not seq_arrays:
        return batch
    s = seq_arrays[0].shape[1]
    if sp.layout_for(s) != "zigzag":
        return batch
    order = zigzag_order(s, sp.ring_degree)
    inv = np.empty_like(order)
    inv[order] = np.arange(s)
    out = dict(batch)
    if "labels" in out:
        out["labels"] = shift_labels(out["labels"])
    for key in SEQ_KEYS:
        if key in out:
            out[key] = np.ascontiguousarray(out[key][:, order])
    mp = out.get("media_positions")
    if mp is not None:  # row-local indices; the sentinels stay out of range
        out["media_positions"] = np.where(mp < s, inv[np.clip(mp, 0, s - 1)], mp)
    return out


def layout_batch(batch: Dict[str, np.ndarray], sp: Optional[SPConfig]) -> Dict[str, np.ndarray]:
    """A global host batch laid out for a sequence-parallel step: the
    zigzag layout's `zigzag_batch`, or in the contiguous layout the labels
    shifted (a rank cannot see the next shard's first label). Unchanged
    without an active plan."""
    if sp is None or not sp.active or "input_ids" not in batch:
        return batch
    if sp.layout_for(batch["input_ids"].shape[1]) == "zigzag":
        return zigzag_batch(batch, sp)
    out = dict(batch)
    if "labels" in out:
        out["labels"] = shift_labels(out["labels"])
    return out


def unzigzag_logits(logits: torch.Tensor, sp: SPConfig) -> torch.Tensor:
    """Undo the zigzag permutation on a global (B, S, ...) tensor."""
    s = logits.shape[1]
    if sp.layout_for(s) != "zigzag":
        return logits
    inv = np.empty(s, np.int64)
    inv[zigzag_order(s, sp.ring_degree)] = np.arange(s)
    return logits[:, torch.as_tensor(inv, device=logits.device)]
