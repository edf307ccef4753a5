"""Megatron-style tensor parallelism over the mesh's tp dim: what GSPMD
derives in the JAX package from the "tp" entries of its specs
(`vila_tpu/parallel/mesh.py:84-103,132-138`), written by hand.

A rank holds the tp chunk of every weight dim its spec splits over tp
(`parallel/mesh.py`), and the forward keeps each activation in one of
three states: replicated (the same on every tp rank), split along its last
dim, or partial (the tp ranks' tensors sum to it). The pieces:

  * a column-parallel linear: a replicated input through `copy_to` (the
    identity; its backward all-reduces the input's gradient), times the
    rank's columns (its bias split with them): a split output;
  * a row-parallel linear: a split input times the rank's rows, then
    `reduce_from` (an all-reduce; its backward the identity): replicated;
  * a vocab-parallel embedding: a masked lookup in the rank's rows of the
    table, then an all-reduce;
  * a vocab-parallel cross entropy (`vocab_nll`) over the rank's logit
    columns: the row max (all-reduce MAX), then the sum of exponentials and
    the target's logit (one all-reduce SUM), with `z_loss`; its backward
    needs no collective;
  * `gather_from` / `scatter_to` move a tensor between split and replicated
    (all-gather forward, slice backward, and the reverse).

Each piece is a plain function of the rank's shard (`embedding_partial`,
`nll_stats`, `nll_from_stats`, `nll_grad`), with the collective kept
apart, so that a caller can run several ranks in turn; the autograd
functions put the two together over the tp group. A weight dim that tp
does not divide stays whole (the specs' fallback, `TPConfig.splits`), and
attention runs over the rank's heads only when both head counts divide
(`heads_split`, as `vila_tpu/parallel/sp.py:124-126`): otherwise q, k and
v are gathered whole before attention and the output sliced for the
row-parallel o projection. The numbers are GSPMD's either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TPConfig:
    """The tensor-parallel plan threaded into the forward: the mesh, whose
    tp dim the weights and heads split over."""

    mesh: Any  # parallel.mesh.Mesh

    @property
    def size(self) -> int:
        return self.mesh.shape["tp"]

    @property
    def rank(self) -> int:
        return self.mesh.axis_index("tp")

    @property
    def group(self):
        return self.mesh.group("tp")

    @property
    def active(self) -> bool:
        return self.size > 1

    def splits(self, n: int) -> bool:
        """Whether a weight dim of size n is cut over tp (the specs'
        divisibility rule)."""
        return self.active and n % self.size == 0

    def heads_split(self, hq: int, hkv: int) -> bool:
        """Whether attention runs over this rank's heads: both head counts
        divide tp."""
        return self.splits(hq) and self.splits(hkv)


def active(tp: Optional[TPConfig]) -> bool:
    return tp is not None and tp.active


def amax_group(tp: Optional[TPConfig]):
    """The group a per-tensor fp8 scale of an activation or a gradient is
    taken over on a mesh: every rank (each holds a part of it or a copy;
    GSPMD's max over the whole array); None on one rank."""
    if tp is None or tp.mesh.size == 1:
        return None
    return dist.group.WORLD


def plan_for(mesh) -> Optional[TPConfig]:
    """The plan of a mesh whose tp dim is larger than 1, else None."""
    tp = TPConfig(mesh)
    return tp if tp.active else None


def check_divides(dims_sizes, tp: Optional[TPConfig]) -> None:
    """Raise when tp > 1 divides none of the model's split dims: every
    weight would stay whole and every rank repeat the same work."""
    if active(tp) and not any(tp.splits(n) for n in dims_sizes):
        raise ValueError(f"tp={tp.size} divides none of the model's dims {sorted(set(dims_sizes))}:"
                         " no weight would be split")


# --------------------------------------------------------------------------
# collectives over the tp group
# --------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, tp: TPConfig, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x summed (or reduced by `op`) over the tp ranks, in place."""
    if tp.size > 1:
        dist.all_reduce(x, op=op, group=tp.group)
    return x


def all_gather_last(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """Every tp rank's x concatenated along the last dim."""
    from vila_tpu_torch.parallel.mesh import gather_tensor

    return gather_tensor(x.contiguous(), x.ndim - 1, tp.group)


def local_slice(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """This rank's chunk of the last dim."""
    n = x.shape[-1] // tp.size
    return x[..., tp.rank * n:(tp.rank + 1) * n]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.tp), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, ctx.tp).contiguous(), None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return local_slice(x, tp).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_last(g, ctx.tp), None


def copy_to(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """Replicated input of column-parallel products: the identity, whose
    backward sums the ranks' partial gradients."""
    return _CopyTo.apply(x, tp)


def reduce_from(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """A partial tensor summed over the ranks (row-parallel output)."""
    return _ReduceFrom.apply(x, tp)


def gather_from(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """A tensor split along its last dim, made whole on every rank."""
    return _GatherFrom.apply(x, tp)


def scatter_to(x: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """A replicated tensor cut to this rank's chunk of its last dim."""
    return _ScatterTo.apply(x, tp)


class _GatherDim(torch.autograd.Function):
    """A leaf split over tp along `dim`, whole on every rank; backward:
    the rank's chunk of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, tp):
        from vila_tpu_torch.parallel.mesh import gather_tensor

        ctx.args = (dim, tp)
        return gather_tensor(x, dim, tp.group)

    @staticmethod
    def backward(ctx, g):
        dim, tp = ctx.args
        return g.chunk(tp.size, dim)[tp.rank].contiguous(), None, None


def gather_leaf(x: torch.Tensor, dim: int, tp: TPConfig) -> torch.Tensor:
    """A weight split over tp along `dim` made whole (differentiable) for
    a module that runs replicated over tp."""
    return _GatherDim.apply(x, dim, tp)


# --------------------------------------------------------------------------
# vocab-parallel embedding and cross entropy: the per-rank pieces
# --------------------------------------------------------------------------


def vocab_start(tp: TPConfig, v_local: int) -> int:
    return tp.rank * v_local


def embedding_partial(ids: torch.Tensor, table: torch.Tensor, start: int) -> torch.Tensor:
    """This rank's part of an embedding lookup: the rows of the ids in
    [start, start + rows), zeros for the others."""
    local = ids.long() - start
    inside = (local >= 0) & (local < table.shape[0])
    out = table[torch.where(inside, local, 0)]
    return torch.where(inside[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def nll_stats(logits: torch.Tensor, targets: torch.Tensor, start: int,
              m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Given the global row max `m`, this rank's (sum of exp(logit - m),
    target logit or 0 where the target is another rank's)."""
    l = logits.float()
    se = torch.exp(l - m[..., None]).sum(-1)
    local = targets.long() - start
    inside = (local >= 0) & (local < l.shape[-1])
    tl = l.gather(-1, torch.where(inside, local, 0)[..., None])[..., 0]
    return se, torch.where(inside, tl, 0.0)


def nll_from_stats(m, se, tl, valid, z_loss: float):
    """Per-token NLL from the summed stats (0 where not valid) and log Z."""
    logz = m + torch.log(se)
    nll = logz - tl
    if z_loss > 0.0:
        nll = nll + z_loss * logz.square()
    return torch.where(valid, nll, 0.0), logz


def nll_grad(logits, targets, start, logz, valid, g, z_loss: float) -> torch.Tensor:
    """d(sum g * nll) / d(this rank's logits): softmax times g (1 + 2 z
    log Z), less g at the target."""
    l = logits.float()
    p = torch.exp(l - logz[..., None])
    coef = torch.where(valid, g * (1.0 + 2.0 * z_loss * logz), 0.0)
    grad = p * coef[..., None]
    local = targets.long() - start
    inside = (local >= 0) & (local < l.shape[-1]) & valid
    idx = torch.where(inside, local, 0)[..., None]
    grad.scatter_add_(-1, idx, torch.where(inside, -g, 0.0)[..., None])
    return grad.to(logits.dtype)


class _VocabNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, valid, tp, z_loss):
        start = vocab_start(tp, logits.shape[-1])
        m = all_reduce(logits.detach().float().amax(-1), tp, dist.ReduceOp.MAX)
        se, tl = nll_stats(logits, targets, start, m)
        both = all_reduce(torch.stack([se, tl]), tp)
        nll, logz = nll_from_stats(m, both[0], both[1], valid, z_loss)
        ctx.save_for_backward(logits, targets, valid, logz)
        ctx.args = (start, z_loss)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, targets, valid, logz = ctx.saved_tensors
        start, z_loss = ctx.args
        return nll_grad(logits, targets, start, logz, valid, g.float(), z_loss), \
            None, None, None, None


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor,
              tp: TPConfig, z_loss: float = 0.0) -> torch.Tensor:
    """Per-token negative log-likelihood (0 where not `valid`) over this
    rank's vocabulary columns of the logits, the same on every tp rank."""
    return _VocabNLL.apply(logits, targets, valid, tp, z_loss)


def vocab_embedding(ids: torch.Tensor, table: torch.Tensor, tp: TPConfig) -> torch.Tensor:
    """The embedding of `ids` from this rank's rows of the table: a masked
    lookup summed over the ranks."""
    return reduce_from(embedding_partial(ids, table, vocab_start(tp, table.shape[0])), tp)


def vocab_plan(tp: Optional[TPConfig], vocab_size: int) -> Optional[TPConfig]:
    """The plan under which the logits are vocab-parallel, else None."""
    return tp if active(tp) and tp.splits(vocab_size) else None
