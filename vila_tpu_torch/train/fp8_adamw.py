"""AdamW with fp8 moments, as `vila_tpu/train/fp8_adamw.py` (capability
parity: COAT's `CoatAdamW`, llava/model/coat/optimizer/fp8_adamw.py:33).

The first moment is stored in E4M3 and the second in E5M2, each with an f32
scale per block of 128 (`ops/fp8.quantize_blockwise`): about a quarter of
AdamW's f32 moments. A step dequantizes both, updates them in f32 and
quantizes them again; the bias corrections are 1 − b**count in f32.

`scale_by_fp8_adam` is the JAX transformation on a list of tensors
(`init`, `update` -> (steps, state)); `FP8AdamW` is the same arithmetic as
a `torch.optim.Optimizer` over `.grad`, with optax's `fp8_adamw` chain
after the scaling: weight decay (`step + wd * p`), then the learning rate
(`p += -lr * u`). Its `state_dict` carries the moments' fp8 bytes and
scales, so a run resumes exactly. The passes are eager PyTorch ops, leaf
by leaf.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from vila_tpu_torch.ops.fp8 import (
    DEFAULT_BLOCK,
    E4M3,
    E5M2,
    dequantize_blockwise,
    quantize_blockwise,
)


class QMoment(NamedTuple):
    q: torch.Tensor  # (nb, block) fp8
    scale: torch.Tensor  # (nb,) f32


class FP8AdamWState(NamedTuple):
    count: int
    mu: List[QMoment]
    nu: List[QMoment]


def _quant(x: torch.Tensor, dtype, block: int) -> QMoment:
    q, s, _ = quantize_blockwise(x, dtype, block)
    return QMoment(q, s)


def _zeros(p: torch.Tensor, block: int) -> Tuple[QMoment, QMoment]:
    z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return _quant(z, E4M3, block), _quant(z, E5M2, block)


def _corrections(count: int, b1: float, b2: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 − b1**count and 1 − b2**count in f32 (device tensors, so that the
    card divides by them exactly)."""
    n = torch.tensor(float(count), dtype=torch.float32, device=device)
    b = torch.tensor([b1, b2], dtype=torch.float32, device=device)
    c = 1.0 - b.pow(n)
    return c[0], c[1]


def _adam_leaf(g: torch.Tensor, mu: QMoment, nu: QMoment, b1: float, b2: float,
               eps: float, c1: torch.Tensor, c2: torch.Tensor, block: int):
    """(step in g's dtype, new mu, new nu) of one leaf."""
    g32 = g.float()
    m = b1 * dequantize_blockwise(mu.q, mu.scale, g.shape) + (1.0 - b1) * g32
    v = b2 * dequantize_blockwise(nu.q, nu.scale, g.shape) + (1.0 - b2) * g32.square()
    step = (m / c1) / ((v / c2).sqrt() + eps)
    return step.to(g.dtype), _quant(m, E4M3, block), _quant(v, E5M2, block)


class ScaleByFP8Adam(NamedTuple):
    init: object
    update: object


def scale_by_fp8_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                      block: int = DEFAULT_BLOCK) -> ScaleByFP8Adam:
    """Adam scaling with E4M3 mu / E5M2 nu (per-block scales) over a list
    of tensors: `init(params) -> state`, `update(grads, state) -> (steps,
    state)`."""

    def init(params: Sequence[torch.Tensor]) -> FP8AdamWState:
        zs = [_zeros(p, block) for p in params]
        return FP8AdamWState(0, [z[0] for z in zs], [z[1] for z in zs])

    def update(grads: Sequence[torch.Tensor], state: FP8AdamWState):
        count = state.count + 1
        if not grads:
            return [], FP8AdamWState(count, [], [])
        c1, c2 = _corrections(count, b1, b2, grads[0].device)
        out = [_adam_leaf(g, m, n, b1, b2, eps, c1, c2, block)
               for g, m, n in zip(grads, state.mu, state.nu)]
        return ([o[0] for o in out],
                FP8AdamWState(count, [o[1] for o in out], [o[2] for o in out]))

    return ScaleByFP8Adam(init, update)


class FP8AdamW(torch.optim.Optimizer):
    """`fp8_adamw` as a `torch.optim.Optimizer`: each parameter's state is
    its update count and its moments (`mu`, `mu_scale` E4M3; `nu`,
    `nu_scale` E5M2). `step()` reads `.grad` (a parameter without one
    steps with a zero gradient) and updates in place."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, block: int = DEFAULT_BLOCK):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, block=block))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            block, wd, lr = group["block"], group["weight_decay"], group["lr"]
            corrections = {}
            for p in group["params"]:
                st = self.state[p]
                if not st:
                    mu, nu = _zeros(p, block)
                    st.update(count=0, mu=mu.q, mu_scale=mu.scale, nu=nu.q, nu_scale=nu.scale)
                st["count"] += 1
                key = (st["count"], p.device)
                if key not in corrections:
                    corrections[key] = _corrections(st["count"], b1, b2, p.device)
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                step, mu, nu = _adam_leaf(
                    g, QMoment(st["mu"], st["mu_scale"]), QMoment(st["nu"], st["nu_scale"]),
                    b1, b2, group["eps"], *corrections[key], block)
                st.update(mu=mu.q, mu_scale=mu.scale, nu=nu.q, nu_scale=nu.scale)
                if wd:
                    step = step + wd * p
                p.add_(step * -lr)


def fp8_adamw(params, learning_rate: float = 1e-3, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, weight_decay: float = 0.0,
              block: int = DEFAULT_BLOCK) -> FP8AdamW:
    """Drop-in AdamW with fp8 moment storage over `params`."""
    return FP8AdamW(params, lr=learning_rate, betas=(b1, b2), eps=eps,
                    weight_decay=weight_decay, block=block)
