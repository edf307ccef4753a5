"""AdamW with per-component learning rates, clipping and freezing, as
`vila_tpu/train/optimizer.py` (`optax.multi_transform` over the "llm",
"vision_tower" and "mm_projector" subtrees).

Semantics kept from optax, component by component:
  * each tuned component is clipped by its own global norm,
    g * max_norm / max(norm, max_norm) (`clip_by_global_norm` sits inside
    each branch), then takes an AdamW step: bias-corrected moments, eps
    outside the square root, decoupled weight decay lr * wd * p;
  * the learning rate is the schedule at the update count before it is
    incremented (`warmup_cosine_decay_schedule(0, peak, ...)` gives the
    first update lr 0);
  * a frozen component (`set_to_zero`) keeps its parameters.
The AdamW step is `torch.optim.AdamW` (fused on the card), whose update is
optax's, or with `optimizer="fp8_adamw"` `train/fp8_adamw.FP8AdamW` (fp8
moments); parameters and moments are updated in place. A parameter that
received no gradient (unused in the forward) steps with a zero gradient, as
optax's dense tree does.

`adamw` / `adam` are the same step over any tree of tensors (dicts, lists,
tuples), one learning rate or schedule for all of it: what the JAX
package's LoRA, DPO, reward, PPO and SFT steps take from optax.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional

import torch

COMPONENTS = ("llm", "vision_tower", "mm_projector")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    vision_tower_lr: Optional[float] = None
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    schedule: str = "cosine"  # cosine | linear | constant
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"  # adamw | fp8_adamw (COAT-parity fp8 moments)
    tune_language_model: bool = True
    tune_vision_tower: bool = True
    tune_mm_projector: bool = True


def make_schedule(cfg: OptimizerConfig, peak_lr: float) -> Callable[[int], float]:
    """count -> learning rate, as optax's schedules."""
    warmup = max(int(cfg.warmup_ratio * cfg.total_steps), 1)
    if cfg.schedule == "cosine":
        # optax.warmup_cosine_decay_schedule(0, peak, warmup, decay_steps)
        decay_steps = max(cfg.total_steps, warmup + 1)

        def cosine(count: int) -> float:
            if count < warmup:
                return peak_lr * count / warmup
            frac = min(count - warmup, decay_steps - warmup) / (decay_steps - warmup)
            return peak_lr * 0.5 * (1.0 + math.cos(math.pi * frac))

        return cosine
    if cfg.schedule == "linear":
        # join of linear 0 -> peak over warmup and peak -> 0 after it
        rest = max(cfg.total_steps - warmup, 1)

        def linear(count: int) -> float:
            if count < warmup:
                return peak_lr * count / warmup
            return peak_lr * (1.0 - min(count - warmup, rest) / rest)

        return linear
    return lambda count: peak_lr


def leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict / list / tuple tree, dicts in key
    order (jax.tree's order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32), on the device."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


def _adam_step(ts: List[torch.Tensor], optimizer: str, b1: float, b2: float, eps: float,
               weight_decay: float) -> torch.optim.Optimizer:
    """The in-place AdamW (or fp8 AdamW) over `ts`, learning rate set per
    step."""
    if optimizer == "fp8_adamw":
        from vila_tpu_torch.train.fp8_adamw import FP8AdamW

        return FP8AdamW(ts, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)
    if optimizer != "adamw":
        raise ValueError(f"optimizer must be 'adamw' or 'fp8_adamw', got {optimizer!r}")
    return torch.optim.AdamW(ts, lr=0.0, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay, fused=ts[0].is_cuda or None)


def _fill_grads(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    for t in ts:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    return [t.grad for t in ts]


@dataclasses.dataclass
class OptState:
    """The update count and one in-place optimizer (`torch.optim.AdamW` or
    `FP8AdamW`) per tuned component, bound to that component's tensors."""

    count: int
    adamw: Dict[str, torch.optim.Optimizer]

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count,
                "adamw": {name: opt.state_dict() for name, opt in self.adamw.items()}}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.count = int(state["count"])
        for name, opt in self.adamw.items():
            opt.load_state_dict(state["adamw"][name])


class Optimizer:
    """`make_optimizer`'s result: `init(params)` builds the state,
    `update(opt_state, params)` applies one step from the gradients in each
    tensor's `.grad` (in place)."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        tuned = {"llm": cfg.tune_language_model, "vision_tower": cfg.tune_vision_tower,
                 "mm_projector": cfg.tune_mm_projector}
        peaks = {"llm": cfg.learning_rate,
                 "vision_tower": cfg.vision_tower_lr or cfg.learning_rate,
                 "mm_projector": cfg.mm_projector_lr or cfg.learning_rate}
        self.schedules = {name: make_schedule(cfg, peaks[name])
                          for name in COMPONENTS if tuned[name]}

    def init(self, params: Dict[str, Any]) -> OptState:
        cfg = self.cfg
        return OptState(count=0, adamw={
            name: _adam_step(leaves(params[name]), cfg.optimizer, cfg.b1, cfg.b2, cfg.eps,
                             cfg.weight_decay)
            for name in self.schedules})

    def update(self, opt_state: OptState, params: Dict[str, Any],
               norm: Optional[Callable[[str, List[torch.Tensor]], torch.Tensor]] = None
               ) -> OptState:
        """One step; `norm(component, grads)` is the global norm each
        component is clipped by (default `global_norm`; a sharded step
        gives the norm of the whole gradients from their shards)."""
        for name, opt in opt_state.adamw.items():
            grads = _fill_grads(leaves(params[name]))
            gnorm = global_norm(grads) if norm is None else norm(name, grads)
            clip = self.cfg.max_grad_norm / torch.clamp(gnorm, min=self.cfg.max_grad_norm)
            torch._foreach_mul_(grads, clip)
            for group in opt.param_groups:
                group["lr"] = self.schedules[name](opt_state.count)
            opt.step()
        opt_state.count += 1
        return opt_state


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    """AdamW with component-wise learning rates, clipping and freezing."""
    return Optimizer(cfg)


class TreeOptimizer:
    """`optax.adamw` / `optax.adam` over every leaf of any tree:
    `init(params)` binds the state to the leaves, `update(opt_state,
    params)` steps them in place from their `.grad`. `learning_rate` is a
    number or a schedule of the update count."""

    def __init__(self, learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.schedule = learning_rate if callable(learning_rate) else (
            lambda count: learning_rate)
        self.args = ("adamw", b1, b2, eps, weight_decay)

    def init(self, params: Any) -> OptState:
        return OptState(count=0, adamw={"tree": _adam_step(leaves(params), *self.args)})

    def update(self, opt_state: OptState, params: Any) -> OptState:
        _fill_grads(leaves(params))
        opt = opt_state.adamw["tree"]
        for group in opt.param_groups:
            group["lr"] = self.schedule(opt_state.count)
        opt.step()
        opt_state.count += 1
        return opt_state


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> TreeOptimizer:
    """`optax.adamw` (its default weight decay 1e-4) over a whole tree."""
    return TreeOptimizer(learning_rate, b1, b2, eps, weight_decay)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> TreeOptimizer:
    """`optax.adam` over a whole tree."""
    return TreeOptimizer(learning_rate, b1, b2, eps, 0.0)
