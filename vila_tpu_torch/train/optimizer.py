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
optax's; parameters and moments are updated in place. A parameter that
received no gradient (unused in the forward) steps with a zero gradient, as
optax's dense tree does.
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
    optimizer: str = "adamw"  # adamw (fp8_adamw comes with train/fp8_adamw.py)
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
    """The tensors of a nested dict tree, in key order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree] if isinstance(tree, torch.Tensor) else []


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32), on the device."""
    norms = [torch.linalg.vector_norm(t.float()) for t in tensors if t is not None]
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class OptState:
    """The update count and one `torch.optim.AdamW` per tuned component,
    bound to that component's tensors."""

    count: int
    adamw: Dict[str, torch.optim.AdamW]

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
        if cfg.optimizer != "adamw":
            raise NotImplementedError(
                f"optimizer {cfg.optimizer!r} needs train/fp8_adamw.py, not ported yet")
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
        adamw = {}
        for name in self.schedules:
            ts = leaves(params[name])
            adamw[name] = torch.optim.AdamW(
                ts, lr=0.0, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                weight_decay=cfg.weight_decay, fused=ts[0].is_cuda or None)
        return OptState(count=0, adamw=adamw)

    def update(self, opt_state: OptState, params: Dict[str, Any]) -> OptState:
        for name, opt in opt_state.adamw.items():
            ts = leaves(params[name])
            for t in ts:
                if t.grad is None:
                    t.grad = torch.zeros_like(t)
            grads = [t.grad for t in ts]
            clip = self.cfg.max_grad_norm / torch.clamp(
                global_norm(grads), min=self.cfg.max_grad_norm)
            torch._foreach_mul_(grads, clip)
            for group in opt.param_groups:
                group["lr"] = self.schedules[name](opt_state.count)
            opt.step()
        opt_state.count += 1
        return opt_state


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    """AdamW with component-wise learning rates, clipping and freezing."""
    return Optimizer(cfg)
