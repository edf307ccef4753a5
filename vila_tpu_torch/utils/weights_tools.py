"""Checkpoint weight tools, as `vila_tpu/utils/weights_tools.py`: weight
deltas, consolidation of a training run, LoRA merge-and-save.

Capability parity: `llava/model/apply_delta.py` / `make_delta.py` (weight
deltas against a base model), `llava/model/consolidate.py` (a training run
made into one loadable model) and
`llava/utils/merge_lora_weights_and_save_hf_model.py`.

Deltas are leafwise over the port's trees of tensors, in f32. The others
read and write the component checkpoint layout (`llm/`, `vision_tower/`,
`mm_projector/`) through `entry`; loading defaults to the card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    """`fn(a_leaf, b_leaf)` over two nested dicts of one structure; a
    structure that differs raises."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            raise ValueError(f"tree structures differ: keys {sorted(a)} against "
                             f"{sorted(b) if isinstance(b, dict) else type(b).__name__}")
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def _f32(x: Any) -> torch.Tensor:
    return (x if isinstance(x, torch.Tensor) else torch.as_tensor(x)).detach().float()


def make_delta(base: Dict[str, Any], target: Dict[str, Any]) -> Dict[str, Any]:
    """delta = target - base, leafwise in f32 (make_delta.py behavior)."""
    return _map2(lambda t, b: _f32(t) - _f32(b), target, base)


def apply_delta(base: Dict[str, Any], delta: Dict[str, Any]) -> Dict[str, Any]:
    """target = base + delta, leafwise in f32 (apply_delta.py behavior)."""
    return _map2(lambda b, d: _f32(b) + _f32(d), base, delta)


def consolidate_checkpoint(run_dir: str, model_path: str, out_dir: str,
                           map_location="cuda") -> str:
    """A trainer run's checkpoint -> a deployable component checkpoint.

    The reference's `consolidate.py:48` turns training artifacts (sharded,
    optimizer-laden) into a single loadable model. Here: restore the latest
    step of the run (`train.checkpoint.CheckpointManager`, the `Trainer`'s
    layout `{"params": ..., "opt_state": ...}`; its tensors on
    `map_location`, the card by default), keep only the params, and write
    the component layout that `vila_tpu_torch.load` reads. The config and
    tokenizer come from the run's base model at `model_path`."""
    from vila_tpu_torch import entry
    from vila_tpu_torch.train.checkpoint import CheckpointManager
    from vila_tpu_torch.utils.device import resolve_device

    dev = resolve_device(map_location)
    mgr = CheckpointManager(run_dir)
    step, state = mgr.restore_latest(dev)
    mgr.close()
    assert step is not None, f"no checkpoint under {run_dir}"
    cfg = entry.build_config(model_path, dtype="float32", device=dev)
    tokenizer = entry.load_tokenizer(model_path)
    entry.save(state["params"], cfg, tokenizer, out_dir)
    return out_dir


def merge_lora_and_save(model_path: str, lora_state: Dict[str, Any], lora_cfg, out_dir: str,
                        device="cuda") -> str:
    """Load a component checkpoint on `device` (the card by default), merge
    the LoRA factors into its base weights and save it back in the
    component layout (merge_lora_weights_and_save_hf_model.py parity)."""
    from vila_tpu_torch import entry
    from vila_tpu_torch.train import lora as lora_lib
    from vila_tpu_torch.utils.device import resolve_device
    from vila_tpu_torch.utils.weights import to_torch_tree

    dev = resolve_device(device)
    cfg = entry.build_config(model_path, dtype="float32", device=dev)
    params = entry.load_params(model_path, cfg, device=dev)
    tokenizer = entry.load_tokenizer(model_path)
    merged = lora_lib.merge_lora(params, to_torch_tree(lora_state, dev), lora_cfg)
    entry.save(merged, cfg, tokenizer, out_dir)
    return out_dir
