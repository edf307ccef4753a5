"""The training loop, as `vila_tpu/train/trainer.py`: args, loop,
logging, checkpoint/resume, preemption.

Tune-flag freezing and per-component learning rates (the optimizer),
resume from the latest checkpoint with the data skipped ahead, periodic and
final saves, save-and-exit 124 on SIGTERM or near the walltime limit,
metric logging with a `log_history.json` dump, and a `torch.profiler` trace
of `profile_num_steps` steps from `profile_step`.

On a mesh (`distributed`: torchrun's environment, one process a device;
dp x sp x su x tp = the world size) the step is `make_sharded_train_step`'s
ZeRO-3 step, tensor parallel when tp > 1 and with MM-SP attention when
sp x su > 1. Every rank draws and collates the same global batch, as the
JAX package's single host does, and keeps its part (`sp.layout_batch`,
then `distributed.host_local_batch`: rows over dp, the sequence over sp x
su, the same rows on every tp rank). So the ranks of one model replica
(sp x su x tp, JAX's `model_span`) load the same data and the dp groups
their own rows, whatever the number of hosts. A checkpoint holds the
whole tensors (gathered over FSDP and tp, written by rank 0), the
single-device layout: it resumes at any (dp, sp, su, tp). Only rank 0
logs.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from vila_tpu_torch.parallel import distributed as dist_lib
from vila_tpu_torch.train.checkpoint import CheckpointManager, PreemptionGuard
from vila_tpu_torch.train.optimizer import OptimizerConfig, leaves, make_optimizer
from vila_tpu_torch.train.step import (
    batch_to_device,
    make_sharded_train_step,
    make_train_step,
)
from vila_tpu_torch.utils.device import resolve_device
from vila_tpu_torch.utils.weights import to_torch_tree


@dataclasses.dataclass
class TrainArgs:
    """Condensed equivalent of the reference's Model/Data/TrainingArguments
    (llava/train/args.py:24,47,221)."""

    output_dir: str = "runs/default"
    data_mixture: str = "dummy"
    max_steps: int = 1000
    per_device_batch_size: int = 1
    seq_len: int = 4096
    pack_rows: int = 0  # >0: greedy sample packing into this many rows
    # parallelism (mesh axes)
    dp: int = 1
    sp: int = 1
    su: int = 1
    tp: int = 1
    sp_attention: bool = True
    ring_layout: str = "zigzag"
    distributed: bool = False
    batch_shuffle: bool = False  # LongVILA sampler batch-wise shuffle
    # optimizer / tuning
    learning_rate: float = 2e-5
    mm_projector_lr: Optional[float] = None
    vision_tower_lr: Optional[float] = None
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_schedule: str = "cosine"
    max_grad_norm: float = 1.0
    optimizer: str = "adamw"
    tune_language_model: bool = True
    tune_vision_tower: bool = True
    tune_mm_projector: bool = True
    ce_chunk_size: Optional[int] = None  # chunked cross entropy
    # lifecycle
    logging_steps: int = 10
    save_steps: int = 500
    # observability: a torch.profiler trace of steps
    # [profile_step, profile_step + profile_num_steps)
    profile_step: int = -1
    profile_num_steps: int = 3
    wandb_project: str = ""
    max_ckpts_to_keep: int = 3
    resume: bool = True
    total_time_limit_s: Optional[float] = None
    save_margin_s: float = 300.0
    seed: int = 0


def _batch_iterator(
    dataset,
    collator,
    batch_size: int,
    seed: int,
    start_step: int = 0,
    *,
    rank: int = 0,
    world_size: int = 1,
    sp_degree: int = 1,
    batch_shuffle: bool = False,
) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic shuffled epochs via DistributedSampler; skip-ahead on
    resume (the skipped batches are neither loaded nor collated)."""
    from vila_tpu_torch.data.sampler import DistributedSampler

    lengths = (
        [len(d) for d in dataset.datasets]
        if hasattr(dataset, "datasets")
        else [len(dataset)]
    )
    sampler = DistributedSampler(
        lengths,
        rank=rank,
        world_size=world_size,
        sp_degree=sp_degree,
        batch_size=batch_size,
        seed=seed,
        shuffle=True,
        batch_shuffle=batch_shuffle,
    )
    step = 0
    epoch = 0
    while True:
        sampler.set_epoch(epoch)
        indices = list(sampler)
        for i in range(0, len(indices) - batch_size + 1, batch_size):
            if step >= start_step:
                yield collator(
                    [dataset[int(j)] for j in indices[i : i + batch_size]]
                )
            step += 1
        epoch += 1


class Trainer:
    """`Trainer(cfg, params, dataset, collator, args, device)`: `params`
    (f32 master weights, any device) are placed on `device` (default the
    card) and trained in place by `train()`."""

    def __init__(self, cfg, params: Dict[str, Any], dataset, collator,
                 args: TrainArgs, device="cuda") -> None:
        from vila_tpu_torch.parallel import mesh as mesh_lib

        if args.distributed:
            dist_lib.init_distributed(
                backend="gloo" if torch.device(device).type == "cpu" else None)
        self.process_index = dist_lib.process_index()
        self.is_primary = self.process_index == 0
        self.mesh = self.sp_plan = None
        if torch.distributed.is_initialized():
            self.mesh = mesh_lib.make_mesh(dp=args.dp, sp=args.sp, su=args.su, tp=args.tp)
        elif (args.dp, args.sp, args.su, args.tp) != (1, 1, 1, 1):
            raise ValueError("dp / sp / su / tp > 1 need one process a device: run under "
                             "torchrun with --distributed true")
        self.cfg = cfg
        self.args = args
        self.device = resolve_device(device)
        ocfg = OptimizerConfig(
            learning_rate=args.learning_rate,
            mm_projector_lr=args.mm_projector_lr,
            vision_tower_lr=args.vision_tower_lr,
            weight_decay=args.weight_decay,
            warmup_ratio=args.warmup_ratio,
            total_steps=args.max_steps,
            schedule=args.lr_schedule,
            max_grad_norm=args.max_grad_norm,
            optimizer=args.optimizer,
            tune_language_model=args.tune_language_model,
            tune_vision_tower=args.tune_vision_tower,
            tune_mm_projector=args.tune_mm_projector,
        )
        params = to_torch_tree(params, self.device)
        self.dims = None
        if self.mesh is None:
            self.step_fn, self.params, self.opt_state = make_train_step(
                cfg, params, make_optimizer(ocfg), ce_chunk_size=args.ce_chunk_size)
        else:
            self.step_fn, self.params, self.opt_state, self.dims = make_sharded_train_step(
                cfg, params, make_optimizer(ocfg), self.mesh, ce_chunk_size=args.ce_chunk_size,
                sp_attention=args.sp_attention, ring_layout=args.ring_layout)
            self.sp_plan = self.step_fn.keywords["sp"]
        del params
        self.dataset = dataset
        self.collator = collator
        self.ckpt = CheckpointManager(
            os.path.join(args.output_dir, "checkpoints"),
            max_to_keep=args.max_ckpts_to_keep,
        )
        self.guard = PreemptionGuard(args.total_time_limit_s, args.save_margin_s)
        self.log_history: list = []
        self.start_step = 0
        self._last_saved: Optional[int] = None
        if args.resume:
            latest, state = self.ckpt.restore_latest(map_location="cpu")
            if latest is not None:
                if self.mesh is not None:
                    state = _shard_state(state, self.dims, self.mesh)
                with torch.no_grad():
                    for dst, src in zip(leaves(self.params), leaves(state["params"])):
                        dst.copy_(src)
                self.opt_state.load_state_dict(state["opt_state"])
                self.start_step = latest
                print(f"[trainer] resumed from step {latest}", flush=True)

    # ------------------------------------------------------------------

    def _save(self, step: int):
        self._last_saved = step
        state = {"params": self.params, "opt_state": self.opt_state.state_dict()}
        if self.mesh is not None:  # every rank gathers; rank 0 writes
            state = _full_state(state, self.params, self.dims, self.mesh)
        if self.is_primary:
            self.ckpt.save(step, state, metadata={"step": step, "time": time.time()})
        if self.mesh is not None:
            torch.distributed.barrier()

    def _put(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """This rank's part of a global host batch, on the device."""
        if self.mesh is not None:
            from vila_tpu_torch.parallel.sp import layout_batch

            batch = dist_lib.host_local_batch(layout_batch(batch, self.sp_plan), self.mesh)
        return batch_to_device(batch, self.device)

    def train(self) -> Dict[str, Any]:
        from vila_tpu_torch.utils.profiling import MetricsLogger, trace

        args = self.args
        it = _batch_iterator(
            self.dataset, self.collator, args.per_device_batch_size,
            args.seed, self.start_step, batch_shuffle=args.batch_shuffle,
        )
        mlog = (MetricsLogger(args.output_dir, project=args.wandb_project or None)
                if self.is_primary else None)
        t0 = time.time()
        tokens_seen = 0
        pending_tokens: list = []
        profiling = None
        for step in range(self.start_step, args.max_steps):
            if step == args.profile_step:
                profiling = trace(os.path.join(args.output_dir, "profile"))
                profiling.__enter__()
            batch = self._put(next(it))
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch
            )
            if (
                profiling is not None
                and step == args.profile_step + args.profile_num_steps - 1
            ):
                profiling.__exit__(None, None, None)
                profiling = None
            # accumulate without a device sync; read only on log steps
            pending_tokens.append(metrics["n_tokens"])
            if (step + 1) % args.logging_steps == 0 or step == self.start_step:
                m = {k: float(v) for k, v in metrics.items()}
                tokens_seen += int(sum(int(t) for t in pending_tokens))
                pending_tokens.clear()
                m["tokens_seen"] = tokens_seen
                m.update(step=step + 1, elapsed_s=time.time() - t0)
                self.log_history.append(m)
                if self.is_primary:
                    mlog.log(m, step=step + 1)
                    print(f"[trainer] {json.dumps(m)}", flush=True)
            if (step + 1) % args.save_steps == 0:
                self._save(step + 1)
            if self.guard.should_stop(step):
                # preemption / walltime: save and exit with the retryable
                # timeout code (reference convention, cli/run.py:117-131)
                self._save(step + 1)
                self.ckpt.wait()
                self._dump_log_history()
                print("[trainer] preempted; checkpoint saved", flush=True)
                sys.exit(PreemptionGuard.EXIT_CODE)

        if self._last_saved != args.max_steps:  # not just saved by save_steps
            self._save(args.max_steps)
        self.ckpt.wait()
        self._dump_log_history()
        if mlog is not None:
            mlog.close()
        return {"final_step": args.max_steps, "log_history": self.log_history}

    def _dump_log_history(self):
        if not self.is_primary:
            return
        os.makedirs(self.args.output_dir, exist_ok=True)
        with open(
            os.path.join(self.args.output_dir, "log_history.json"), "w"
        ) as f:
            json.dump(self.log_history, f, indent=2)


def _opt_pairs(opt_state_dict, params, dims):
    """(component, param index, moment name, split) of every moment
    tensor of `OptState.state_dict()` (fp8 AdamW's block scales are whole
    on every rank and left out), the params in `leaves` order."""
    from vila_tpu_torch.train.step import _pairs

    for name, sd in opt_state_dict["adamw"].items():
        split = [d for _, d in _pairs(params[name], dims[name])]
        for i, st in sd["state"].items():
            for key, val in st.items():
                if isinstance(val, torch.Tensor) and val.ndim > 0 and not key.endswith("_scale"):
                    yield name, i, key, split[i]


_FP8_MOMENTS = ("mu", "nu")  # fp8 AdamW's moments: one device's (nb, 128) blocks


def _copy_state(osd):
    import copy

    out = copy.copy(osd)
    out["adamw"] = {name: {"state": {i: dict(st) for i, st in sd["state"].items()},
                           "param_groups": sd["param_groups"]}
                    for name, sd in osd["adamw"].items()}
    return out


def _full_state(state, params, dims, mesh):
    """A sharded {params, opt_state} with every split tensor gathered whole
    (on every rank: the gathers are collective); fp8 moments in one
    device's block layout."""
    from vila_tpu_torch.parallel.mesh import gather_leaf, gather_params
    from vila_tpu_torch.train.fp8_adamw import to_blocks

    with torch.no_grad():
        full = {"params": gather_params(params, dims, mesh),
                "opt_state": _copy_state(state["opt_state"])}
        osd = full["opt_state"]
        for name, i, key, d in _opt_pairs(osd, params, dims):
            st = osd["adamw"][name]["state"][i]
            st[key] = gather_leaf(st[key], d, mesh)
            if key in _FP8_MOMENTS and d is not None:
                st[key] = to_blocks(st[key])
    return full


def _shard_state(state, dims, mesh):
    """A whole {params, opt_state} (a checkpoint) cut to this rank's
    shards."""
    from vila_tpu_torch.parallel.mesh import shard_leaf, shard_params
    from vila_tpu_torch.train.fp8_adamw import from_blocks
    from vila_tpu_torch.train.step import _pairs

    out = {"params": shard_params(state["params"], dims, mesh),
           "opt_state": _copy_state(state["opt_state"])}
    whole = {name: [t.shape for t, _ in _pairs(state["params"][name], dims[name])]
             for name in state["params"]}
    for name, i, key, d in list(_opt_pairs(out["opt_state"], state["params"], dims)):
        st = out["opt_state"]["adamw"][name]["state"][i]
        if key in _FP8_MOMENTS and d is not None:
            st[key] = from_blocks(st[key], whole[name][i])
        st[key] = shard_leaf(st[key], d, mesh)
    return out
