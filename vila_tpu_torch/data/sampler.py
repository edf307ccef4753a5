"""Distributed samplers: DP-rank sharding with SP-group awareness and
per-dataset interleaving.

Capability parity: `VILADistributedSampler` (llava/train/llava_trainer.py:
131-303) — each sequence-parallel group consumes identical samples (the SP
group is one logical DP replica: dp_rank = rank // sp, :170-177), per-dataset
drop-last arithmetic so every constituent dataset splits evenly across
replicas, and deterministic epoch shuffling; `LongVILADistributedSampler`
(:304) adds batch-wise shuffling so long-video batches mix durations.

A copy of `vila_tpu/data/sampler.py` (numpy only). "rank" is the
data-loading host index; on one device it is 0 and world_size 1.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class DistributedSampler:
    """Shard sample indices across DP replicas; SP peers get identical data.

    lengths: sizes of the constituent datasets (ConcatDataset spans) — each
    is dropped-last independently like the reference (:178-204).
    """

    def __init__(
        self,
        lengths: Sequence[int],
        *,
        rank: int = 0,
        world_size: int = 1,
        sp_degree: int = 1,
        batch_size: int = 1,
        seed: int = 0,
        shuffle: bool = True,
        batch_shuffle: bool = False,  # LongVILA sampler (:304)
    ) -> None:
        assert world_size % max(sp_degree, 1) == 0
        self.lengths = list(lengths)
        self.sp = max(sp_degree, 1)
        self.dp_rank = rank // self.sp
        self.num_replicas = world_size // self.sp
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.batch_shuffle = batch_shuffle
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _per_dataset_indices(self, rng) -> List[np.ndarray]:
        out = []
        start = 0
        for n in self.lengths:
            idx = np.arange(start, start + n)
            if self.shuffle:
                rng.shuffle(idx)
            # per-dataset drop-last so each replica sees an equal count
            per = n // (self.num_replicas * self.batch_size)
            keep = per * self.num_replicas * self.batch_size
            idx = idx[:keep]
            # contiguous block per replica (reference interleave-merge)
            span = keep // self.num_replicas
            out.append(idx[self.dp_rank * span : (self.dp_rank + 1) * span])
            start += n
        return out

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        parts = self._per_dataset_indices(rng)
        merged = np.concatenate(parts) if parts else np.zeros((0,), np.int64)
        if self.batch_shuffle and len(merged):
            nb = len(merged) // self.batch_size
            batches = merged[: nb * self.batch_size].reshape(
                nb, self.batch_size
            )
            rng.shuffle(batches)
            merged = batches.reshape(-1)
        return iter(merged.tolist())

    def __len__(self) -> int:
        total = 0
        for n in self.lengths:
            per = n // (self.num_replicas * self.batch_size)
            total += per * self.batch_size
        return total
