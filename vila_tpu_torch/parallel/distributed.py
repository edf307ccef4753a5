"""Multi-process runtime, as `vila_tpu/parallel/distributed.py`: process
bootstrap and each rank's share of a global batch.

One process drives one device. The environment contract is torchrun's
(`RANK`, `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`, `LOCAL_RANK`), read by
`init_process_group`'s `env://` method; explicit arguments give a TCP
address instead. No environment and no arguments is a single process and
initialises nothing. The backend is NCCL on the card and gloo on the CPU.

`host_local_batch` is the port's `jax.make_array_from_process_local_data`:
every rank holds the same global (collated) batch and keeps the shard the
JAX package's `batch_specs` put on its device (`mesh.Mesh.dp_slice`,
`seq_slice`).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
) -> int:
    """Initialise the default process group (idempotent). Returns this
    process's rank.

    With no arguments, reads torchrun's environment; without it (no
    `WORLD_SIZE`), a single process needs no group and 0 is returned.
    `backend` defaults to "nccl" when CUDA is available, else "gloo"."""
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        return 0
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank,
    )
    return dist.get_rank()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return process_index() == 0


def host_local_batch(global_batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's part of a global host batch on `mesh`, by the JAX
    package's `batch_specs`: rows split over dp, the per-token arrays'
    sequence over (sp, su) ring major; `media_positions` made local to the
    slice (a position outside it becomes the sentinel S_local, which the
    splice drops). Keys without a spec stay whole, as do rows that dp does
    not divide (`_spec`'s fallback to replication)."""
    from vila_tpu_torch.parallel.mesh import SEQ, batch_specs

    specs = batch_specs(mesh)
    ids = global_batch.get("input_ids")
    cols = None if ids is None else mesh.seq_slice(ids.shape[1])
    out = {}
    for k, v in global_batch.items():
        spec = specs.get(k)
        if spec is None:
            out[k] = v
            continue
        if isinstance(v, list):  # PS3's high scales, one array each
            out[k] = [np.ascontiguousarray(x[mesh.dp_slice(len(x))]) for x in v]
            continue
        part = v[mesh.dp_slice(len(v))]
        if len(spec) > 1 and spec[1] == SEQ:
            part = part[:, mesh.seq_slice(v.shape[1])]
        elif k == "media_positions" and cols is not None:
            s_loc = cols.stop - cols.start
            local = part - cols.start
            part = np.where((part < ids.shape[1]) & (local >= 0) & (local < s_loc), local,
                            s_loc).astype(v.dtype)
        out[k] = np.ascontiguousarray(part)
    return out
