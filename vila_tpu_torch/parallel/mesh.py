"""The device mesh and the ZeRO-3 sharding rules, as
`vila_tpu/parallel/mesh.py`.

The mesh has the JAX package's axes: dp (data parallel), sp (ring sequence
parallel, outer), su (Ulysses sequence parallel, inner) and tp (tensor
parallel). It is a `torch.distributed` device mesh over the default process
group, one rank a device, ranks laid out row major over (dp, sp, su) as the
JAX package lays its devices; each named dim has its process group. tp is
accepted only at 1: the reference VILA has no tensor parallelism and the
port has no Megatron-style linears yet (ROADMAP.md, queue 1: "tensor
parallelism").

The spec trees are the JAX package's PartitionSpecs, one per parameter:
per dim None, "tp", or the FSDP superaxis (dp, sp, su), with the same
divisibility fallback to replication. A dim split over FSDP is split into
dp·sp·su chunks, and rank r holds chunk r: the slice JAX's `NamedSharding`
puts on device r (`shard_params`). `shard_dims` reads each spec as the one
dim a rank's shard is cut along (None: replicated).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

FSDP = ("dp", "sp", "su")  # superaxis of the ZeRO-3 weight sharding
SEQ = ("sp", "su")  # superaxis of the sequence dim
AXES = ("dp", "sp", "su", "tp")
TP_ITEM = 'ROADMAP.md queue 1, "tensor parallelism"'


class P(tuple):
    """A PartitionSpec: one entry per dim (None, an axis name, or a tuple
    of axis names)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class Mesh:
    """The (dp, sp, su, tp) mesh as seen from one rank.

    `shape` maps each axis to its size; `coords` is this rank's coordinate
    on (dp, sp, su); `group(axis)` is that dim's process group (None on a
    layout-only mesh, `Mesh.layout`, which the spec and shard functions
    take for any rank)."""

    axis_names = AXES

    def __init__(self, dp: int = 1, sp: int = 1, su: int = 1, tp: int = 1, rank: int = 0,
                 device_mesh=None):
        if tp != 1:
            raise NotImplementedError(
                f"tp={tp}: tensor parallelism is not ported ({TP_ITEM})")
        self.shape = {"dp": dp, "sp": sp, "su": su, "tp": tp}
        self.size = dp * sp * su
        self.rank = rank
        self.coords = (rank // (sp * su), (rank // su) % sp, rank % su)
        self.device_mesh = device_mesh

    @classmethod
    def layout(cls, dp: int = 1, sp: int = 1, su: int = 1, rank: int = 0) -> "Mesh":
        """A mesh without process groups: shapes and rank r's coordinates."""
        return cls(dp=dp, sp=sp, su=su, rank=rank)

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError("a layout-only mesh has no process groups")
        return self.device_mesh.get_group(axis)

    def axis_size(self, axes) -> int:
        n = 1
        for a in (axes,) if isinstance(axes, str) else axes:
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        """This rank's flat index over `axes` (major to minor)."""
        idx = 0
        coord = dict(zip(("dp", "sp", "su"), self.coords), tp=0)
        for a in (axes,) if isinstance(axes, str) else axes:
            idx = idx * self.shape[a] + coord[a]
        return idx

    def dp_slice(self, rows: int) -> slice:
        """This rank's rows of a global batch (all of them when dp does not
        divide the count, JAX's fallback)."""
        n = self.shape["dp"]
        if rows % n:
            return slice(0, rows)
        per = rows // n
        return slice(self.coords[0] * per, (self.coords[0] + 1) * per)

    def seq_slice(self, seq: int) -> slice:
        """This rank's tokens of a global sequence, split over (sp, su)."""
        n = self.axis_size(SEQ)
        if seq % n:
            raise ValueError(f"sequence {seq} does not split over sp x su = {n}")
        per = seq // n
        i = self.axis_index(SEQ)
        return slice(i * per, (i + 1) * per)


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, su: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh over the default process group, whose world size must be
    dp·sp·su; `device_type` defaults to "cuda" under NCCL, else "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh

    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported ({TP_ITEM})")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.init_distributed)")
    need = dp * sp * su
    if dist.get_world_size() != need:
        raise ValueError(f"mesh dp={dp} sp={sp} su={su} needs {need} ranks, "
                         f"the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (dp, sp, su), mesh_dim_names=("dp", "sp", "su"))
    return Mesh(dp=dp, sp=sp, su=su, rank=dist.get_rank(), device_mesh=dm)


# --------------------------------------------------------------------------
# Spec trees (the JAX package's rules)
# --------------------------------------------------------------------------


def _div(n: int, mesh: Mesh, axes) -> bool:
    return axes is None or n % mesh.axis_size(axes) == 0


def _spec(mesh: Mesh, shape: Tuple[int, ...], *axes) -> P:
    """PartitionSpec with divisibility guards (replicated along a dim that
    does not divide its axes)."""
    return P(*(ax if _div(dim, mesh, ax) else None for dim, ax in zip(shape, axes)))


def llm_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    """Spec tree of `models.qwen2` parameters."""
    D, I, hd = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    Hq, Hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    V, L = cfg.vocab_size, cfg.num_hidden_layers

    def s(shape, *axes):
        return _spec(mesh, shape, *axes)

    layers = {
        "input_layernorm": {"scale": s((L, D), None, None)},
        "q_proj": {"kernel": s((L, D, Hq * hd), None, FSDP, "tp")},
        "k_proj": {"kernel": s((L, D, Hkv * hd), None, FSDP, "tp")},
        "v_proj": {"kernel": s((L, D, Hkv * hd), None, FSDP, "tp")},
        "o_proj": {"kernel": s((L, Hq * hd, D), None, "tp", FSDP)},
        "post_attention_layernorm": {"scale": s((L, D), None, None)},
        "gate_proj": {"kernel": s((L, D, I), None, FSDP, "tp")},
        "up_proj": {"kernel": s((L, D, I), None, FSDP, "tp")},
        "down_proj": {"kernel": s((L, I, D), None, "tp", FSDP)},
    }
    if cfg.qkv_bias:
        layers["q_proj"]["bias"] = s((L, Hq * hd), None, "tp")
        layers["k_proj"]["bias"] = s((L, Hkv * hd), None, "tp")
        layers["v_proj"]["bias"] = s((L, Hkv * hd), None, "tp")
    specs = {
        "embed_tokens": {"embedding": s((V, D), "tp", FSDP)},
        "layers": layers,
        "norm": {"scale": s((D,), None)},
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = {"kernel": s((D, V), FSDP, "tp")}
    return specs


def siglip_param_specs(cfg, mesh: Mesh) -> Dict[str, Any]:
    D, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    pin = cfg.patch_size * cfg.patch_size * cfg.num_channels

    def s(shape, *axes):
        return _spec(mesh, shape, *axes)

    def proj(din, dout, din_ax, dout_ax):
        return {"kernel": s((L, din, dout), None, din_ax, dout_ax),
                "bias": s((L, dout), None, dout_ax)}

    def ln():
        return {"scale": s((L, D), None, None), "bias": s((L, D), None, None)}

    return {
        "patch_embedding": {"kernel": s((pin, D), None, FSDP), "bias": s((D,), None)},
        "position_embedding": {"embedding": s((cfg.num_patches, D), None, FSDP)},
        "layers": {
            "layer_norm1": ln(),
            "q_proj": proj(D, D, FSDP, "tp"),
            "k_proj": proj(D, D, FSDP, "tp"),
            "v_proj": proj(D, D, FSDP, "tp"),
            "out_proj": proj(D, D, "tp", FSDP),
            "layer_norm2": ln(),
            "fc1": proj(D, I, FSDP, "tp"),
            "fc2": proj(I, D, "tp", FSDP),
        },
        "post_layernorm": {"scale": s((D,), None), "bias": s((D,), None)},
    }


def projector_param_specs(proj_params, mesh: Mesh) -> Dict[str, Any]:
    """Projector linears sharded over FSDP on the input dim."""
    return {idx: {k: (_spec(mesh, tuple(v.shape), FSDP, "tp") if k == "kernel" else P(None))
                  for k, v in slot.items()}
            for idx, slot in proj_params.items()}


def vlm_param_specs(cfg, params, mesh: Mesh) -> Dict[str, Any]:
    """Spec tree of a whole VLM parameter tree (`vlm.init_params`)."""
    if getattr(cfg, "vision_tower_type", "siglip") == "ps3":
        import dataclasses

        vit_cfg = dataclasses.replace(cfg.vision.vit, image_size=cfg.vision.s3_scales[0])
        vision = {"vit": siglip_param_specs(vit_cfg, mesh),
                  "scale_embedding": P(), "select_head": {"kernel": P(), "bias": P()}}
        if "top_down_prompt_head" in params["vision_tower"]:
            vision["top_down_prompt_head"] = {"kernel": P(), "bias": P()}
    else:
        vision = siglip_param_specs(cfg.vision, mesh)
    return {"llm": llm_param_specs(cfg.llm, mesh), "vision_tower": vision,
            "mm_projector": projector_param_specs(params["mm_projector"], mesh)}


def batch_specs(mesh: Mesh) -> Dict[str, P]:
    """Training batch sharding: batch over dp, sequence over sp x su."""
    return {
        "input_ids": P("dp", SEQ), "labels": P("dp", SEQ),
        "positions": P("dp", SEQ), "segment_ids": P("dp", SEQ),
        "pixel_values": P("dp"), "pixel_values_high": P("dp"),
        "gt_selection_maps": P("dp"), "media_positions": P("dp"),
    }


# --------------------------------------------------------------------------
# Shards
# --------------------------------------------------------------------------


def _split_dim(spec, mesh: Mesh) -> Optional[int]:
    """The dim a spec splits over more than one rank (None: replicated)."""
    dims = [i for i, ax in enumerate(spec) if ax is not None and mesh.axis_size(ax) > 1]
    if len(dims) > 1:
        raise ValueError(f"spec {spec} splits more than one dim")
    return dims[0] if dims else None


def shard_dims(params, specs, mesh: Mesh):
    """Tree of each leaf's split dim (None: replicated). A leaf without a
    spec (a tower the rules do not name) is replicated."""
    if isinstance(params, dict):
        sub = specs if isinstance(specs, dict) else {}
        return {k: shard_dims(v, sub.get(k), mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_dims(v, None, mesh) for v in params)
    return None if specs is None else _split_dim(specs, mesh)


def shard_tensor(x: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank r's chunk r of `dim` (a contiguous copy), or the whole tensor."""
    if dim is None:
        return x
    return x.chunk(n, dim)[rank].contiguous()


def map_tree(fn, tree, dims):
    """fn(leaf, dim) over a parameter tree and its `shard_dims` tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, d) for v, d in zip(tree, dims))
    return fn(tree, dims)


def shard_params(params, dims, mesh: Mesh):
    """This rank's shard of every leaf (`shard_dims` tree)."""
    return map_tree(lambda x, d: shard_tensor(x, d, mesh.rank, mesh.size), params, dims)


def gather_tensor(x: torch.Tensor, dim: Optional[int], group=None) -> torch.Tensor:
    """The whole tensor from every rank's chunk along `dim` (no gradient)."""
    if dim is None:
        return x
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return torch.cat(out.chunk(n, 0), dim=dim)
