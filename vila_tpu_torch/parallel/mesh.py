"""The device mesh and the ZeRO-3 / tensor-parallel sharding rules, as
`vila_tpu/parallel/mesh.py`.

The mesh has the JAX package's axes: dp (data parallel), sp (ring sequence
parallel, outer), su (Ulysses sequence parallel, inner) and tp (tensor
parallel, innermost). It is a `torch.distributed` device mesh over the
default process group, one rank a device, ranks laid out row major over
(dp, sp, su, tp) as the JAX package reshapes its devices; each named dim
has its process group, and `group(axes)` gives the group over several
dims (the FSDP group (dp, sp, su) at this rank's tp coordinate, say).

The spec trees are the JAX package's PartitionSpecs, one per parameter:
per dim None, "tp", or the FSDP superaxis (dp, sp, su), with the same
divisibility fallback to replication. A dim split over FSDP is split into
dp·sp·su chunks and one over tp into tp chunks; rank r holds the chunks of
its coordinates: the slice JAX's `NamedSharding` puts on device r
(`shard_params`). `shard_dims` reads each spec as a `Split` (the dim cut
over FSDP, the dim cut over tp; None when the leaf is whole).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

FSDP = ("dp", "sp", "su")  # superaxis of the ZeRO-3 weight sharding
SEQ = ("sp", "su")  # superaxis of the sequence dim
AXES = ("dp", "sp", "su", "tp")


class P(tuple):
    """A PartitionSpec: one entry per dim (None, an axis name, or a tuple
    of axis names)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


class Mesh:
    """The (dp, sp, su, tp) mesh as seen from one rank.

    `shape` maps each axis to its size; `coords` is this rank's coordinate
    on (dp, sp, su, tp); `group(axes)` is the process group of the ranks
    that differ from this one on `axes` only (None on a layout-only mesh,
    `Mesh.layout`, which the spec and shard functions take for any
    rank)."""

    axis_names = AXES

    def __init__(self, dp: int = 1, sp: int = 1, su: int = 1, tp: int = 1, rank: int = 0,
                 device_mesh=None):
        self.shape = {"dp": dp, "sp": sp, "su": su, "tp": tp}
        self.size = dp * sp * su * tp
        self.rank = rank
        self.coords = (rank // (sp * su * tp), (rank // (su * tp)) % sp, (rank // tp) % su,
                       rank % tp)
        self.device_mesh = device_mesh
        self._groups: Dict[Tuple[str, ...], Any] = {}

    @classmethod
    def layout(cls, dp: int = 1, sp: int = 1, su: int = 1, tp: int = 1, rank: int = 0) -> "Mesh":
        """A mesh without process groups: shapes and rank r's coordinates."""
        return cls(dp=dp, sp=sp, su=su, tp=tp, rank=rank)

    def group(self, axes):
        """The process group over `axes` (a name or a tuple of names, major
        to minor): the default group when they span the mesh. A group over
        several dims is made on first use, by every rank at once (each
        rank makes every coset's group, as `dist.new_group` asks)."""
        if self.device_mesh is None:
            raise RuntimeError("a layout-only mesh has no process groups")
        axes = _axes(axes)
        if len(axes) == 1:
            return self.device_mesh.get_group(axes[0])
        if self.axis_size(axes) == self.size:
            return dist.group.WORLD
        if axes not in self._groups:
            mine = None
            for coset in _cosets(self, axes):
                g = dist.new_group(coset)
                if self.rank in coset:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def axis_size(self, axes) -> int:
        n = 1
        for a in _axes(axes):
            n *= self.shape[a]
        return n

    def axis_index(self, axes) -> int:
        """This rank's flat index over `axes` (major to minor)."""
        idx = 0
        coord = dict(zip(AXES, self.coords))
        for a in _axes(axes):
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


def _cosets(mesh: Mesh, axes: Tuple[str, ...]):
    """The rank lists of every group over `axes`: ranks that agree on
    every other dim, each list in `axes`' row-major order."""
    others = [a for a in AXES if a not in axes]
    groups: Dict[Tuple[int, ...], list] = {}
    for r in range(mesh.size):
        lay = Mesh.layout(**mesh.shape, rank=r)
        key = tuple(lay.axis_index(a) for a in others)
        groups.setdefault(key, []).append((lay.axis_index(axes), r))
    return [[r for _, r in sorted(g)] for _, g in sorted(groups.items())]


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, su: int = 1,
              device_type: Optional[str] = None) -> Mesh:
    """The mesh over the default process group, whose world size must be
    dp·sp·su·tp; `device_type` defaults to "cuda" under NCCL, else "cpu".
    The FSDP and sequence groups are made here, on every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.distributed.init_distributed)")
    need = dp * sp * su * tp
    if dist.get_world_size() != need:
        raise ValueError(f"mesh dp={dp} sp={sp} su={su} tp={tp} needs {need} ranks, "
                         f"the group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (dp, sp, su, tp), mesh_dim_names=AXES)
    mesh = Mesh(dp=dp, sp=sp, su=su, tp=tp, rank=dist.get_rank(), device_mesh=dm)
    mesh.group(FSDP)
    mesh.group(SEQ)
    return mesh


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


class Split(NamedTuple):
    """The dims of a leaf cut over the FSDP group and over tp (None: not
    cut over it)."""

    fsdp: Optional[int]
    tp: Optional[int]


def _split(spec, mesh: Mesh) -> Optional[Split]:
    """A spec's `Split` on `mesh` (None: the leaf is whole on every rank).
    An entry that names tp counts as the tp dim, the FSDP superaxis as the
    FSDP dim; axes of size 1 cut nothing."""
    fsdp = tp = None
    for i, ax in enumerate(spec):
        if ax is None or mesh.axis_size(ax) == 1:
            continue
        if _axes(ax) == ("tp",):
            tp = i
        elif set(_axes(ax)) <= set(FSDP):
            if fsdp is not None:
                raise ValueError(f"spec {spec} splits two dims over FSDP")
            fsdp = i
        else:
            raise ValueError(f"spec {spec}: axes {ax} are neither FSDP nor tp")
    return None if fsdp is None and tp is None else Split(fsdp, tp)


def shard_dims(params, specs, mesh: Mesh):
    """Tree of each leaf's `Split` (None: whole). A leaf without a spec (a
    tower the rules do not name) is whole."""
    if isinstance(params, dict):
        sub = specs if isinstance(specs, dict) else {}
        return {k: shard_dims(v, sub.get(k), mesh) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_dims(v, None, mesh) for v in params)
    return None if specs is None else _split(specs, mesh)


def shard_tensor(x: torch.Tensor, dim: Optional[int], rank: int, n: int) -> torch.Tensor:
    """Rank r's chunk r of `dim` (a contiguous copy), or the whole tensor."""
    if dim is None:
        return x
    return x.chunk(n, dim)[rank].contiguous()


def shard_leaf(x: torch.Tensor, split: Optional[Split], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of a whole leaf: its FSDP chunk, then its tp
    chunk."""
    if split is None:
        return x
    if split.fsdp is not None:
        x = shard_tensor(x, split.fsdp, mesh.axis_index(FSDP), mesh.axis_size(FSDP))
    if split.tp is not None:
        x = shard_tensor(x, split.tp, mesh.axis_index("tp"), mesh.shape["tp"])
    return x


def map_tree(fn, tree, dims):
    """fn(leaf, split) over a parameter tree and its `shard_dims` tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, d) for v, d in zip(tree, dims))
    return fn(tree, dims)


def shard_params(params, dims, mesh: Mesh):
    """This rank's shard of every leaf (`shard_dims` tree)."""
    return map_tree(lambda x, d: shard_leaf(x, d, mesh), params, dims)


def tp_dims(params, dims):
    """The `shard_dims` tree cut over tp only: the layout of whole weights
    sliced for tensor parallelism (each rank keeps its tp chunk)."""
    return map_tree(lambda _, d: None if d is None or d.tp is None else Split(None, d.tp),
                    params, dims)


def gather_tensor(x: torch.Tensor, dim: Optional[int], group=None) -> torch.Tensor:
    """The whole tensor from every rank's chunk along `dim` (no gradient;
    fp8 travels as its bytes, which gloo takes)."""
    if dim is None:
        return x
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.dtype.is_floating_point and x.element_size() == 1:
        return gather_tensor(x.view(torch.uint8), dim, group).view(x.dtype)
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return torch.cat(out.chunk(n, 0), dim=dim)


def gather_leaf(x: torch.Tensor, split: Optional[Split], mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard (no gradient): over the
    FSDP group, then over tp."""
    if split is None:
        return x
    if split.fsdp is not None:
        x = gather_tensor(x, split.fsdp, mesh.group(FSDP))
    if split.tp is not None:
        x = gather_tensor(x, split.tp, mesh.group("tp"))
    return x


def gather_params(shards, dims, mesh: Mesh):
    """Every leaf whole (collective: every rank calls it)."""
    with torch.no_grad():
        return map_tree(lambda t, d: gather_leaf(t.detach(), d, mesh), shards, dims)
