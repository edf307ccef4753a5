"""Worker side of the port's multi-process CPU tests (gloo).

Imports only torch and `vila_tpu_torch`, so that the spawned processes
never load JAX. `spawn(cases, world)` starts `world` processes (spawn
start method), each initialises a gloo group on a free 127.0.0.1 port and
runs every case in order (the same order on every rank, so that their
collectives match); it returns one list of results a rank. A case is
(function name in this module, keyword arguments of numpy arrays and plain
values); its result is a tree of numpy arrays and plain values. A rank that
raises ends the run at once; a run that outlasts `timeout` is killed, so a
hung collective fails its tests and never stalls the suite.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cases, world: int, timeout: float = 240.0):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
            pickle.dump(cases, f)
        port = free_port()
        procs = [ctx.Process(target=_worker, args=(r, world, port, tmp), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.time() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [p for p in procs if p.exitcode not in (None, 0)]
                if failed or time.time() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        errors = []
        for r in range(world):
            path = os.path.join(tmp, f"error{r}.txt")
            if os.path.exists(path):
                errors.append(f"rank {r}:\n" + open(path).read())
        if errors:
            raise RuntimeError("\n".join(errors))
        if any(p.exitcode != 0 for p in procs):
            raise TimeoutError(f"{world}-rank run did not finish in {timeout} s "
                               f"(exit codes {[p.exitcode for p in procs]})")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _worker(rank, world, port, tmp):
    try:
        import torch

        torch.set_num_threads(1)
        from vila_tpu_torch.parallel import distributed

        distributed.init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
        with open(os.path.join(tmp, "cases.pkl"), "rb") as f:
            cases = pickle.load(f)
        results = [globals()[name](**kw) for name, kw in cases]
        with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
            pickle.dump(results, f)
        torch.distributed.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


# --------------------------------------------------------------------------
# helpers (worker side)
# --------------------------------------------------------------------------


def _t(x):
    import torch

    return torch.as_tensor(np.asarray(x))


def _np(x):
    return x.detach().float().numpy() if hasattr(x, "detach") else x


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(v, fn) for v in tree)
    return fn(tree)


def _mesh(**axes):
    from vila_tpu_torch.parallel import mesh as mesh_lib

    return mesh_lib.make_mesh(**axes)


def llm_config(**kw):
    from vila_tpu_torch.models import qwen2

    return qwen2.LLMConfig(**kw)


def vlm_config(llm, vision, projector):
    from vila_tpu_torch.models import projector as proj_lib
    from vila_tpu_torch.models import siglip, vlm

    return vlm.VLMConfig(llm=llm_config(**llm), vision=siglip.SigLIPConfig(**vision),
                         projector=proj_lib.ProjectorConfig(**projector))


def config_fields(cfg) -> dict:
    """A config dataclass (JAX or port) as plain keyword arguments."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


# --------------------------------------------------------------------------
# cases
# --------------------------------------------------------------------------


def attention(mesh_axes, kind, q, k, v, cot, seg=None, layout="contiguous", impl="xla"):
    """Ring / Ulysses / hybrid over this rank's shard of the global (laid
    out) q, k, v: (out, dq, dk, dv) shards, the gradients of sum(out * cot)."""
    import torch

    from vila_tpu_torch.parallel import ring_attention as ra

    mesh = _mesh(**mesh_axes)
    sl = mesh.seq_slice(q.shape[1])
    qt, kt, vt = (_t(x)[:, sl].clone().requires_grad_(True) for x in (q, k, v))
    s = None if seg is None else _t(seg)[:, sl]
    kw = dict(causal=True, q_segment_ids=s, kv_segment_ids=s, impl=impl)
    if kind == "ring":
        out = ra.ring_flash_attention(qt, kt, vt, mesh.group("sp"), layout=layout, **kw)
    elif kind == "ulysses":
        out = ra.ulysses_attention(qt, kt, vt, mesh.group("su"), **kw)
    else:
        out = ra.hybrid_attention(qt, kt, vt, mesh.group("su"), mesh.group("sp"),
                                  ring_layout=layout, **kw)
    grads = torch.autograd.grad((out * _t(cot)[:, sl]).sum(), (qt, kt, vt))
    return [_np(out)] + [_np(g) for g in grads]


def model_sp(mesh_axes, layout, llm, params, ids, pos, seg, cot):
    """qwen2.forward under sp on this rank's shard: (logits shard, the
    parameters' gradients of sum(logits * cot) summed over the ranks)."""
    import torch
    import torch.distributed as dist

    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.parallel.sp import SPConfig

    mesh = _mesh(**mesh_axes)
    sp = SPConfig(mesh=mesh, ring_layout=layout, impl="xla")
    cfg = llm_config(**llm)
    p = _tree(params, lambda x: _t(x).requires_grad_(True))
    rows, cols = mesh.dp_slice(ids.shape[0]), mesh.seq_slice(ids.shape[1])
    logits, _ = qwen2.forward(p, cfg, input_ids=_t(ids)[rows, cols],
                              positions=_t(pos)[rows, cols],
                              segment_ids=_t(seg)[rows, cols], attn_impl="xla", sp=sp)
    (logits * _t(cot)[rows, cols]).sum().backward()
    grads = _tree(p, lambda t: t.grad)
    for g in _tree_leaves(grads):
        dist.all_reduce(g)
    return _np(logits), _tree(grads, _np)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    return [tree]


def shards(mesh_axes, cfg, params):
    """This rank's shard of every leaf of a VLM tree under the FSDP
    rules."""
    from vila_tpu_torch.parallel import mesh as mesh_lib

    mesh = _mesh(**mesh_axes)
    vcfg = vlm_config(**cfg)
    tp = _tree(params, _t)
    dims = mesh_lib.shard_dims(tp, mesh_lib.vlm_param_specs(vcfg, tp, mesh), mesh)
    return _tree(mesh_lib.shard_params(tp, dims, mesh), _np)


def sharded_steps(mesh_axes, cfg, params, batch, optim, sp_attention, layout="zigzag", steps=3,
                  ce_chunk_size=None):
    """`steps` ZeRO-3 steps on one global batch: per step (loss, grad norm),
    then the whole parameters."""
    import torch

    from vila_tpu_torch.parallel import distributed, mesh as mesh_lib
    from vila_tpu_torch.parallel.sp import layout_batch
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_sharded_train_step

    mesh = _mesh(**mesh_axes)
    vcfg = vlm_config(**cfg)
    opt = topt.make_optimizer(topt.OptimizerConfig(**optim))
    step, sh, state, dims = make_sharded_train_step(
        vcfg, _tree(params, _t), opt, mesh, ce_chunk_size=ce_chunk_size,
        sp_attention=sp_attention, ring_layout=layout, attn_impl="xla")
    sp = step.keywords["sp"]
    local = batch_to_device(distributed.host_local_batch(layout_batch(batch, sp), mesh),
                            torch.device("cpu"))
    rows = []
    for _ in range(steps):
        sh, state, m = step(sh, state, local)
        rows.append((float(m["loss"]), float(m["grad_norm"]), int(m["n_tokens"])))
    with torch.no_grad():
        full = mesh_lib.map_tree(lambda t, d: mesh_lib.gather_tensor(t.detach(), d), sh, dims)
    return rows, _tree(full, _np)


def trainer_run(mesh_axes, cfg, params, examples, targs, out_dir, resume_from=None):
    """A `Trainer` on this mesh over a fixed example list; with
    `resume_from`, a fresh Trainer resuming from the latest checkpoint of
    that directory. Returns the logged (step, loss, grad_norm) rows."""
    import shutil

    import torch

    from vila_tpu_torch.data.collate import Collator
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    vcfg = vlm_config(**cfg)
    if resume_from is not None and torch.distributed.get_rank() == 0:
        shutil.copytree(resume_from, out_dir, dirs_exist_ok=True)
    torch.distributed.barrier()
    args = TrainArgs(output_dir=out_dir, **targs)
    coll = Collator(seq_len=targs["seq_len"], pad_token_id=0,
                    tile_size=vcfg.vision.image_size)
    tr = Trainer(vcfg, _tree(params, _t), examples, coll, args, device="cpu")
    res = tr.train()
    return [(r["step"], r["loss"], r["grad_norm"]) for r in res["log_history"]]


def long_context(mesh_axes, llm, params, runs, seq_axes=None):
    """`LongContextEngine.generate` for each (embeds, kwargs of the engine,
    kwargs of generate) run."""
    from vila_tpu_torch.inference.long_context import LongContextEngine

    mesh = _mesh(**mesh_axes)
    cfg = llm_config(**llm)
    p = _tree(params, _t)
    out = []
    for embeds, ekw, gkw in runs:
        eng = LongContextEngine(p, cfg, mesh, seq_axes=seq_axes, **ekw)
        out.append(eng.generate(_t(embeds), **gkw))
    return out


def cache_append(mesh_axes, llm, max_len, k_rows, v_rows, token_valid, fill):
    """The engine's append of (L, 1, s, kvd) rows at `fill` into zeroed
    shards: this rank's (k, v, valid) shard."""
    from vila_tpu_torch.inference.long_context import LongContextEngine

    mesh = _mesh(**mesh_axes)
    cfg = llm_config(**llm)
    from vila_tpu_torch.models import qwen2

    fake = {"embed_tokens": {"embedding": _t(np.zeros((1, 1), np.float32))}}
    eng = LongContextEngine(fake, cfg, mesh, max_cache_len=max_len, prefill_chunk=max_len)
    cache = qwen2.init_cache(cfg, batch=1, max_len=eng.local_len, device="cpu")
    k, v, valid = eng._append(cache["k"], cache["v"], cache["valid"], _t(k_rows), _t(v_rows),
                              _t(token_valid), fill)
    return _np(k), _np(v), valid.numpy()


def extend(mesh_axes, llm, params, lora, batches, eargs):
    """`extend_llm` with the given initial factors: (losses, merged
    q_proj kernel)."""
    from vila_tpu_torch.train.context_extend import ContextExtendArgs, extend_llm

    cfg = llm_config(**llm)
    merged, _, losses = extend_llm(_tree(params, _t), cfg, batches, ContextExtendArgs(**eargs),
                                   lora=_tree(lora, _t))
    return losses, _np(merged["layers"]["q_proj"]["kernel"])


def niah_case(mesh_axes, llm, params, embeds, haystack, needle, answers, contexts, depths):
    """`forward_embeds_sharded` logits and a `run_niah` grid."""
    from vila_tpu_torch.eval import niah

    mesh = _mesh(**mesh_axes)
    cfg = llm_config(**llm)
    p = _tree(params, _t)
    logits = niah.forward_embeds_sharded(p, cfg, _t(embeds), mesh)
    grid = niah.run_niah(p, cfg, _t(haystack), _t(needle), np.asarray(answers),
                         niah.NIAHConfig(context_lengths=contexts, depths=depths), mesh=mesh)
    return _np(logits), grid


def cli_main(module, argv):
    """A command line's `main(argv)` on every rank (the group is already
    up, as torchrun's environment would have made it): its return code."""
    import importlib

    return importlib.import_module(module).main(argv)
