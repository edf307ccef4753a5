"""Sequence-parallel training cells: LongVILA's long-video SFT over one
four-card host, one process a card, through the program's sharded step
(`train/step.make_sharded_train_step` with `sp_attention=True` on a
(dp, sp, su, tp) mesh: ZeRO-3, the ring over the sequence ranks), fed as
the program's `Trainer` feeds a mesh: every rank collates the global row
(`PackingCollator`), lays it out for the ring (`parallel.sp.layout_batch`)
and keeps its part (`parallel.distributed.host_local_batch`).

The parent (`run`) builds the kernels, starts one worker a rank (this file
run as a script) and watches them: a worker that exits with an error, a
parent that dies, or a run past its deadline ends every worker at once and
the run with no result. Each worker initialises its group through
`parallel.distributed.init_distributed` (NCCL on the cards, gloo on the
CPU) with a bounded collective wait.

A worker draws the weights from the seed, builds its step and runs the
check's steps (`check_steps`) and one step on a row of the window's
length (which warms its shapes up), then the window:
steps until the time is up, each ending in a read of the global loss, the
decision to stop taken on rank 0's clock and shared. Rank 0 alone traces
its window (`--trace 1`) and keeps the program's spans; its record is the
run's.

The check's two steps train on one row of the mix's `check_seq_len`
tokens (`check_row`: videos of the run, at least two), half the window's:
the plain reference of a whole row takes minutes on the four cards, which
with set-up and the window would outlast a run's time limit. The first
update's rate is 0, so the second step sees the drawn weights; the second
update is the first that moves them. Once the workers have exited, the
parent runs the plain reference (`reference/long_train.py`) on the same
row over the cards (a control run may hand in the seed's reference as
`ctx["reference"]`) and compares the two steps' losses, each leaf's
clipped first gradient (AdamW's first moment after one step) and each
leaf's step along its gradient over the second update (its change against
AdamW's bias-corrected first moment then), a leaf's sums taken over its
shards on all ranks. A step along the gradient is what a leaf's update
takes off the loss to first order; unlike the change's norm it does not
count the elements whose gradient is rounding residue, which AdamW's first
steps move by the rate whatever their size. An update left unwritten reads
1 on it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Any, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from port_bench import flops, harness, longvideo, program, trace, traffic, weights  # noqa: E402
from port_bench.tokenizer import ByteTokenizer  # noqa: E402

COLLECTIVE_TIMEOUT_S = 600  # a collective's longest wait (a step takes seconds)
SETUP_LIMIT_S = 1200  # workers' set-up and check steps
EXIT_LIMIT_S = 300  # from the window's end to every worker's exit
FAULTS = (None, "frozen", "features", "raise")
CHECK_STEPS = 2  # the check's steps (`reference/long_train.steps`)


def mesh_axes(config) -> Dict[str, int]:
    return dict(config["training"]["mesh"])


def world_of(config) -> int:
    return int(np.prod(list(mesh_axes(config).values())))


def vlm_config(config):
    """The program's config, its LLM recomputed as the configuration says
    (the tower follows the LLM under sequence parallelism)."""
    cfg = program.vlm_config(config, config["training"]["compute_dtype"],
                             config["image_aspect_ratio"])
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                            remat=config["llm"]["remat"]))


def require_program() -> None:
    """Exit without a result where the program lacks what the cell runs:
    the tiles split over the sequence group, with their tower recomputed."""
    from vila_tpu_torch.parallel import sp

    if not hasattr(sp, "gather_media"):
        raise SystemExit("the program lacks parallel.sp.gather_media: it cannot run this cell")


def _samples(cell, seed: int):
    config, mix = cell["config"], cell["traffic"]
    vis = config["vision"]
    per_frame = (vis["image_size"] // vis["patch_size"] // 2) ** 2  # mlp_downsample
    tok = ByteTokenizer()
    return longvideo.samples(mix, config["llm"]["vocab_size"], tok.media_token_ids["image"],
                             per_frame, seed), per_frame


def cell_rows(cell, seed: int):
    """(the rows' samples, the tile pool, the tokens a frame)."""
    samples, per_frame = _samples(cell, seed)
    rows = traffic.rows(samples, cell["config"]["training"]["seq_len"],
                        cell["traffic"]["max_steps"])
    return rows, traffic.tile_pool(cell["traffic"], seed), per_frame


def check_row(cell, seed: int):
    """The check's row of the mix's `check_seq_len` tokens: the run's
    samples in order, each taken that fits in the room left (first fit),
    the first only if the shortest sample still fits after it, so that the
    row packs more than one video."""
    samples, _ = _samples(cell, seed)
    shortest = min(len(s["input_ids"]) for s in samples)
    row, room = [], cell["traffic"]["check_seq_len"]
    for s in samples:
        n = len(s["input_ids"])
        if n <= room and (row or room - n >= shortest):
            row.append(s)
            room -= n
    return row


def rank_pairs(seg: np.ndarray, order: np.ndarray, world: int, rank: int) -> int:
    """(q, k) pairs the causal and segment masks allow for the queries that
    rank `rank` holds in the laid-out row (`order`: laid-out position ->
    causal position)."""
    s = len(seg)
    idx = np.arange(s)
    start = np.zeros(s, np.int64)
    new = np.r_[True, seg[1:] != seg[:-1]]
    start[new] = idx[new]
    start = np.maximum.accumulate(start)
    per = s // world
    mine = order[rank * per:(rank + 1) * per]
    return int(((mine - start[mine] + 1) * (seg[mine] > 0)).sum())


# --------------------------------------------------------------------------
# The parent
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            pass


def launch(ctx: Dict[str, Any], job_dir: str) -> List[Dict[str, Any]]:
    """Run every rank's worker; their records in rank order. Any failure
    ends all of them and raises SystemExit."""
    world = world_of(ctx["cell"]["config"])
    job = {k: ctx[k] for k in ("cell", "seed", "seconds", "trace", "t_start")}
    job.update(device=ctx["device"].type, fault=ctx.get("fault"), world=world,
               port=_free_port())
    with open(os.path.join(job_dir, "job.json"), "w") as f:
        json.dump(job, f)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), job_dir, str(r)],
                              stdout=sys.stderr, cwd=ROOT) for r in range(world)]
    deadline = time.perf_counter() + SETUP_LIMIT_S + ctx["seconds"] + EXIT_LIMIT_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                raise SystemExit(f"[train_sp] ranks {[r for r, _ in bad]} exited with "
                                 f"{[c for _, c in bad]}: every rank stopped, no result")
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() > deadline:
                raise SystemExit("[train_sp] the ranks outlasted the run's deadline: "
                                 "every rank stopped, no result")
            time.sleep(0.2)
    finally:
        _stop(procs)
    recs = []
    for r in range(world):
        with open(os.path.join(job_dir, f"rank{r}.pkl"), "rb") as f:
            recs.append(pickle.load(f))
    return recs


def compare(prog: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """The check's numbers: the largest relative loss gap over the steps,
    and the worst leaf's gradient gap and step gap (`drivers/train.worst`:
    a leaf's gap over the larger of its reference value and the median
    leaf's)."""
    from port_bench.drivers.train import worst

    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    grad, grad_leaf = worst(prog["grad"], want["grad"])
    step, step_leaf = worst(prog["step"], want["step"])
    return {"loss_gap": loss, "grad_gap": grad, "grad_leaf": grad_leaf, "step_gap": step,
            "step_leaf": step_leaf}


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from port_bench.reference import long_train as ref

    require_program()
    cell, seed, device = ctx["cell"], ctx["seed"], ctx["device"]
    config, mix, work = cell["config"], cell["traffic"], cell["workload"]
    on_card = device.type == "cuda"
    if on_card:
        from vila_tpu_torch.ops import _build

        _build.build_all()  # once, before the ranks load the libraries
    os.makedirs(harness.WORK, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=harness.WORK, prefix="train_sp-") as job_dir:
        recs = launch(ctx, job_dir)
    rec = recs[0]
    rec["rank_memory_peaks"] = [r["memory_peak"] for r in recs]
    harness.log(f"[train_sp] memory peaks by rank (bytes): {rec['rank_memory_peaks']}")

    devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
               if on_card else [device])
    t = time.perf_counter()
    check = longvideo.with_tiles(check_row(cell, seed), traffic.tile_pool(mix, seed))
    want = ctx.get("reference") or ref.steps(torch, config, seed, check, devices,
                                             seq_len=mix["check_seq_len"])
    rec["check_s"] = time.perf_counter() - t
    if on_card:  # the reference's blocks go back to the cards
        torch.cuda.empty_cache()
    rec["reference"] = want
    got = compare(rec, want)
    batches_equal = all(np.array_equal(w[k], b[k]) for w, b in zip(want["batches"],
                                                                  rec["batches"])
                        for k in ("input_ids", "labels", "positions", "segment_ids",
                                  "media_positions"))
    harness.log(f"[train_sp] check: the reference's {CHECK_STEPS} steps in "
                f"{rec['check_s']:.1f} s on {len(devices)} devices; losses {rec['losses']} "
                f"against {want['losses']}; worst gradient leaf {got['grad_leaf']}, worst step "
                f"leaf {got['step_leaf']}; rows equal to the reference's packing: "
                f"{batches_equal}; {time.perf_counter() - ctx['t_start']:.1f} s from the run's start")
    lim = work["limits"]
    names = ("loss_gap", "grad_gap", "step_gap")
    rec["compared"] = {n: {"value": got[n], "limit": lim[n]} for n in names}
    rec["correct"] = (batches_equal and rec["failed"] == 0
                      and all(got[n] <= lim[n] for n in names))
    return rec


# --------------------------------------------------------------------------
# A worker (one rank)
# --------------------------------------------------------------------------


def _watch_parent() -> None:
    """End this process when its parent is gone."""
    parent = os.getppid()
    try:
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass

    def poll():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(1.0)

    threading.Thread(target=poll, daemon=True).start()


def _over_leaves(torch, shards, dims, mesh, config, fn) -> Dict[str, float]:
    """Each leaf's sum over the whole leaf of `fn(shard)` (a sum over the
    shard, or None for 0): summed over the FSDP group for split leaves, a
    whole leaf counted once."""
    import torch.distributed as dist

    from port_bench.reference.train import get, leaf_paths
    from vila_tpu_torch.parallel.mesh import FSDP

    paths = leaf_paths(config)
    names, sums, split = [], [], []
    for c in paths:
        for p in paths[c]:
            t, d = get(shards[c], p), get(dims[c], p)
            x = fn(t)
            sums.append(torch.zeros((), device=t.device, dtype=torch.float64) if x is None
                      else x.to(torch.float64))
            names.append("/".join((c,) + tuple(p)))
            split.append(d is not None and d.fsdp is not None)
    sums = torch.stack(sums)
    parts = sums * torch.tensor(split, device=sums.device, dtype=sums.dtype)
    dist.all_reduce(parts, group=mesh.group(FSDP))
    total = torch.where(torch.tensor(split, device=sums.device), parts, sums)
    return dict(zip(names, total.tolist()))


def _apply_fault(fault, world, rank):
    """Break the program underneath the timed path (the check's controls
    and the tests'): "frozen" computes every update (moments included) and
    writes none back; "features" zeroes rank 1's gathered tiles; "raise"
    makes rank 1's first step raise while the others wait in its
    collectives."""
    if fault == "raise":
        if rank == 1:
            from vila_tpu_torch.train import step

            def raises(*a, **kw):
                raise RuntimeError("a rank's step failed")

            step.sharded_train_step = raises
    elif fault == "frozen":
        import torch

        from vila_tpu_torch.train import optimizer

        inner = optimizer.Optimizer.update

        def unwritten(self, opt_state, params, norm=None):
            ts = optimizer.leaves(params)
            before = [t.detach().clone() for t in ts]
            opt_state = inner(self, opt_state, params, norm)
            with torch.no_grad():
                for t, b in zip(ts, before):
                    t.copy_(b)
            return opt_state

        optimizer.Optimizer.update = unwritten
    elif fault == "features":
        from vila_tpu_torch.parallel import sp as sp_lib

        inner = sp_lib.gather_media

        def zeroed(feats, sp, held):
            out = inner(feats, sp, held)
            keep = out.new_ones((world, out.shape[0] // world) + (1,) * (out.dim() - 1))
            keep[1] = 0
            return out * keep.reshape((-1,) + (1,) * (out.dim() - 1))

        sp_lib.gather_media = zeroed
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")


def worker(job_dir: str, rank: int) -> None:
    _watch_parent()
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    import torch
    import torch.distributed as dist

    from port_bench.drivers.train import optimizer_config
    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.parallel import distributed
    from vila_tpu_torch.parallel import mesh as mesh_lib
    from vila_tpu_torch.parallel.sp import SPConfig, layout_batch
    from vila_tpu_torch.train.optimizer import leaves as optimizer_leaves
    from vila_tpu_torch.train.optimizer import make_optimizer
    from vila_tpu_torch.train.step import batch_to_device, make_sharded_train_step
    from vila_tpu_torch.utils import profiling

    cell, seed, world = job["cell"], job["seed"], job["world"]
    config, mix = cell["config"], cell["traffic"]
    tc = config["training"]
    on_card = job["device"] == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
        device = torch.device("cuda", rank)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    distributed.init_distributed(f"tcp://127.0.0.1:{job['port']}", world, rank,
                                 backend="nccl" if on_card else "gloo",
                                 timeout=COLLECTIVE_TIMEOUT_S)
    marks = {"group": time.perf_counter() - job["t_start"]}
    _apply_fault(job["fault"], world, rank)
    mesh = mesh_lib.make_mesh(**mesh_axes(config))
    cfg = vlm_config(config)
    rows, pool, _ = cell_rows(cell, seed)
    check = check_row(cell, seed)
    collators = {n: PackingCollator(seq_len=n, rows=tc["rows"],
                                    pad_token_id=ByteTokenizer().pad_token_id,
                                    tile_size=cfg.vision.image_size)
                 for n in (tc["seq_len"], mix["check_seq_len"])}
    plan = SPConfig(mesh=mesh, ring_layout=tc["ring_layout"])
    params = weights.vlm_tree(torch, config, seed, device, torch.float32)
    optimizer = make_optimizer(optimizer_config(tc))
    step_fn, shards, opt_state, dims = make_sharded_train_step(
        cfg, params, optimizer, mesh, sp_attention=True, ring_layout=tc["ring_layout"])
    del params
    if on_card:
        torch.cuda.empty_cache()
    marks["state"] = time.perf_counter() - job["t_start"]
    session = trace.Session(os.path.join(job_dir, "trace.json")) if job["trace"] and rank == 0 \
        else None
    if session is not None:
        n_updates = iter(range(1 << 30))
        session.spans.wrap(optimizer, "update", lambda *a, **kw: f"optimizer#{next(n_updates)}")

    def span(name):
        return session.spans.open(name) if session is not None else contextlib.nullcontext()

    def one_step(k, row, seq_len=tc["seq_len"]):
        with span(f"train_step#{k}"):
            with span("collate"):
                batch = collators[seq_len](longvideo.with_tiles(row, pool))
                local = distributed.host_local_batch(layout_batch(batch, plan), mesh)
            with span("to_device"):
                dev_batch = batch_to_device(local, device)
            _, _, metrics = step_fn(shards, opt_state, dev_batch)
            loss = float(metrics["loss"])
        return batch, loss

    if mix["check_steps"] != CHECK_STEPS:
        raise ValueError(f"the check takes {CHECK_STEPS} steps, the mix {mix['check_steps']}")
    rec: Dict[str, Any] = {"losses": [], "batches": []}
    for k in range(CHECK_STEPS):
        batch, loss = one_step(k, check, mix["check_seq_len"])
        marks[f"check_step{k}"] = time.perf_counter() - job["t_start"]
        rec["losses"].append(loss)
        rec["batches"].append({key: batch[key][0] for key in
                               ("input_ids", "labels", "positions", "segment_ids",
                                "media_positions")})
        state = {id(t): s for o in opt_state.adamw.values() for t, s in o.state.items()}
        if k == 0:
            sq = _over_leaves(torch, shards, dims, mesh, config,
                              lambda t: ((state[id(t)]["exp_avg"].float() / (1.0 - tc["b1"]))
                                         .square().sum(dtype=torch.float64)
                                         if id(t) in state else None))
            rec["grad"] = {n: v ** 0.5 for n, v in sq.items()}
            drawn = {id(t): t.detach().to("cpu", copy=True)
                     for t in optimizer_leaves(shards)}
        elif k == 1:  # the step along AdamW's bias-corrected first moment
            with torch.no_grad():
                rec["step"] = _over_leaves(
                    torch, shards, dims, mesh, config,
                    lambda t: (((drawn[id(t)].to(t.device) - t.detach())
                                * (state[id(t)]["exp_avg"] / (1.0 - tc["b1"] ** 2)))
                               .sum(dtype=torch.float64) if id(t) in state else None))
            del drawn
    if on_card:
        torch.cuda.empty_cache()
    one_step(CHECK_STEPS - 1, rows[CHECK_STEPS - 1])  # the window's shapes
    marks["warm_step"] = time.perf_counter() - job["t_start"]
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    if session is not None:
        session.warm()
    dist.barrier()
    setup_s = time.perf_counter() - job["t_start"]
    if rank == 0:
        harness.log("[train_sp] rank 0 set-up, s from the run's start: " + ", ".join(
            f"{k} {v:.1f}" for k, v in marks.items()) + f", set-up {setup_s:.1f}")
    _build.reset_launches()

    order = None
    steps: Dict[int, Dict[str, Any]] = {}
    flag = torch.zeros(1, device=device)
    w0 = time.perf_counter()
    w1 = w0 + job["seconds"]
    tr0 = w0 + (job["seconds"] - mix["trace_s"]) / 2
    tr_state = "before" if session else "off"
    k = CHECK_STEPS
    while True:
        now = time.perf_counter()
        if tr_state == "before" and now >= tr0:
            tr_end = session.start() + mix["trace_s"]
            tr_state = "on"
        elif tr_state == "on" and now >= tr_end:
            session.stop()
            tr_state = "done"
        if k >= len(rows):
            raise RuntimeError(f"the mix's {mix['max_steps']} rows ran out in the window")
        t = time.perf_counter()
        batch, loss = one_step(k, rows[k])
        t_end = time.perf_counter()
        if rank == 0:
            seg = batch["segment_ids"][0]
            if order is None:
                from vila_tpu_torch.parallel.ring_attention import zigzag_order

                order = (zigzag_order(len(seg), plan.ring_degree)
                         if plan.layout_for(len(seg)) == "zigzag" else np.arange(len(seg)))
            frames = int((np.asarray(batch["media_positions"][0]) < len(seg)).sum()
                         // (cfg.tokens_per_image or 1))
            steps[k] = {"wall": t_end - t, "tokens": int((seg > 0).sum()), "tiles": frames,
                        "pairs": flops.segment_pairs(seg),
                        "rank_pairs": rank_pairs(seg, order, world, 0),
                        "rank_tokens": int((seg[order[:len(seg) // world]] > 0).sum()),
                        "loss": loss, "traced": tr_state == "on"}
        k += 1
        flag.fill_(1.0 if t_end >= w1 else 0.0)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if flag.item() > 0:
            break
    if tr_state == "on":
        session.stop()
    rec["memory_peak"] = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    if rank == 0:
        window_s = t_end - w0
        tokens = sum(s["tokens"] for s in steps.values())
        losses_ok = all(np.isfinite(s["loss"]) for s in steps.values())
        tr = trace.summarise(session)
        spans = None
        if tr is not None:
            spans = [s for s in profiling.recorded() if tr.t0 <= s.start and s.end <= tr.t1]
        layers = config["llm"]["num_hidden_layers"]
        harness.log(f"[train_sp] {len(steps)} steps in {window_s:.3f} s, {tokens} tokens, loss "
                    f"{steps[CHECK_STEPS]['loss']:.4f} -> {steps[k - 1]['loss']:.4f}; "
                    f"launches {dict(_build.LAUNCHES)} (K7 at least {layers} x 2 x 4 ring steps "
                    f"x steps)")
        rec.update(config=config, setup_s=setup_s, steps=steps, window_s=window_s,
                   launches=dict(_build.LAUNCHES), attempted=len(steps),
                   failed=0 if losses_ok else len(steps),
                   metrics={"train_tok_s": tokens / window_s}, trace=tr, program_spans=spans)
    with open(os.path.join(job_dir, f"rank{rank}.pkl.tmp"), "wb") as f:
        pickle.dump(rec if rank == 0 else {"memory_peak": rec["memory_peak"]}, f)
    os.replace(os.path.join(job_dir, f"rank{rank}.pkl.tmp"),
               os.path.join(job_dir, f"rank{rank}.pkl"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    for key, value in (("USE_FLAX", "0"), ("USE_TF", "0")):
        os.environ.setdefault(key, value)
    try:
        worker(sys.argv[1], int(sys.argv[2]))
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)
