"""Training cells: NVILA supervised fine-tuning through the program's train
step (`train/step.make_train_step`, as `Trainer` builds it: AdamW with the
stage's per-component rates and clipping, f32 master weights, bf16
compute), fed by the program's `PackingCollator` with one packed row a
step.

Set-up makes the weights on the device from the seed, builds the one step
object, and drives it through its first steps (`check_steps`) on the same
feed and call the window then uses: those steps are the check's, and they
warm every shape up. The window runs steps until its time is up; each step
ends in a read of its loss (as a trainer that logs every step), so a step's
host wall is its time. No checkpoint is written.

The check, once the program's state is freed: the reference
(`reference/train.py`) follows the first steps from the same samples, and
each step's loss, each leaf's first clipped gradient (from the optimizer's
first moment after one step) and each leaf's change after the last check
step (against the weights drawn again) are compared, each by its worst
leaf.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Any, Dict

import numpy as np

from port_bench import flops, harness, program, trace, traffic, weights
from port_bench.reference import train as ref
from port_bench.tokenizer import ByteTokenizer

EXCLUDE_BELOW = 1e-3  # leaves whose reference gradient is under this share of the median's


def optimizer_config(tc: Dict[str, Any]):
    from vila_tpu_torch.train.optimizer import OptimizerConfig

    return OptimizerConfig(
        learning_rate=tc["learning_rate"], mm_projector_lr=tc["mm_projector_lr"],
        vision_tower_lr=tc["vision_tower_lr"], weight_decay=tc["weight_decay"], b1=tc["b1"],
        b2=tc["b2"], eps=tc["eps"], warmup_ratio=tc["warmup_ratio"],
        total_steps=tc["total_steps"], schedule=tc["lr_schedule"],
        max_grad_norm=tc["max_grad_norm"], optimizer=tc["optimizer"])


def leaf_norms(torch, tree, paths, fn) -> Dict[str, float]:
    return {"/".join((c,) + tuple(p)): float(torch.linalg.vector_norm(fn(c, p, ref.get(tree[c], p))))
            for c in paths for p in paths[c]}


def first_gradients(torch, opt_state, params, paths, b1) -> Dict[str, float]:
    """Each leaf's norm of the clipped gradient AdamW took at its first
    step: its first moment over (1 - b1). A step that moved nothing has no
    moment: its gradient reads 0."""
    state = {id(t): s for o in opt_state.adamw.values() for t, s in o.state.items()}
    return leaf_norms(torch, params, paths,
                      lambda c, p, t: state.get(id(t), {}).get("exp_avg", torch.zeros_like(t))
                      / (1.0 - b1))


def worst(got: Dict[str, float], want: Dict[str, float], keep=None) -> tuple:
    """(the worst leaf's gap, that leaf): |got - want| over the larger of
    the leaf's reference norm and the median leaf's."""
    names = [k for k in want if keep is None or k in keep]
    med = statistics.median(want[k] for k in names)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], med) for k in names}
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def compare(prog: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, Any]:
    """The check's numbers: the largest relative loss gap over the steps,
    the worst leaf's first-gradient gap, and the worst leaf's change gap
    (leaves whose reference gradient is rounding residue left out)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], want["losses"]))
    grad, grad_leaf = worst(prog["grad"], want["grad"])
    med = statistics.median(want["grad"].values())
    keep = {k for k, g in want["grad"].items() if g >= EXCLUDE_BELOW * med}
    change, change_leaf = worst(prog["change"], want["change"], keep)
    return {"loss_gap": loss, "grad_gap": grad, "grad_leaf": grad_leaf,
            "change_gap": change, "change_leaf": change_leaf,
            "left_out": sorted(set(want["grad"]) - keep)}


def same_batch(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> bool:
    """The program's collated row against the reference's packing."""
    ok = all(np.array_equal(np.asarray(got[k])[0], want[k])
             for k in ("input_ids", "labels", "positions", "segment_ids"))
    if want["tiles"] is None:
        return ok and "pixel_values" not in got
    return (ok and np.array_equal(got["pixel_values"][0], want["tiles"])
            and np.array_equal(got["media_positions"][0], want["media_positions"]))


def run(ctx: Dict[str, Any]) -> Dict[str, Any]:
    import torch

    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.ops import _build
    from vila_tpu_torch.train.optimizer import make_optimizer
    from vila_tpu_torch.train.step import batch_to_device, make_train_step

    cell, seed, seconds, device = ctx["cell"], ctx["seed"], ctx["seconds"], ctx["device"]
    config, mix, work = cell["config"], cell["traffic"], cell["workload"]
    tc = config["training"]
    on_card = device.type == "cuda"
    if on_card:
        _build.build_all()
    cfg = program.vlm_config(config, tc["compute_dtype"], config["image_aspect_ratio"])
    tok = ByteTokenizer()
    samples = traffic.train_samples(mix, config["llm"]["vocab_size"],
                                    tok.media_token_ids["image"], cfg.tokens_per_image, seed)
    all_rows = traffic.rows(samples, tc["seq_len"], mix["max_steps"])
    collator = PackingCollator(seq_len=tc["seq_len"], rows=tc["rows"],
                               pad_token_id=tok.pad_token_id, tile_size=cfg.vision.image_size)
    params = weights.vlm_tree(torch, config, seed, device, torch.float32)
    optimizer = make_optimizer(optimizer_config(tc))
    step_fn, params, opt_state = make_train_step(cfg, params, optimizer)
    paths = ref.leaf_paths(config)
    session = trace.Session(ctx["trace_path"]) if ctx["trace"] else None
    if session is not None:
        n_updates = iter(range(1 << 30))
        session.spans.wrap(optimizer, "update", lambda *a, **kw: f"optimizer#{next(n_updates)}")

    def span(name):
        return session.spans.open(name) if session is not None else contextlib.nullcontext()

    def one_step(k):
        with span(f"train_step#{k}"):
            with span("collate"):
                batch = collator(all_rows[k])
            with span("to_device"):
                dev_batch = batch_to_device(batch, device)
            _, _, metrics = step_fn(params, opt_state, dev_batch)
            loss = float(metrics["loss"])
        return batch, loss

    check_steps = mix["check_steps"]
    prog: Dict[str, Any] = {"losses": [], "batches": []}
    for k in range(check_steps):
        batch, loss = one_step(k)
        prog["losses"].append(loss)
        prog["batches"].append(batch)
        if k == 0:
            prog["grad"] = first_gradients(torch, opt_state, params, paths, tc["b1"])
    spec = {c: {p: (shape, kind) for p, shape, kind in weights.vlm_spec(config)[c]}
            for c in paths}
    with torch.no_grad():
        prog["change"] = leaf_norms(
            torch, params, paths,
            lambda c, p, t: t - weights.draw(torch, seed, c, p, *spec[c][p], config["weights"],
                                             device, torch.float32))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - ctx["t_start"]
    _build.reset_launches()

    if session is not None:
        session.warm()
    steps: Dict[int, Dict[str, Any]] = {}
    w0 = time.perf_counter()
    w1 = w0 + seconds
    tr0 = w0 + (seconds - mix["trace_s"]) / 2
    tr_state = "before" if session else "off"
    k = check_steps
    while True:
        now = time.perf_counter()
        if tr_state == "before" and now >= tr0:
            tr_end = session.start() + mix["trace_s"]
            tr_state = "on"
        elif tr_state == "on" and now >= tr_end:
            session.stop()
            tr_state = "done"
        if k >= len(all_rows):
            raise RuntimeError(f"the mix's {mix['max_steps']} rows ran out in the window")
        t = time.perf_counter()
        batch, loss = one_step(k)
        t_end = time.perf_counter()
        seg = batch["segment_ids"][0]
        steps[k] = {"wall": t_end - t, "tokens": int((seg > 0).sum()), "tiles":
                    len(batch["pixel_values"][0]) if "pixel_values" in batch else 0,
                    "pairs": flops.segment_pairs(seg), "loss": loss,
                    "traced": tr_state == "on"}
        k += 1
        if t_end >= w1:
            break
    if tr_state == "on":
        session.stop()
    window_s = t_end - w0
    launches = dict(_build.LAUNCHES)
    memory_peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    n_steps = len(steps)
    tokens = sum(s["tokens"] for s in steps.values())
    losses_ok = all(np.isfinite(s["loss"]) for s in steps.values())
    layers = config["llm"]["num_hidden_layers"]
    harness.log(f"[train] {n_steps} steps in {window_s:.3f} s, {tokens} tokens, loss "
                f"{steps[check_steps]['loss']:.4f} -> {steps[k - 1]['loss']:.4f}; launches "
                f"{launches}; K7-K9 expected {layers} x {n_steps} = {layers * n_steps} each")
    rec = {"config": config, "setup_s": setup_s, "steps": steps,
           "window_s": window_s, "launches": launches, "memory_peak": memory_peak,
           "attempted": n_steps, "failed": 0 if losses_ok else n_steps,
           "metrics": {"train_tok_s": tokens / window_s},
           "trace": trace.summarise(session)}

    del step_fn, params, opt_state, optimizer
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    want = ref.steps(torch, config, seed, all_rows[:check_steps], device)
    got = compare(prog, want)
    batches_equal = all(same_batch(g, w) for g, w in zip(prog["batches"], want["batches"]))
    harness.log(f"[train] check: {check_steps} steps of the reference in "
                f"{time.perf_counter() - t:.1f} s; losses {prog['losses']} against "
                f"{want['losses']}; worst gradient leaf {got['grad_leaf']}, worst change "
                f"leaf {got['change_leaf']}; left out of the change: {got['left_out']}; "
                f"collated rows equal to the reference's packing: {batches_equal}")
    lim = work["limits"]
    rec["compared"] = {n: {"value": got[n], "limit": lim[n]}
                       for n in ("loss_gap", "grad_gap", "change_gap")}
    rec["correct"] = (batches_equal and losses_ok
                      and all(got[n] <= lim[n] for n in ("loss_gap", "grad_gap", "change_gap")))
    return rec

