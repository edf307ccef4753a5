"""The port's sharded training step on meshes with tp
(`train.step.make_sharded_train_step` over (dp, sp, su, tp): ZeRO-3 over
the FSDP group and Megatron tensor parallelism), its other optimizers (fp8
AdamW with the whole tensor's blocks, the tree optimizers), PS3's selection
loss, the Trainer and `cli.train` at tp 2, against the JAX package on the
CPU. The port runs in gloo processes at world sizes 2 and 4 (one spawn a
world size); JAX's references run once on one virtual device (the
reference its own sharded tests hold its meshes to).

Bars (float32): losses and grad norms rtol 2e-5 over 3 steps; parameters
after 3 steps by share, as `test_torch_sp.py` (99 % within atol 2e-6 /
rtol 1e-4, every one within 3 steps x the largest learning rate: AdamW
normalises rounding residue into updates of up to lr); fp8 AdamW's state
bytes and block scales bit for bit against one device's for the same
gradients, and its loss curve within `tests/test_train_extras.py`'s bar
(0.35) and rtol 1e-4 of JAX's (jitted JAX rounds the block scales through
a reciprocal, `test_torch_fp8.py`); PS3's losses rtol 2e-5 and grad norm
rtol 1e-4 (`test_torch_ps3_train.py`'s) and its parameters as above; the
Trainer's and the command line's logged losses rtol 2e-5.
"""

import dataclasses
import functools
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import helpers
import torch_dist_helpers as dh
from gen_goldens import FLAVORS
from test_torch_ps3_train import _examples as ps3_examples
from test_torch_ps3_train import _params as ps3_params
from test_torch_ps3_train import _vlm as ps3_vlm
from test_torch_sp import (
    OPTIM,
    PARAM_TOL,
    TRAIN_ARGS,
    _examples,
    _jax_trainer,
    cfg_kwargs,
    vlm_batch,
    vlm_cfg,
    vlm_params,
)
from vila_tpu.data import collate as jcollate
from vila_tpu.parallel import mesh as jmesh
from vila_tpu.train import optimizer as jopt
from vila_tpu.train.step import make_sharded_train_step as jmake_sharded_train_step
from vila_tpu_torch.cli import train as train_cli

STEP_CASES = [  # (id, world, mesh axes, sp_attention, layout, optimizer key)
    ("dp2-tp2", 4, dict(dp=2, tp=2), False, "zigzag", "adamw"),
    ("sp2-tp2", 4, dict(sp=2, tp=2), True, "zigzag", "adamw"),
    ("dp2-tp2-tree-adamw", 4, dict(dp=2, tp=2), False, "zigzag", "tree"),
    ("dp2-tp2-fp8", 4, dict(dp=2, tp=2), False, "zigzag", "fp8_adamw"),
    ("dp2-tp2-coat-fp8", 4, dict(dp=2, tp=2), False, "zigzag", "coat"),
    ("tp2-remat", 2, dict(tp=2), False, "zigzag", "remat"),
    ("dp2-tp2-remat-dots", 4, dict(dp=2, tp=2), False, "zigzag", "dots"),
    ("tp4-head-fallback-remat", 4, dict(tp=4), False, "zigzag", "remat"),
]
OPTIMS = {"adamw": OPTIM, "fp8_adamw": dict(OPTIM, optimizer="fp8_adamw"),
          "coat": dict(OPTIM, optimizer="fp8_adamw"), "remat": OPTIM, "dots": OPTIM,
          "tree": {"tree": "adamw", "learning_rate": 1e-3}}
REMAT = {"remat": True, "dots": "dots"}


def _cfg(opt_key):
    """The VLM of `test_torch_sp.py`; "coat" runs its decoder projections
    in per-tensor fp8 (COAT) beside fp8 AdamW, as
    `tests/test_train_extras.py::test_fp8_train_step_e2e`; "remat" and
    "dots" recompute its decoder layers in the backward (`LLMConfig.remat`
    True and "dots"), on both sides."""
    cfg = vlm_cfg()
    if opt_key == "coat":
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, fp8_matmul=True))
    if opt_key in REMAT:
        cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, remat=REMAT[opt_key]))
    return cfg
PS3_CASES = [("dp2", dict(dp=2)), ("tp2", dict(tp=2))]
PS3_OPTIM = dict(learning_rate=1e-3, schedule="constant", warmup_ratio=0.0, eps=1e-6,
                 tune_language_model=False)
FP8_SHAPE, FP8_SPLIT = (6, 40), (0, 1)  # FSDP on dim 0, tp on dim 1


def _ps3_case():
    jcfg, _ = ps3_vlm()
    batch = jcollate.Collator(seq_len=40, tile_size=28)(ps3_examples(jcfg, 8))
    vis = jcfg.vision
    cfg = dict(llm=dh.config_fields(jcfg.llm), vit=dh.config_fields(vis.vit),
               ps3={k: v for k, v in dh.config_fields(vis).items() if k != "vit"},
               projector=dh.config_fields(jcfg.projector))
    return jcfg, cfg, ps3_params(jcfg, 7), batch


def _fp8_grads():
    rng = np.random.default_rng(11)
    spread = np.exp(rng.uniform(-6, 2, FP8_SHAPE)).astype(np.float32)
    return [(rng.standard_normal(FP8_SHAPE) * spread).astype(np.float32) for _ in range(2)]


def _cli_argv(ckpt, out, **extra):
    argv = ["--model-path", ckpt, "--device", "cpu", "--stage", "sft",
            "--data-mixture", "dummy_mix", "--max-steps", "2", "--save-steps", "2",
            "--seq-len", "256", "--logging-steps", "1", "--output-dir", out,
            "--ce-chunk-size", "128"]
    for k, v in extra.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    runs = {2: [], 4: []}
    for name, world, axes, spa, layout, opt in STEP_CASES:
        runs[world].append((("step", name), ("sharded_steps", dict(
            mesh_axes=axes, cfg=cfg_kwargs(_cfg(opt)), params=vlm_params(), batch=vlm_batch(),
            optim=OPTIMS[opt], sp_attention=spa, layout=layout))))
    runs[4].append((("fp8_state", "dp2-tp2"), ("fp8_state", dict(
        mesh_axes=dict(dp=2, tp=2), grads=_fp8_grads(), split=FP8_SPLIT))))
    # fp8 AdamW's sharded state through a checkpoint and back on the mesh
    fp8_args = dict(TRAIN_ARGS, dp=2, tp=2, distributed=False, optimizer="fp8_adamw")
    for key, steps, resume in (("at2", 2, None), ("resumed", 4, "fp8-at2"), ("full", 4, None)):
        runs[4].append((("fp8_trainer", key), ("trainer_run", dict(
            mesh_axes=dict(dp=2, tp=2), cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(),
            examples=_examples(), targs=dict(fp8_args, max_steps=steps),
            out_dir=str(tmp / f"fp8-{key}"),
            resume_from=None if resume is None else str(tmp / resume)))))
    _, pcfg, pparams, pbatch = _ps3_case()
    for name, axes in PS3_CASES:
        runs[2].append((("ps3", name), ("ps3_steps", dict(
            mesh_axes=axes, cfg=pcfg, params=pparams, batch=pbatch, optim=PS3_OPTIM))))
    runs[2].append((("trainer", "tp2"), ("trainer_run", dict(
        mesh_axes=dict(tp=2), cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(),
        examples=_examples(), targs=dict(TRAIN_ARGS, tp=2, distributed=False),
        out_dir=str(tmp / "trainer-tp2")))))
    ckpt = str(tmp / "base")
    helpers.save_tiny_checkpoint(ckpt, seed=0, **FLAVORS["base"])
    runs[2].append((("cli", "tp2"), ("cli_main", dict(
        module="vila_tpu_torch.cli.train",
        argv=_cli_argv(ckpt, str(tmp / "cli-tp2"), distributed="true", tp=2)))))
    out = {"tmp": tmp, "ckpt": ckpt}
    for world, cases in runs.items():
        ranks = dh.spawn([c for _, c in cases], world, timeout=400)
        for i, (key, _) in enumerate(cases):
            out[key] = [r[i] for r in ranks]
    return out


# --------------------------------------------------------------------------
# JAX references (one device)
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_steps(opt_key, steps=3):
    cfg = _cfg(opt_key)
    mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    if opt_key == "tree":
        opt = optax.adamw(OPTIMS["tree"]["learning_rate"])
    else:
        opt = jopt.make_optimizer(jopt.OptimizerConfig(**OPTIMS[opt_key]))
    step, params, state, batch_sh = jmake_sharded_train_step(
        cfg, jax.tree.map(jnp.asarray, vlm_params()), opt, mesh)
    batch = {k: jax.device_put(jnp.asarray(v), batch_sh[k]) for k, v in vlm_batch().items()}
    rows = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"]), int(m["n_tokens"])))
    return rows, jax.tree.map(np.asarray, params)


def _params_by_share(params, want_params, lr):
    close = total = 0
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        leaf = params
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, err_msg=jax.tree_util.keystr(path), rtol=0,
                                   atol=3 * lr)
        close += int(np.isclose(leaf, want, **PARAM_TOL).sum())
        total += want.size
    assert close >= 0.99 * total, (close, total)


# --------------------------------------------------------------------------
# the sharded step under tp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,world,axes,spa,layout,opt", STEP_CASES,
                         ids=[c[0] for c in STEP_CASES])
def test_sharded_step_under_tp_matches_jax(name, world, axes, spa, layout, opt, port):
    """ZeRO-3 over (dp, sp, su) and tensor parallelism over tp: 3 steps of
    AdamW (component clipping), of `optimizer.adamw` over the whole tree
    (optax.adamw: no clipping), of fp8 AdamW and of AdamW with the decoder
    layers rematerialised (whole heads, and the tp 4 head fallback),
    against JAX's `make_sharded_train_step` on the same batch."""
    want_rows, want_params = _jax_steps(opt)
    rows, params = port[("step", name)][0]
    for r in port[("step", name)][1:]:
        assert r[0] == rows  # global metrics: the same on every rank
    for (l, g, n), (wl, wg, wn) in zip(rows, want_rows):
        assert n == wn
        if opt in ("fp8_adamw", "coat"):
            assert abs(l - wl) < 0.35  # tests/test_train_extras.py:319-322
        if opt == "fp8_adamw":
            np.testing.assert_allclose([l, g], [wl, wg], rtol=1e-4)
        elif opt != "coat":
            np.testing.assert_allclose([l, g], [wl, wg], rtol=2e-5)
    if opt == "coat":  # the port's one-device COAT step (held to JAX op by op)
        np.testing.assert_allclose([r[:2] for r in rows], _port_one_device(opt), rtol=1e-4)
    elif opt != "fp8_adamw":
        _params_by_share(params, want_params, 2e-3)


@functools.lru_cache(maxsize=None)
def _port_one_device(opt_key, steps=3):
    """The port's `make_train_step` on the CPU: (loss, grad norm) a step."""
    from vila_tpu_torch.train import optimizer as topt
    from vila_tpu_torch.train.step import batch_to_device, make_train_step

    cfg = dh.vlm_config(**cfg_kwargs(_cfg(opt_key)))
    opt = topt.make_optimizer(topt.OptimizerConfig(**OPTIMS[opt_key]))
    step, p, st = make_train_step(cfg, dh._tree(vlm_params(), lambda x: torch.tensor(x)), opt)
    batch = batch_to_device(vlm_batch(), torch.device("cpu"))
    rows = []
    for _ in range(steps):
        p, st, m = step(p, st, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


def test_sharded_fp8_state_is_one_devices_byte_for_byte(port):
    """A (6, 40) leaf split over FSDP (dim 0) and tp (dim 1) on (dp=2,
    tp=2): its 240 elements make 2 blocks of 128, each crossing shard
    boundaries. After 2 steps of the same whole gradients, the gathered
    moments' fp8 bytes, every block scale and the parameter equal one
    device's `FP8AdamW`."""
    from vila_tpu_torch.train import fp8_adamw

    p = torch.zeros(FP8_SHAPE)
    opt = fp8_adamw.FP8AdamW([p], lr=1e-3, weight_decay=0.01)
    for g in _fp8_grads():
        p.grad = torch.as_tensor(g)
        opt.step()
    st = opt.state[p]
    for rank in port[("fp8_state", "dp2-tp2")]:
        for key in ("mu", "nu"):
            np.testing.assert_array_equal(rank[key], st[key].view(torch.uint8).numpy())
            np.testing.assert_array_equal(rank[key + "_scale"], st[key + "_scale"].numpy())
        np.testing.assert_array_equal(rank["param"], p.numpy())
    assert st["mu_scale"].shape == (2,) and len(set(st["nu_scale"].tolist())) == 2


# --------------------------------------------------------------------------
# PS3's sharded step
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_ps3(steps=2):
    jcfg, _, params, batch = _ps3_case()
    mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    opt = jopt.make_optimizer(jopt.OptimizerConfig(**PS3_OPTIM))
    step, p, state, batch_sh = jmake_sharded_train_step(jcfg, jax.tree.map(jnp.asarray, params),
                                                        opt, mesh)
    b = {k: jax.device_put(jnp.asarray(v), batch_sh.get(k)) for k, v in batch.items()}
    rows = []
    for _ in range(steps):
        p, state, m = step(p, state, b)
        rows.append((float(m["loss"]), float(m["token_selection_loss"]), float(m["grad_norm"])))
    return rows, jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("name,axes", PS3_CASES, ids=[c[0] for c in PS3_CASES])
def test_ps3_sharded_step_matches_jax(name, axes, port):
    """VILA-HD stage 1.5 (the tower and projector tuned, the LLM frozen)
    on dp 2 (one row each; only the first has a gt map) and tp 2: the LM
    plus selection loss, the selection loss alone, the grad norm and the
    parameters after 2 steps against JAX's sharded step."""
    want_rows, want_params = _jax_ps3()
    rows, params = port[("ps3", name)][0]
    for r in port[("ps3", name)][1:]:
        assert r[0] == rows
    for (l, s, g), (wl, ws, wg) in zip(rows, want_rows):
        np.testing.assert_allclose([l, s], [wl, ws], rtol=2e-5)
        np.testing.assert_allclose(g, wg, rtol=1e-4)
    assert rows[0][1] > 0
    _params_by_share(params, want_params, 1e-3)


# --------------------------------------------------------------------------
# the Trainer and the command line at tp 2
# --------------------------------------------------------------------------


def test_trainer_at_tp2_matches_jax_and_resumes_at_world_size_one(port, tmp_path):
    """The Trainer at tp 2 logs JAX's Trainer's losses (one device, the
    same global batches); its step-2 checkpoint (whole tensors) resumed by
    one process gives steps 3 and 4 again."""
    from vila_tpu_torch.data.collate import Collator
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    want = _jax_trainer(str(tmp_path / "jax"))
    full = port[("trainer", "tp2")][0]
    assert [r[0] for r in full] == [w[0] for w in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[1:] for r in full], [w[1:] for w in want], rtol=2e-5)
    src = os.path.join(port["tmp"], "trainer-tp2", "checkpoints", "checkpoint-2")
    out = tmp_path / "resumed"
    shutil.copytree(src, out / "checkpoints" / "checkpoint-2")
    cfg = dh.vlm_config(**cfg_kwargs(vlm_cfg()))
    tr = Trainer(cfg, dh._tree(vlm_params(), lambda x: torch.tensor(x)), _examples(),
                 Collator(seq_len=64, pad_token_id=0, tile_size=28),
                 TrainArgs(output_dir=str(out), **TRAIN_ARGS), device="cpu")
    resumed = [(r["step"], r["loss"], r["grad_norm"]) for r in tr.train()["log_history"]]
    assert [r[0] for r in resumed] == [3, 4]
    np.testing.assert_allclose([r[1:] for r in resumed], [r[1:] for r in full[2:]], rtol=2e-5)


def test_fp8_trainer_resumes_on_the_mesh(port):
    """fp8 AdamW's sharded moments go into a checkpoint whole (one device's
    (nb, 128) bytes) and come back cut to the mesh: a Trainer on (dp=2,
    tp=2) resumed from step 2 repeats the uninterrupted run's steps 3 and 4
    exactly."""
    full = port[("fp8_trainer", "full")][0]
    resumed = port[("fp8_trainer", "resumed")][0]
    assert [r[0] for r in full] == [1, 2, 3, 4] and [r[0] for r in resumed] == [3, 4]
    assert [r[1:] for r in resumed] == [r[1:] for r in full[2:]]
    state = torch.load(os.path.join(port["tmp"], "fp8-at2", "checkpoints", "checkpoint-2",
                                    "state.pt"), weights_only=True)
    mu = state["opt_state"]["adamw"]["llm"]["state"][0]["mu"]
    assert mu.dtype == torch.float8_e4m3fn and mu.shape[1] == 128


def _history(out):
    with open(os.path.join(out, "log_history.json")) as f:
        return [(r["step"], r["loss"], r["grad_norm"]) for r in json.load(f)]


def test_train_cli_tp2_matches_one_process(port):
    """`python -m vila_tpu_torch.cli.train --distributed true --tp 2` on
    two ranks logs the losses and grad norms of the same command on one
    process."""
    assert port[("cli", "tp2")] == [0, 0]
    tp2 = _history(os.path.join(port["tmp"], "cli-tp2"))
    one_dir = os.path.join(port["tmp"], "cli-one")
    assert train_cli.main(_cli_argv(port["ckpt"], one_dir)) == 0
    one = _history(one_dir)
    assert [r[0] for r in tp2] == [r[0] for r in one] == [1, 2]
    np.testing.assert_allclose([r[1:] for r in tp2], [r[1:] for r in one], rtol=2e-5)
