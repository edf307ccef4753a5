"""The port's model-level MM-SP, ZeRO-3 step and sharded Trainer
(`vila_tpu_torch.parallel.{mesh,sp,distributed}`, `train.step.
make_sharded_train_step`, `train.trainer`) against the JAX package on the
CPU, in gloo processes at world sizes 2 and 4 (one spawn a world size,
`torch_dist_helpers.spawn`) on tests/test_sp_integration.py's meshes
without tp. JAX computes each reference once on one virtual device, the
reference its own sharded tests hold its meshes to (the forward on the
batch in token order, `make_sharded_train_step` and the `Trainer` on a
one-device mesh); the parameter shards are held against JAX's on the same
mesh shapes.

Tolerances (float32): logits atol 1e-5 / rtol 1e-4 and parameter
gradients rtol 2e-4 plus atol 2e-6 x the leaf's largest |gradient|
(summation order over shards and ring steps; an embedding gradient sums
hundreds of f32 products of magnitude ~50); losses and grad norms rtol 2e-5 over 3 AdamW steps; parameters after
3 steps: 99 % of all elements within atol 2e-6 / rtol 1e-4 and every one
within 3 steps x the largest learning rate (AdamW normalises a gradient
that is rounding residue, the K bias's for one, into an update of up to
lr: summation order moves those elements by a share of lr);
the parameter shards and the checkpoint's tensors bit for bit.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding

import torch_dist_helpers as dh
from vila_tpu.data.collate import Collator as JCollator
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.parallel import mesh as jmesh
from vila_tpu.parallel.sp import SPConfig as JSPConfig
from vila_tpu.parallel.sp import zigzag_batch as jzigzag_batch
from vila_tpu.train.optimizer import OptimizerConfig as JOptimizerConfig
from vila_tpu.train.optimizer import make_optimizer as jmake_optimizer
from vila_tpu.train.step import make_sharded_train_step as jmake_sharded_train_step
from vila_tpu.train.trainer import TrainArgs as JTrainArgs
from vila_tpu.train.trainer import Trainer as JTrainer
from vila_tpu_torch.parallel import mesh as tmesh

S = 64
LOGIT_TOL = dict(atol=1e-5, rtol=1e-4)
PARAM_TOL = dict(atol=2e-6, rtol=1e-4)


def llm_cfg():
    return jqwen2.LLMConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, dtype="float32")


def vlm_cfg():
    """A tiny VLM whose tower width (30) does not divide 4 ranks: those
    leaves fall back to replication at world size 4."""
    llm = dataclasses.replace(llm_cfg(), vocab_size=96)
    vis = jsiglip.SigLIPConfig(hidden_size=30, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=2, image_size=28, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=30,
                                 hidden_size=64)
    return jvlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def cfg_kwargs(cfg):
    return dict(llm=dh.config_fields(cfg.llm), vision=dh.config_fields(cfg.vision),
                projector=dh.config_fields(cfg.projector))


def draw(shapes, seed):
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.05 * x

    return jax.tree_util.tree_map_with_path(one, shapes)


def llm_params(seed=0):
    return draw(jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), llm_cfg())),
                seed)


def vlm_params(seed=0):
    cfg = vlm_cfg()
    return draw(jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg)), seed)


def token_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 120, size=(b, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
    seg = np.ones((b, S), np.int32)
    seg[:, S // 2:] = 2
    return ids, pos, seg


def vlm_batch(seed=0, b=4):
    """Rows with an image each (its 4 tokens at position 2), packed
    segments, labels partly ignored."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, size=(b, S)).astype(np.int32)
    labels = np.where(rng.random((b, S)) < 0.3, -100, ids).astype(np.int32)
    seg = np.ones((b, S), np.int32)
    seg[:, 40:] = 2
    return {"input_ids": ids, "labels": labels,
            "positions": np.tile(np.arange(S, dtype=np.int32), (b, 1)),
            "segment_ids": seg,
            "pixel_values": rng.integers(0, 255, (b, 1, 28, 28, 3)).astype(np.uint8),
            "media_positions": np.tile(np.arange(2, 3, dtype=np.int32), (b, 1))}


# --------------------------------------------------------------------------
# JAX references
# --------------------------------------------------------------------------

MODEL_MESHES = [  # tests/test_sp_integration.py's meshes without tp
    ("ring2-zigzag", 2, dict(sp=2), "zigzag"),
    ("ring2-contig", 2, dict(sp=2), "contiguous"),
    ("ulysses2", 2, dict(su=2), "contiguous"),
    ("ring4-zigzag", 4, dict(sp=4), "zigzag"),
    ("ulysses2-dp2", 4, dict(dp=2, su=2), "contiguous"),
    ("hybrid2x2", 4, dict(sp=2, su=2), "zigzag"),
]


def _model_inputs(axes, layout):
    ids, pos, seg = token_inputs()
    cot = np.random.default_rng(5).standard_normal((2, S, 128)).astype(np.float32)
    batch = {"input_ids": ids, "positions": pos, "segment_ids": seg}
    plan = JSPConfig(mesh=jmesh.make_mesh(**axes), ring_layout=layout)
    return jzigzag_batch(batch, plan), cot, plan  # cot: one per laid-out position


@functools.lru_cache(maxsize=None)
def _jax_forward():
    """JAX's forward and its parameter vjp on one device, jitted once."""
    cfg = llm_cfg()

    @jax.jit
    def run(p, ids, pos, seg, cot):
        def fwd(p_):
            logits, _ = jqwen2.forward(p_, cfg, input_ids=ids, positions=pos,
                                       segment_ids=seg, attn_impl="xla")
            return logits

        out, vjp = jax.vjp(fwd, p)
        return out, vjp(cot)[0]

    return run


def _jax_model(axes, layout):
    """JAX's logits in the mesh's layout, and the parameters' gradients of
    sum(logits * cot) (cot given per laid-out position)."""
    batch, cot, _ = _model_inputs(axes, layout)
    order = batch["positions"][0]  # the laid-out position i holds token order[i]
    ids, pos, seg = token_inputs()
    cot_tokens = np.empty_like(cot)
    cot_tokens[:, order] = cot
    out, grads = _jax_forward()(jax.tree.map(jnp.asarray, llm_params()), ids, pos, seg,
                                jnp.asarray(cot_tokens))
    return np.asarray(out)[:, order], jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _jax_steps(steps=3):
    """JAX's `make_sharded_train_step` on one device, 3 steps on the batch in
    token order: (loss, grad norm, tokens) a step and the parameters."""
    cfg = vlm_cfg()
    mesh = jmesh.make_mesh(devices=jax.devices()[:1])
    opt = jmake_optimizer(JOptimizerConfig(**OPTIM))
    step, params, state, batch_sh = jmake_sharded_train_step(
        cfg, jax.tree.map(jnp.asarray, vlm_params()), opt, mesh)
    batch = {k: jax.device_put(jnp.asarray(v), batch_sh[k]) for k, v in vlm_batch().items()}
    rows = []
    for _ in range(steps):
        params, state, m = step(params, state, batch)
        rows.append((float(m["loss"]), float(m["grad_norm"]), int(m["n_tokens"])))
    return rows, jax.tree.map(np.asarray, params)


OPTIM = dict(learning_rate=1e-3, schedule="constant", warmup_ratio=0.0, total_steps=10,
             weight_decay=0.01, max_grad_norm=1.0, mm_projector_lr=2e-3)

STEP_CASES = [  # (id, world, mesh axes, sp_attention, layout)
    ("dp2", 2, dict(dp=2), False, "zigzag"),
    ("sp2-zigzag", 2, dict(sp=2), True, "zigzag"),
    ("dp2-sp2", 4, dict(dp=2, sp=2), True, "zigzag"),
    ("sp2-su2", 4, dict(sp=2, su=2), True, "contiguous"),
]

SHARD_MESHES = [("dp2", dict(dp=2)), ("dp2-sp2", dict(dp=2, sp=2)),
                ("sp2-su2", dict(sp=2, su=2))]


def _examples(n=8, seed=3):
    """Text-only SFT examples for the Trainer."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        k = int(rng.integers(20, 60))
        ids = rng.integers(1, 90, k).astype(np.int32)
        labels = np.where(rng.random(k) < 0.3, -100, ids).astype(np.int32)
        out.append({"input_ids": ids, "labels": labels,
                    "tiles": np.zeros((0, 28, 28, 3), np.uint8),
                    "media_positions": np.zeros((0,), np.int32)})
    return out


TRAIN_ARGS = dict(max_steps=4, per_device_batch_size=2, seq_len=64, learning_rate=1e-3,
                  warmup_ratio=0.0, lr_schedule="constant", logging_steps=1, save_steps=2,
                  max_ckpts_to_keep=5, ring_layout="zigzag")
TRAINER_CASES = [("dp2", dict(dp=2)), ("sp2", dict(sp=2))]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Every case of the module, one spawn a world size."""
    tmp = tmp_path_factory.mktemp("sp")
    ex = _examples()
    runs = {2: [], 4: []}
    for name, world, axes, layout in MODEL_MESHES:
        batch, cot, _ = _model_inputs(axes, layout)
        runs[world].append((("model", name), ("model_sp", dict(
            mesh_axes=axes, layout=layout, llm=dh.config_fields(llm_cfg()),
            params=llm_params(), ids=batch["input_ids"], pos=batch["positions"],
            seg=batch["segment_ids"], cot=cot))))
    for name, world, axes, spa, layout in STEP_CASES:
        runs[world].append((("step", name), ("sharded_steps", dict(
            mesh_axes=axes, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(), batch=vlm_batch(),
            optim=OPTIM, sp_attention=spa, layout=layout))))
    for name, axes in SHARD_MESHES:
        world = int(np.prod(list(axes.values())))
        runs[world].append((("shards", name), ("shards", dict(
            mesh_axes=axes, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params()))))
    for name, axes in TRAINER_CASES:
        targs = dict(TRAIN_ARGS, **axes, distributed=False)
        runs[2].append((("trainer", name), ("trainer_run", dict(
            mesh_axes=axes, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(), examples=ex,
            targs=targs, out_dir=str(tmp / f"{name}-full")))))
    for name, axes in TRAINER_CASES:  # a fresh Trainer resumes from step 4's sibling, step 2
        targs = dict(TRAIN_ARGS, **axes)
        runs[2].append((("resumed", name), ("trainer_run", dict(
            mesh_axes=axes, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(), examples=ex,
            targs=targs, out_dir=str(tmp / f"{name}-resumed"),
            resume_from=str(tmp / f"{name}-at2")))))
    # the step-2 checkpoints to resume from: a run of max_steps 2
    pre = [(("at2", name), ("trainer_run", dict(
        mesh_axes=axes, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(), examples=ex,
        targs=dict(TRAIN_ARGS, **axes, max_steps=2), out_dir=str(tmp / f"{name}-at2"))))
        for name, axes in TRAINER_CASES]
    runs[2] = pre + runs[2]
    out = {"tmp": tmp}
    for world in (2, 4):
        keys = [k for k, _ in runs[world]]
        ranks = dh.spawn([c for _, c in runs[world]], world, timeout=400)
        for i, key in enumerate(keys):
            out[key] = [r[i] for r in ranks]
    # resuming at world size 1 from the dp=2 run's step-2 checkpoint
    one = [("trainer_run", dict(mesh_axes={}, cfg=cfg_kwargs(vlm_cfg()), params=vlm_params(),
                                examples=ex, targs=dict(TRAIN_ARGS),
                                out_dir=str(tmp / "one-resumed"),
                                resume_from=str(tmp / "dp2-at2")))]
    out[("resumed", "world1")] = dh.spawn(one, 1)[0][0]
    return out


@pytest.mark.parametrize("name,world,axes,layout", MODEL_MESHES,
                         ids=[m[0] for m in MODEL_MESHES])
def test_model_logits_and_grads_under_sp_match_jax(name, world, axes, layout, port):
    want_logits, want_grads = _jax_model(axes, layout)
    got = np.zeros_like(want_logits)
    for r, (logits, grads) in enumerate(port[("model", name)]):
        lay = tmesh.Mesh.layout(**axes, rank=r)
        got[lay.dp_slice(2), lay.seq_slice(S)] = logits
    np.testing.assert_allclose(got, want_logits, **LOGIT_TOL)
    grads = port[("model", name)][0][1]  # summed over the ranks: the same on each
    for path, want in jax.tree_util.tree_leaves_with_path(want_grads):
        leaf = grads
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, err_msg=jax.tree_util.keystr(path), rtol=2e-4,
                                   atol=2e-6 * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("name,axes", SHARD_MESHES, ids=[m[0] for m in SHARD_MESHES])
def test_parameter_shards_match_jax(name, axes, port):
    """Each rank's shard is the slice JAX's NamedSharding puts on that
    device, replicated leaves included (the tower's 30-wide kernels do not
    divide 4 ranks), both from the spawned ranks and from layout meshes."""
    cfg = vlm_cfg()
    params = vlm_params()
    mesh = jmesh.make_mesh(**axes)
    specs = jmesh.vlm_param_specs(cfg, params, mesh)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, params), specs, mesh)
    devices = list(mesh.devices.flat)
    world = len(devices)
    ranks = port[("shards", name)]
    n_split = 0
    for path, arr in jax.tree_util.tree_leaves_with_path(sharded):
        by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
        for r in range(world):
            leaf = ranks[r]
            for k in path:
                leaf = leaf[k.key]
            np.testing.assert_array_equal(leaf, by_dev[devices[r]],
                                          err_msg=jax.tree_util.keystr(path))
        n_split += by_dev[devices[0]].shape != arr.shape
    assert n_split > 0
    if world == 4:  # the fallback to replication is exercised
        assert sharded["vision_tower"]["layers"]["q_proj"]["kernel"].sharding.is_fully_replicated


@pytest.mark.parametrize("name,world,axes,spa,layout", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_sharded_train_step_matches_jax(name, world, axes, spa, layout, port):
    want_rows, want_params = _jax_steps()
    rows, params = port[("step", name)][0]
    for r in port[("step", name)][1:]:
        assert r[0] == rows  # global metrics: the same on every rank
    for (l, g, n), (wl, wg, wn) in zip(rows, want_rows):
        assert n == wn
        np.testing.assert_allclose([l, g], [wl, wg], rtol=2e-5)
    close = total = 0
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        leaf = params
        for k in path:
            leaf = leaf[k.key]
        np.testing.assert_allclose(leaf, want, err_msg=jax.tree_util.keystr(path), rtol=0,
                                   atol=3 * 2e-3)
        close += int(np.isclose(leaf, want, **PARAM_TOL).sum())
        total += want.size
    assert close >= 0.99 * total, (close, total)


@pytest.mark.parametrize("name,axes", TRAINER_CASES, ids=[c[0] for c in TRAINER_CASES])
def test_trainer_on_mesh_matches_jax_and_resumes(name, axes, port, tmp_path):
    """The port's Trainer at dp 2 / sp 2 logs JAX's Trainer's losses (one
    device, the same global batches); a fresh Trainer resumed from its
    step-2 checkpoint gives steps 3 and 4 again; the checkpoint holds whole
    tensors."""
    want = _jax_trainer(str(tmp_path))
    full = port[("trainer", name)][0]
    assert [r[0] for r in full] == [w[0] for w in want] == [1, 2, 3, 4]
    np.testing.assert_allclose([r[1:] for r in full], [w[1:] for w in want], rtol=2e-5)
    resumed = port[("resumed", name)][0]
    assert [r[0] for r in resumed] == [3, 4]
    np.testing.assert_allclose([r[1:] for r in resumed], [r[1:] for r in full[2:]], rtol=1e-6)
    import torch

    state = torch.load(os.path.join(port["tmp"], f"{name}-at2", "checkpoints", "checkpoint-2",
                                    "state.pt"), weights_only=True)
    assert state["params"]["llm"]["embed_tokens"]["embedding"].shape == (96, 64)


_JAX_TRAINER = []


def _jax_trainer(out_dir):
    """JAX's Trainer on one device over `_examples()`: its logged (step,
    loss, grad norm), run once."""
    if not _JAX_TRAINER:
        jargs = JTrainArgs(output_dir=out_dir, **TRAIN_ARGS)
        coll = JCollator(seq_len=64, pad_token_id=0, tile_size=28)
        jt = JTrainer(vlm_cfg(), jax.tree.map(jnp.asarray, vlm_params()), _examples(), coll,
                      jargs)
        _JAX_TRAINER.extend((r["step"], r["loss"], r["grad_norm"])
                            for r in jt.train()["log_history"])
    return list(_JAX_TRAINER)


def test_trainer_resumes_at_world_size_one(port):
    """The dp=2 run's step-2 checkpoint resumed by one process gives the
    same steps 3 and 4 (every rank draws the same global batch)."""
    full = port[("trainer", "dp2")][0]
    one = port[("resumed", "world1")]
    assert [r[0] for r in one] == [3, 4]
    np.testing.assert_allclose([r[1:] for r in one], [r[1:] for r in full[2:]], rtol=2e-5)


def test_tp_raises_naming_the_roadmap_item():
    from vila_tpu_torch.parallel import mesh as m
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        m.make_mesh(tp=2)
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        Trainer(None, {}, [], None, TrainArgs(tp=2), device="cpu")


@pytest.mark.parametrize("name,axes", SHARD_MESHES, ids=[m[0] for m in SHARD_MESHES])
def test_host_local_batch_is_jax_batch_shard(name, axes):
    """Each rank's part of a laid-out global batch is the shard JAX's
    `batch_specs` put on that device (`host_local_batch`, one host), bit
    for bit; media positions become local to the rank's slice, the
    positions outside it the sentinel S_local."""
    from vila_tpu.parallel.distributed import host_local_batch as jhost_local_batch
    from vila_tpu_torch.parallel.distributed import host_local_batch

    mesh = jmesh.make_mesh(**axes)
    batch = vlm_batch(b=4)
    batch["media_positions"] = np.array([[2, 40, 63, 64]] * 4, np.int32)
    sh = {k: NamedSharding(mesh, v) for k, v in jmesh.batch_specs(mesh).items()}
    want = jhost_local_batch(batch, sh)
    devices = list(mesh.devices.flat)
    for r, dev in enumerate(devices):
        lay = tmesh.Mesh.layout(**axes, rank=r)
        got = host_local_batch(batch, lay)
        for k, arr in want.items():
            shard = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
            if k == "media_positions":
                cols = lay.seq_slice(S)
                loc = shard - cols.start
                inside = (shard < S) & (loc >= 0) & (loc < cols.stop - cols.start)
                shard = np.where(inside, loc, cols.stop - cols.start)
            np.testing.assert_array_equal(got[k], shard, err_msg=f"{k} on rank {r}")
