"""The port's tensor parallelism (`vila_tpu_torch.parallel.tensor_parallel`,
`mesh`'s (dp, sp, su, tp) layout, `qwen2.forward(tp=)`, the vocab-parallel
losses, the long-context engine's `param_specs` and cache axes, NIAH on
meshes with dp and tp) against the JAX package on the CPU: the port in gloo
processes at world sizes 2, 4 and 8 (one spawn a world size,
`torch_dist_helpers.spawn`), JAX on as many of the conftest's virtual
devices, each reference computed once.

Bars (float32): parameter shards bit for bit (a layout check, no
processes); logits under tp atol 3e-5 / rtol 1e-4 against JAX's forward on
the same mesh, and the parameters' gradients rtol 2e-4 plus atol 2e-6 x
the leaf's largest |gradient| against JAX's on one device (the bar of
`test_torch_sp.py`); the vocab-parallel embedding bit for bit, the cross
entropies and log-probabilities rtol 2e-5 and their gradients rtol 1e-4
plus atol 1e-6 x the largest |gradient| (a sum over the ranks' columns);
the engine's greedy tokens and NIAH's grid exactly, NIAH's logits atol
2e-5 / rtol 1e-4 (`test_torch_niah.py`'s bar).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as dh
from vila_tpu.eval import niah as jniah
from vila_tpu.inference.long_context import LongContextEngine as JEngine
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.parallel import mesh as jmesh
from vila_tpu.parallel.sp import SPConfig as JSPConfig
from vila_tpu.parallel.sp import zigzag_batch as jzigzag_batch
from vila_tpu.train import losses as jlosses
from vila_tpu_torch.parallel import mesh as tmesh

S = 64
LOGIT_TOL = dict(atol=3e-5, rtol=1e-4)


def llm_cfg(**kw):
    """Hq 4 / Hkv 2 of 16: at tp 4 the KV heads do not divide, so k_proj
    splits mid-head and attention takes every head (the fallback)."""
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, dtype="float32")
    return jqwen2.LLMConfig(**dict(base, **kw))


def vlm_cfg():
    """The LLM above (vocab 96) and a tower 30 wide: split at tp 2, whole at
    tp 4 (30 does not divide)."""
    vis = jsiglip.SigLIPConfig(hidden_size=30, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=2, image_size=28, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=30,
                                 hidden_size=64)
    return jvlm.VLMConfig(llm=llm_cfg(vocab_size=96), vision=vis, projector=proj)


def draw(shapes, seed, scale=0.05):
    rng = np.random.default_rng(seed)

    def one(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else scale * x

    return jax.tree_util.tree_map_with_path(one, shapes)


def llm_params(seed=0, scale=0.05, **kw):
    cfg = llm_cfg(**kw)
    return draw(jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), cfg)), seed,
                scale)


def token_inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 120, size=(b, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
    seg = np.ones((b, S), np.int32)
    seg[:, S // 2:] = 2
    return ids, pos, seg


# --------------------------------------------------------------------------
# meshes and the port's runs
# --------------------------------------------------------------------------

LOGIT_MESHES = [  # (id, world, axes, layout)
    ("tp2", 2, dict(tp=2), "zigzag"),
    ("sp2-tp2-zigzag", 4, dict(sp=2, tp=2), "zigzag"),
    ("su2-tp2", 4, dict(su=2, tp=2), "contiguous"),
    ("tp4-head-fallback", 4, dict(tp=4), "contiguous"),
    ("hybrid-2x2-tp2", 8, dict(sp=2, su=2, tp=2), "zigzag"),
]
SHARD_MESHES = [("tp2", dict(tp=2)), ("dp2-tp2", dict(dp=2, tp=2)),
                ("sp2-tp2", dict(sp=2, tp=2)), ("tp4", dict(tp=4))]
NIAH_MESHES = [("dp2-sp2", dict(dp=2, sp=2)), ("sp2-tp2", dict(sp=2, tp=2))]
LC_CASES = [  # (id, axes, engine kwargs of the port and of JAX)
    ("param-specs-sp2-tp2", dict(sp=2, tp=2), dict(param_specs=True)),
    ("seq-axes-sp-su-on-dp2-sp2", dict(dp=2, sp=2), dict(seq_axes=("sp", "su"))),
]
LC_RUN = (300, 3, dict(max_cache_len=512, prefill_chunk=128), dict(max_new_tokens=8))
Z_LOSS, CHUNK = 1e-3, 24


def _model_inputs(axes, layout):
    ids, pos, seg = token_inputs()
    cot = np.random.default_rng(5).standard_normal((2, S, 128)).astype(np.float32)
    batch = {"input_ids": ids, "positions": pos, "segment_ids": seg}
    plan = JSPConfig(mesh=jmesh.make_mesh(**axes), ring_layout=layout)
    if plan.active:
        batch = jzigzag_batch(batch, plan)
    return batch, cot


def _vocab_inputs():
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 128, size=(2, 12)).astype(np.int32)
    cot = rng.standard_normal((2, 12, 64)).astype(np.float32)
    logits = (3.0 * rng.standard_normal((2, 12, 128))).astype(np.float32)
    labels = np.where(rng.random((2, 12)) < 0.25, -100, ids).astype(np.int32)
    hidden = rng.standard_normal((2, 12, 64)).astype(np.float32)
    return dict(ids=ids, cot=cot, logits=logits, labels=labels, hidden=hidden)


def _lc_embeds():
    s, seed = LC_RUN[0], LC_RUN[1]
    return np.random.default_rng(seed).normal(scale=0.5, size=(1, s, 64)).astype(np.float32)


def _niah_inputs():
    rng = np.random.default_rng(1)
    embeds = rng.normal(size=(1, 64, 64)).astype(np.float32)
    haystack = rng.normal(size=(256, 64)).astype(np.float32)
    needle = rng.normal(size=(8, 64)).astype(np.float32)
    answers = rng.integers(0, 128, 4).astype(np.int64)
    return embeds, haystack, needle, answers


NIAH_GRID = dict(contexts=(64, 128), depths=(0.0, 1.0))


@pytest.fixture(scope="module")
def port():
    runs = {2: [], 4: [], 8: []}
    llm = dh.config_fields(llm_cfg())
    for name, world, axes, layout in LOGIT_MESHES:
        batch, cot = _model_inputs(axes, layout)
        runs[world].append((("model", name), ("tp_model", dict(
            mesh_axes=axes, llm=llm, params=llm_params(), ids=batch["input_ids"],
            pos=batch["positions"], seg=batch["segment_ids"], cot=cot, layout=layout))))
    runs[2].append((("vocab", "tp2"), ("vocab_pieces", dict(
        mesh_axes=dict(tp=2), llm=llm, params=llm_params(1), z_loss=Z_LOSS, chunk=CHUNK,
        **_vocab_inputs()))))
    runs[2].append((("mesh_error", "tp4-on-2"), ("mesh_error", dict(mesh_axes=dict(tp=4)))))
    for name, axes, kw in LC_CASES:
        runs[4].append((("lc", name), ("long_context", dict(
            mesh_axes=axes, llm=llm, params=llm_params(2, scale=0.15),
            runs=[(_lc_embeds(), LC_RUN[2], LC_RUN[3])], **kw))))
    embeds, haystack, needle, answers = _niah_inputs()
    for name, axes in NIAH_MESHES:
        runs[4].append((("niah", name), ("niah_case", dict(
            mesh_axes=axes, llm=llm, params=llm_params(3, scale=0.2), embeds=embeds,
            haystack=haystack, needle=needle, answers=answers, **NIAH_GRID))))
    out = {}
    for world, cases in runs.items():
        ranks = dh.spawn([c for _, c in cases], world, timeout=400)
        for i, (key, _) in enumerate(cases):
            out[key] = [r[i] for r in ranks]
    return out


# --------------------------------------------------------------------------
# shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,axes", SHARD_MESHES, ids=[m[0] for m in SHARD_MESHES])
def test_parameter_shards_match_jax(name, axes):
    """Every rank's shard of every leaf is the slice JAX's NamedSharding
    puts on that device, bit for bit (leaves split over FSDP and tp at
    once, over one of them, and whole by the divisibility fallback)."""
    cfg = vlm_cfg()
    params = draw(jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg)), 0)
    mesh = jmesh.make_mesh(**axes)
    specs = jmesh.vlm_param_specs(cfg, params, mesh)
    sharded = jmesh.shard_params(jax.tree.map(jnp.asarray, params), specs, mesh)
    devices = list(mesh.devices.flat)
    tparams = jax.tree.map(torch.as_tensor, params)
    kinds = set()
    for r, dev in enumerate(devices):
        lay = tmesh.Mesh.layout(**axes, rank=r)
        dims = tmesh.shard_dims(tparams, jmesh.vlm_param_specs(cfg, params, mesh), lay)
        got = tmesh.shard_params(tparams, dims, lay)
        for path, arr in jax.tree_util.tree_leaves_with_path(sharded):
            want = next(np.asarray(s.data) for s in arr.addressable_shards if s.device == dev)
            leaf, split = got, dims
            for k in path:
                leaf, split = leaf[k.key], split[k.key]
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=jax.tree_util.keystr(path))
            kinds.add(None if split is None else (split.fsdp is not None, split.tp is not None))
    assert (False, True) in kinds or (True, True) in kinds  # something is split over tp
    if axes == dict(tp=4):  # the tower's 30-wide kernels do not divide 4
        assert sharded["vision_tower"]["layers"]["q_proj"]["kernel"].sharding.is_fully_replicated


# --------------------------------------------------------------------------
# the forward under tp
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_vjp():
    cfg = llm_cfg()

    @jax.jit
    def run(p, ids, pos, seg, cot):
        def fwd(p_):
            return jqwen2.forward(p_, cfg, input_ids=ids, positions=pos, segment_ids=seg,
                                  attn_impl="xla")[0]

        out, vjp = jax.vjp(fwd, p)
        return out, vjp(cot)[0]

    return run


def _jax_mesh_logits(axes, layout):
    """JAX's forward on the mesh (weights sharded by the specs, MM-SP with
    heads over tp), in the laid-out order."""
    cfg = llm_cfg()
    batch, _ = _model_inputs(axes, layout)
    mesh = jmesh.make_mesh(**axes)
    sp = JSPConfig(mesh=mesh, ring_layout=layout)
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, llm_params()),
                                jmesh.llm_param_specs(cfg, mesh), mesh)

    def fwd(p, ids, pos, seg):
        return jqwen2.forward(p, cfg, input_ids=ids, positions=pos, segment_ids=seg,
                              attn_impl="xla", sp=sp if sp.active else None)[0]

    out = jax.jit(fwd)(params, *(jnp.asarray(batch[k]) for k in
                                 ("input_ids", "positions", "segment_ids")))
    return np.asarray(out)


@pytest.mark.parametrize("name,world,axes,layout", LOGIT_MESHES,
                         ids=[m[0] for m in LOGIT_MESHES])
def test_logits_and_grads_under_tp_match_jax(name, world, axes, layout, port):
    want = _jax_mesh_logits(axes, layout)
    got = np.zeros_like(want)
    for r, (logits, _) in enumerate(port[("model", name)]):
        lay = tmesh.Mesh.layout(**axes, rank=r)
        got[lay.dp_slice(2), lay.seq_slice(S)] = logits
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    # gradients of sum(logits * cot), cot per laid-out position
    batch, cot = _model_inputs(axes, layout)
    order = batch["positions"][0]
    cot_tokens = np.empty_like(cot)
    cot_tokens[:, order] = cot
    ids, pos, seg = token_inputs()
    _, want_grads = _jax_vjp()(jax.tree.map(jnp.asarray, llm_params()), ids, pos, seg,
                               jnp.asarray(cot_tokens))
    grads = port[("model", name)][0][1]
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        leaf = grads
        for k in path:
            leaf = leaf[k.key]
        w = np.asarray(w)
        np.testing.assert_allclose(leaf, w, err_msg=jax.tree_util.keystr(path), rtol=2e-4,
                                   atol=2e-6 * max(1.0, float(np.abs(w).max())))


# --------------------------------------------------------------------------
# vocab-parallel pieces
# --------------------------------------------------------------------------


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-6 * float(np.abs(want).max()))


def test_vocab_parallel_pieces_match_jax(port):
    """The embedding (a masked lookup of each rank's rows, summed), the
    cross entropy with z_loss, the chunked cross entropy and the chunked
    per-sequence log-probs over tp = 2, every value and gradient against
    JAX's (the same on both ranks)."""
    cfg = llm_cfg()
    x = _vocab_inputs()
    p = jax.tree.map(jnp.asarray, llm_params(1))
    ranks = port[("vocab", "tp2")]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["ce"][2], ranks[0]["ce"][2])
    got = ranks[0]

    emb, vjp = jax.vjp(lambda q: jqwen2.embed_tokens(q, cfg, jnp.asarray(x["ids"])), p)
    np.testing.assert_array_equal(got["embed"][0], np.asarray(emb))
    _close(got["embed"][1], vjp(jnp.asarray(x["cot"]))[0]["embed_tokens"]["embedding"])

    (loss, n), g = jax.value_and_grad(
        lambda lg: jlosses.causal_lm_loss(lg, jnp.asarray(x["labels"]), z_loss=Z_LOSS),
        has_aux=True)(jnp.asarray(x["logits"]))
    np.testing.assert_allclose(got["ce"][0], float(loss), rtol=2e-5)
    assert got["ce"][1] == int(n)
    _close(got["ce"][2], g)

    h = jnp.asarray(x["hidden"])
    labels = jnp.asarray(x["labels"])
    for key, fn in (("chunked", lambda hh, q: jlosses.chunked_causal_lm_loss(
            hh, q, cfg, labels, chunk_size=CHUNK, z_loss=Z_LOSS)[0]),
                    ("logp", lambda hh, q: jlosses.chunked_sequence_logp(
            hh, q, cfg, labels, chunk_size=CHUNK))):
        val, (gh, gp) = jax.value_and_grad(lambda hh, q: fn(hh, q).sum(), argnums=(0, 1))(h, p)
        np.testing.assert_allclose(got[key][0], np.asarray(fn(h, p)), rtol=2e-5)
        _close(got[key][1], gh)
        _close(got[key][2], gp["embed_tokens"]["embedding"])


def test_mesh_larger_than_the_world_raises(port):
    kind, text = port[("mesh_error", "tp4-on-2")][0]
    assert kind == "ValueError" and "needs 4 ranks" in text


# --------------------------------------------------------------------------
# the long-context engine and NIAH on meshes with dp and tp
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,axes,kw", LC_CASES, ids=[c[0] for c in LC_CASES])
def test_long_context_engine_matches_jax(name, axes, kw, port):
    """Weights sharded at rest (FSDP and tp, gathered a layer at a time)
    and a cache split over a subset of the dims: the greedy tokens are
    JAX's engine's on the same mesh, on every rank."""
    cfg = llm_cfg()
    mesh = jmesh.make_mesh(**axes)
    jkw = dict(kw)
    if jkw.pop("param_specs", False):
        jkw["param_specs"] = jmesh.llm_param_specs(cfg, mesh)
    eng = JEngine(jax.tree.map(jnp.asarray, llm_params(2, scale=0.15)), cfg, mesh,
                  **LC_RUN[2], **jkw)
    want = list(eng.generate(jnp.asarray(_lc_embeds()), **LC_RUN[3]))
    assert len(set(want)) > 1  # not a degenerate run
    for r in port[("lc", name)]:
        assert r[0] == want


@functools.lru_cache(maxsize=None)
def _jax_niah(axes):
    axes = dict(axes)
    embeds, haystack, needle, answers = _niah_inputs()
    p = jax.tree.map(jnp.asarray, llm_params(3, scale=0.2))
    mesh = jmesh.make_mesh(**axes)
    logits = jniah.forward_embeds_sharded(p, llm_cfg(), jnp.asarray(embeds), mesh)
    grid = jniah.run_niah(p, llm_cfg(), jnp.asarray(haystack), jnp.asarray(needle), answers,
                          jniah.NIAHConfig(context_lengths=NIAH_GRID["contexts"],
                                           depths=NIAH_GRID["depths"]), mesh=mesh)
    return np.asarray(logits), grid


@pytest.mark.parametrize("name,axes", NIAH_MESHES, ids=[m[0] for m in NIAH_MESHES])
def test_niah_on_meshes_with_dp_and_tp_matches_jax(name, axes, port):
    """`forward_embeds_sharded`'s logits in token order on every rank (dp
    ranks repeat their shard, tp splits the heads) and the `run_niah` grid
    against JAX's on the same mesh."""
    want, want_grid = _jax_niah(tuple(sorted(axes.items())))
    for logits, grid in port[("niah", name)]:
        np.testing.assert_allclose(logits, want, atol=2e-5, rtol=1e-4)
        assert grid == want_grid


def test_config_fields_of_the_tp_plan():
    """`SPConfig` names JAX's batch and head dims; `TPConfig` splits the
    dims tp divides and the heads when both counts do."""
    from vila_tpu_torch.parallel import tensor_parallel as tpl
    from vila_tpu_torch.parallel.sp import SPConfig

    lay = tmesh.Mesh.layout(tp=4, rank=5 % 4)
    sp = SPConfig(mesh=lay)
    assert (sp.dp_axis, sp.head_axis) == ("dp", "tp")
    tp = tpl.TPConfig(lay)
    assert tp.active and tp.rank == 1 and tp.splits(64) and not tp.splits(30)
    assert tp.heads_split(4, 4) and not tp.heads_split(4, 2)
    assert dataclasses.replace(sp, head_axis=None).head_axis is None
