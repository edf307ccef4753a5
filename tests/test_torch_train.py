"""Parity of the port's training path (`vila_tpu_torch.train`) with the JAX
package in float32 on the CPU: the losses, the learning-rate schedules, the
component-wise AdamW (per-component learning rates, clipping, freezing)
against optax, and one `train_step` of a tiny VLM with images and packed
rows against JAX's, with remat off, full and "dots", and through the flash
route's plain versions. Inputs are drawn with numpy from a seed."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vila_tpu.data.collate import PackingCollator as JPackingCollator
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.train import losses as jlosses
from vila_tpu.train import optimizer as jopt
from vila_tpu.train.step import train_step as jtrain_step
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.train import losses as tlosses
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step
from vila_tpu_torch.utils import weights

TOL = dict(rtol=1e-4, atol=1e-5)  # f32 summation order


def _same(cls, jcfg, **over):
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)}
    kw.update(over)
    return cls(**kw)


def _labels(rng, b, s, v):
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[rng.random((b, s)) < 0.3] = -100
    return labels


def test_causal_lm_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32)
    labels = _labels(rng, 2, 9, 17)
    for shift in (True, False):
        want, wn = jlosses.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels), shift=shift)
        got, n = tlosses.causal_lm_loss(torch.tensor(logits), torch.tensor(labels), shift=shift)
        assert int(n) == int(wn)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    zw, _ = jlosses.causal_lm_loss(jnp.asarray(logits), jnp.asarray(labels), z_loss=1e-2)
    zg, _ = tlosses.causal_lm_loss(torch.tensor(logits), torch.tensor(labels), z_loss=1e-2)
    np.testing.assert_allclose(float(zg), float(zw), rtol=1e-6)


def test_chunked_loss_and_its_gradient_match_jax():
    """Chunks of 5 over 2 x 11 - 2 shifted tokens (padding in the last)."""
    cfg = jqwen2.LLMConfig(vocab_size=40, hidden_size=16, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2,
                           num_key_value_heads=1)
    rng = np.random.default_rng(1)
    emb = (0.3 * rng.standard_normal((40, 16))).astype(np.float32)
    hidden = rng.standard_normal((2, 11, 16)).astype(np.float32)
    labels = _labels(rng, 2, 11, 40)

    def jl(h, e):
        return jlosses.chunked_causal_lm_loss(
            h, {"embed_tokens": {"embedding": e}}, cfg, jnp.asarray(labels), chunk_size=5)

    want, wn = jl(hidden, emb)
    wg = jax.grad(lambda h, e: jl(h, e)[0], argnums=(0, 1))(hidden, emb)
    th, te = torch.tensor(hidden, requires_grad=True), torch.tensor(emb, requires_grad=True)
    got, n = tlosses.chunked_causal_lm_loss(
        th, {"embed_tokens": {"embedding": te}}, _same(tqwen2.LLMConfig, cfg),
        torch.tensor(labels), chunk_size=5)
    got.backward()
    assert int(n) == int(wn)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(wg[0]), **TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(wg[1]), **TOL)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedules_match_optax(schedule):
    cfg = jopt.OptimizerConfig(warmup_ratio=0.3, total_steps=8, schedule=schedule)
    want = jopt.make_schedule(cfg, 1e-3)
    got = topt.make_schedule(_same(topt.OptimizerConfig, cfg), 1e-3)
    for count in range(10):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else (0.5 * rng.standard_normal(v)).astype(np.float32))
            for k, v in shapes.items()}


def test_adamw_three_steps_match_optax():
    """Per-component learning rates, clipping (the llm's gradients exceed
    max_grad_norm, the projector's do not), a frozen vision tower, weight
    decay, warmup cosine schedule (first update at lr 0)."""
    cfg = jopt.OptimizerConfig(learning_rate=1e-2, mm_projector_lr=3e-2,
                               weight_decay=0.1, warmup_ratio=0.2, total_steps=5,
                               max_grad_norm=1.0, tune_vision_tower=False)
    rng = np.random.default_rng(2)
    shapes = {"llm": {"a": (4, 3), "b": {"c": (5,)}}, "vision_tower": {"w": (3, 3)},
              "mm_projector": {"p": (2, 2)}}
    params = _tree(rng, shapes)
    grads = [_tree(rng, shapes) for _ in range(3)]
    for g in grads:
        g["mm_projector"]["p"] *= 0.05  # under the clip norm
    opt = jopt.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)

    tp = weights.to_torch_tree(params, torch.device("cpu"))
    topt_ = topt.make_optimizer(_same(topt.OptimizerConfig, cfg))
    tstate = topt_.init(tp)
    for g in grads:
        for t, gv in zip(topt.leaves(tp), topt.leaves(weights.to_torch_tree(
                g, torch.device("cpu")))):
            t.grad = gv
        tstate = topt_.update(tstate, tp)
    assert tstate.count == 3
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 topt.leaves(tp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    np.testing.assert_array_equal(tp["vision_tower"]["w"].numpy(),
                                  params["vision_tower"]["w"])


# --------------------------------------------------------------------------
# one train_step of a tiny VLM against JAX's
# --------------------------------------------------------------------------


def _tiny_cfg(remat=False):
    llm = jqwen2.LLMConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dtype="float32", remat=remat)
    vis = jsiglip.SigLIPConfig(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=2, image_size=56, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=32,
                                 hidden_size=64)
    return jvlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def _draw(cfg, seed):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _packed_batch(cfg, seed):
    """Six examples (four with an image) packed into two rows of 40."""
    rng = np.random.default_rng(seed)
    tpi = cfg.tokens_per_image
    examples = []
    for i in range(6):
        n = int(rng.integers(8, 18))
        ids = rng.integers(3, 90, n).astype(np.int32)
        labels = np.where(rng.random(n) < 0.3, -100, ids).astype(np.int32)
        ex = {"input_ids": ids, "labels": labels,
              "tiles": np.zeros((0, 56, 56, 3), np.uint8),
              "media_positions": np.zeros((0,), np.int32)}
        if i % 3:
            ids[1:1 + tpi] = 95
            labels[1:1 + tpi] = -100
            ex["tiles"] = rng.integers(0, 256, (1, 56, 56, 3), dtype=np.uint8)
            ex["media_positions"] = np.arange(1, 1 + tpi, dtype=np.int32)
        examples.append(ex)
    return JPackingCollator(seq_len=40, rows=2, tile_size=56)(examples)


@pytest.mark.parametrize("remat,attn_impl", [(False, "auto"), (True, "auto"),
                                             ("dots", "auto"), (False, "flash")])
def test_train_step_matches_jax(remat, attn_impl):
    cfg = _tiny_cfg(remat)
    params = _draw(cfg, 3)
    batch = _packed_batch(cfg, 4)
    assert (batch["segment_ids"] > 1).any() and (batch["media_positions"] < 40).any()
    ocfg = jopt.OptimizerConfig(learning_rate=1e-3, vision_tower_lr=2e-4,
                                mm_projector_lr=5e-4, schedule="constant",
                                warmup_ratio=0.0, max_grad_norm=0.5, eps=1e-6,
                                weight_decay=0.01)
    jopt_ = jopt.make_optimizer(ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(functools.partial(jtrain_step, cfg=cfg, optimizer=jopt_))
    jp2, _, jm = step(jp, jopt_.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})

    tcfg = tvlm.VLMConfig(llm=_same(tqwen2.LLMConfig, cfg.llm),
                          vision=_same(tsiglip.SigLIPConfig, cfg.vision),
                          projector=_same(tproj.ProjectorConfig, cfg.projector))
    tp = weights.from_jax_params(params, device="cpu")
    topt_ = topt.make_optimizer(_same(topt.OptimizerConfig, ocfg))
    _, tp, tstate = make_train_step(tcfg, tp, topt_)
    tb = batch_to_device(batch, torch.device("cpu"))
    tp, tstate, tm = train_step(tp, tstate, tb, cfg=tcfg, optimizer=topt_,
                                attn_impl=attn_impl)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    assert int(tm["n_tokens"]) == int(jm["n_tokens"])
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp2)[0],
                                 topt.leaves(tp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=jax.tree_util.keystr(path))
    for name in ("llm", "vision_tower", "mm_projector"):
        before = topt.leaves(weights.from_jax_params(params[name], device="cpu"))
        assert any(not torch.equal(a, b) for a, b in zip(before, topt.leaves(tp[name])))


def test_llm_config_training_options():
    """fp8 matmuls and the fp8 AdamW build (tests/test_torch_fp8.py holds
    them against JAX); an unknown remat or fp8 mode is refused."""
    from vila_tpu_torch.train.fp8_adamw import FP8AdamW

    assert tqwen2.LLMConfig(fp8_matmul="group").fp8_matmul == "group"
    with pytest.raises(ValueError, match="fp8_matmul"):
        tqwen2.LLMConfig(fp8_matmul="row")
    with pytest.raises(ValueError, match="remat"):
        tqwen2.LLMConfig(remat="everything")
    tree = {c: {"w": torch.zeros(3)} for c in topt.COMPONENTS}
    state = topt.make_optimizer(topt.OptimizerConfig(optimizer="fp8_adamw")).init(tree)
    assert all(isinstance(o, FP8AdamW) for o in state.adamw.values())
