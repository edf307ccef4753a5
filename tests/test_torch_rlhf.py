"""The port's RLHF (`vila_tpu_torch.train.rlhf`) and its tree optimizer
(`optimizer.adamw` / `adam`) against `vila_tpu/train/rlhf.py` and optax on
the CPU in f32 over the tiny VLM of `test_torch_train.py`: GAE, whitening,
the reward and PPO losses and their metrics within 1e-6; `sequence_reward`
by segment ids; `make_experience` (an empty response row drops its score)
within 1e-5; one reward, PPO and SFT step with loss and metrics within
1e-5, the gradients and updated trees as `test_torch_dpo.assert_step_close`
states; the tree optimizer over a tuple tree within 1e-6 of optax."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vila_tpu.data.collate import Collator as JCollator
from vila_tpu.train import rlhf as jrlhf
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train import rlhf as trlhf
from vila_tpu_torch.train.step import batch_to_device
from vila_tpu_torch.utils import weights

from test_torch_dpo import Recording, assert_step_close, recording
from test_torch_fp8 import _tcfg
from test_torch_train import _draw, _tiny_cfg

CPU = torch.device("cpu")


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _rows(cfg, seed, n, length, first=None):
    """n rows through JAX's Collator (a shorter one padded); the last row
    carries an image."""
    rng = np.random.default_rng(seed)
    tpi = cfg.tokens_per_image
    ex = []
    for i in range(n):
        k = length - 3 if i == 0 else length
        ids = rng.integers(3, 90, k).astype(np.int32)
        if first is not None:
            ids[0] = first
        e = {"input_ids": ids, "labels": ids.copy(),
             "tiles": np.zeros((0, 56, 56, 3), np.uint8),
             "media_positions": np.zeros((0,), np.int32)}
        if i == n - 1:
            ids[2:2 + tpi] = 95
            e["tiles"] = rng.integers(0, 256, (1, 56, 56, 3), dtype=np.uint8)
            e["media_positions"] = np.arange(2, 2 + tpi, dtype=np.int32)
        ex.append(e)
    return JCollator(seq_len=length, tile_size=56)(ex)


def test_gae_and_whiten_match_jax():
    rng = np.random.default_rng(0)
    r, v = (rng.standard_normal((3, 9)).astype(np.float32) for _ in range(2))
    mask = np.ones((3, 9), np.float32)
    mask[1, 6:] = 0.0
    mask[2] = 0.0
    for gamma, lam in ((1.0, 0.95), (0.98, 0.9)):
        wa, wr = jrlhf.compute_gae(*map(jnp.asarray, (r, v, mask)), gamma, lam)
        ga, gr = trlhf.compute_gae(*map(torch.tensor, (r, v, mask)), gamma, lam)
        _close(ga.numpy(), wa)
        _close(gr.numpy(), wr)
    _close(trlhf._whiten(torch.tensor(r), torch.tensor(mask)).numpy(),
           jrlhf._whiten(jnp.asarray(r), jnp.asarray(mask)))


def test_ppo_and_reward_losses_match_jax():
    rng = np.random.default_rng(1)
    logp, old, adv, vals, ret, vpred = (rng.standard_normal((2, 7)).astype(np.float32)
                                        for _ in range(6))
    old = logp + 0.3 * old  # ratios away from 1: clipping active
    mask = (rng.random((2, 7)) < 0.7).astype(np.float32)
    exp = {"old_logp": old, "advantages": adv, "values": vals, "returns": ret}
    for pc in (jrlhf.PPOConfig(), jrlhf.PPOConfig(cliprange=0.05, cliprange_value=0.5)):
        wl, wm = jrlhf.ppo_loss(jnp.asarray(logp), jnp.asarray(vpred),
                                jax.tree.map(jnp.asarray, exp), jnp.asarray(mask), pc)
        gl, gm = trlhf.ppo_loss(torch.tensor(logp), torch.tensor(vpred),
                                weights.to_torch_tree(exp, CPU), torch.tensor(mask),
                                trlhf.PPOConfig(**vars(pc)))
        _close(float(gl), float(wl))
        assert sorted(gm) == sorted(wm)
        for k in wm:
            _close(float(gm[k]), float(wm[k]))
    # at the first PPO step new logp == old: ratio 1, no clipping,
    # pg_loss = -mean(advantage) over the mask
    exp0 = dict(exp, old_logp=logp)
    _, m0 = trlhf.ppo_loss(torch.tensor(logp), torch.tensor(vals),
                           weights.to_torch_tree(exp0, CPU), torch.tensor(mask),
                           trlhf.PPOConfig())
    assert float(m0["clipfrac"]) == 0.0 and float(m0["ratio_mean"]) == 1.0
    _close(float(m0["pg_loss"]), -(adv * mask).sum() / mask.sum())
    rc, rr = (rng.standard_normal(4).astype(np.float32) for _ in range(2))
    for rcfg in (jrlhf.RewardConfig(), jrlhf.RewardConfig(center_coef=0.1)):
        wl, wm = jrlhf.reward_loss(jnp.asarray(rc), jnp.asarray(rr), rcfg)
        gl, gm = trlhf.reward_loss(torch.tensor(rc), torch.tensor(rr),
                                   trlhf.RewardConfig(**vars(rcfg)))
        _close(float(gl), float(wl))
        for k in wm:
            _close(float(gm[k]), float(wm[k]))


def _setup(seed):
    cfg = _tiny_cfg()
    params = _draw(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    head = {"kernel": (0.2 * rng.standard_normal((64, 1))).astype(np.float32),
            "bias": np.zeros((1,), np.float32)}
    return cfg, params, head


def test_sequence_reward_and_make_experience_match_jax():
    """Rewards at the last valid token by segment ids (a padded row); the
    rollout buffer with a row whose response is empty (its score
    dropped), KL shaping against a perturbed reference, whitening."""
    cfg, params, head = _setup(2)
    ref = jax.tree.map(lambda x: x + np.float32(0.02) * np.sign(x), params)
    batch = _rows(cfg, 3, 3, 20)
    jp, jh, jb = (jax.tree.map(jnp.asarray, t) for t in (params, head, batch))
    tp, th = (weights.from_jax_params(t, device="cpu") for t in (params, head))
    tb = batch_to_device(batch, CPU)
    tcfg = _tcfg(cfg)
    _close(trlhf.sequence_reward(tp, th, tcfg, tb).detach().numpy(),
           jrlhf.sequence_reward(jp, jh, cfg, jb), 1e-5)
    mask = np.zeros((3, 19), np.float32)
    mask[0, 8:16] = 1.0
    mask[2, 10:] = 1.0  # row 1: an empty response
    scores = np.array([0.5, 100.0, -1.0], np.float32)
    want = jrlhf.make_experience(jp, jax.tree.map(jnp.asarray, ref), jh, jb, jnp.asarray(mask),
                                 jnp.asarray(scores), cfg=cfg, pcfg=jrlhf.PPOConfig())
    got = trlhf.make_experience(tp, weights.from_jax_params(ref, device="cpu"), th, tb,
                                torch.tensor(mask), torch.tensor(scores), cfg=tcfg,
                                pcfg=trlhf.PPOConfig())
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], 1e-5)
    assert not got["advantages"][1].any()


def test_reward_step_matches_jax():
    cfg, params, head = _setup(4)
    pair = {"chosen": _rows(cfg, 5, 2, 16, first=7), "rejected": _rows(cfg, 6, 2, 16, first=9)}
    opt = recording(optax.adam(1e-3))
    jtr = jax.tree.map(jnp.asarray, (params, head))
    step = jax.jit(functools.partial(jrlhf.reward_step_fn, cfg=cfg, rcfg=jrlhf.RewardConfig(),
                                     optimizer=opt))
    jp2, jh2, jstate, jm = step(*jtr, jax.tree.map(jnp.asarray, pair), opt_state=opt.init(jtr))
    tp, th = (weights.from_jax_params(t, device="cpu") for t in (params, head))
    topt_ = Recording(topt.adam(1e-3))
    tb = {k: batch_to_device(v, CPU) for k, v in pair.items()}
    tp, th, _, tm = trlhf.reward_step_fn(tp, th, tb, cfg=_tcfg(cfg), rcfg=trlhf.RewardConfig(),
                                         optimizer=topt_, opt_state=topt_.init((tp, th)))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), 1e-5)
    assert_step_close(jstate, (jp2, jh2), topt_, (tp, th), 1e-3)


def test_ppo_step_matches_jax():
    """The rollout of `make_experience`, then one PPO step of (policy,
    value head); at that first step new logp equals old, so clipfrac is 0
    and pg_loss is -mean(advantage) over the response mask."""
    cfg, params, head = _setup(7)
    ref = jax.tree.map(lambda x: x + np.float32(0.02) * np.sign(x), params)
    batch = _rows(cfg, 8, 2, 16)
    mask = np.zeros((2, 15), np.float32)
    mask[:, 9:] = 1.0
    scores = np.array([1.0, -1.0], np.float32)
    jtr = jax.tree.map(jnp.asarray, (params, head))
    jb, jm_ = jax.tree.map(jnp.asarray, batch), jnp.asarray(mask)
    pcfg = jrlhf.PPOConfig()
    exp = jrlhf.make_experience(*jtr[:1], jax.tree.map(jnp.asarray, ref), jtr[1], jb, jm_,
                                jnp.asarray(scores), cfg=cfg, pcfg=pcfg)
    opt = recording(optax.adam(1e-3))
    step = jax.jit(functools.partial(jrlhf.ppo_step_fn, cfg=cfg, pcfg=pcfg, optimizer=opt))
    jp2, jh2, jstate, jm = step(*jtr, jb, jm_, exp, opt_state=opt.init(jtr))

    tcfg = _tcfg(cfg)
    tp, th = (weights.from_jax_params(t, device="cpu") for t in (params, head))
    tb = batch_to_device(batch, CPU)
    texp = trlhf.make_experience(tp, weights.from_jax_params(ref, device="cpu"), th, tb,
                                 torch.tensor(mask), torch.tensor(scores), cfg=tcfg,
                                 pcfg=trlhf.PPOConfig())
    topt_ = Recording(topt.adam(1e-3))
    tp, th, _, tm = trlhf.ppo_step_fn(tp, th, tb, torch.tensor(mask), texp, cfg=tcfg,
                                      pcfg=trlhf.PPOConfig(), optimizer=topt_,
                                      opt_state=topt_.init((tp, th)))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        _close(float(tm[k]), float(jm[k]), 1e-5)
    assert float(tm["clipfrac"]) == 0.0
    _close(float(tm["pg_loss"]), float(-(texp["advantages"] * torch.tensor(mask)).sum()
                                       / mask.sum()), 1e-5)
    assert_step_close(jstate, (jp2, jh2), topt_, (tp, th), 1e-3)


def test_sft_step_matches_jax():
    cfg, params, _ = _setup(9)
    batch = _rows(cfg, 10, 2, 16)
    opt = recording(optax.adam(1e-3))
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(functools.partial(jrlhf.sft_step_fn, cfg=cfg, optimizer=opt, chunk_size=8))
    jp2, jstate, jm = step(jp, jax.tree.map(jnp.asarray, batch), opt_state=opt.init(jp))
    tp = weights.from_jax_params(params, device="cpu")
    topt_ = Recording(topt.adam(1e-3))
    tp, _, tm = trlhf.sft_step_fn(tp, batch_to_device(batch, CPU), cfg=_tcfg(cfg),
                                  optimizer=topt_, opt_state=topt_.init(tp), chunk_size=8)
    _close(float(tm["loss"]), float(jm["loss"]), 1e-5)
    assert_step_close(jstate, jp2, topt_, tp, 1e-3)


@pytest.mark.parametrize("kind", ["adamw", "adam"])
def test_tree_optimizer_matches_optax(kind):
    """Three steps over a (dict, dict) tuple tree with a schedule; a leaf
    with no gradient steps with zeros (weight decay alone)."""
    rng = np.random.default_rng(11)
    tree = ({"a": rng.standard_normal((4, 3)).astype(np.float32),
             "b": {"c": rng.standard_normal(5).astype(np.float32)}},
            {"kernel": rng.standard_normal((3, 1)).astype(np.float32)})
    grads = [jax.tree.map(lambda x: rng.standard_normal(x.shape).astype(np.float32), tree)
             for _ in range(3)]
    sched = optax.linear_schedule(1e-2, 1e-3, 3)
    jopt = (optax.adamw(sched, weight_decay=0.1) if kind == "adamw" else optax.adam(sched))
    topt_ = (topt.adamw(lambda n: float(sched(n)), weight_decay=0.1) if kind == "adamw"
             else topt.adam(lambda n: float(sched(n))))
    jt = jax.tree.map(jnp.asarray, tree)
    st = jopt.init(jt)
    tt = weights.to_torch_tree(tree, CPU)
    tst = topt_.init(tt)
    for g in grads:
        g[0]["b"]["c"] = np.zeros(5, np.float32)
        upd, st = jopt.update(jax.tree.map(jnp.asarray, g), st, jt)
        jt = optax.apply_updates(jt, upd)
        for t, gv in zip(topt.leaves(tt), topt.leaves(weights.to_torch_tree(g, CPU))):
            t.grad = None if t is tt[0]["b"]["c"] else gv
        tst = topt_.update(tst, tt)
    assert tst.count == 3
    for want, got in zip(jax.tree.leaves(jt), topt.leaves(tt)):
        _close(got.numpy(), want)
