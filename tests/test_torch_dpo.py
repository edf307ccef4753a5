"""The port's DPO (`vila_tpu_torch.train.dpo`) against
`vila_tpu/train/dpo.py` on the CPU in f32 over the tiny VLM of
`test_torch_train.py`: `DPOCollator` bit for bit, `dpo_loss` (sigmoid with
and without label smoothing, IPO) and its four metrics within 1e-6,
`sequence_logp` chunked and whole within 1e-5, and one `dpo_step_fn`
(the policy against a perturbed frozen reference, `optax.adamw` against
the port's `adamw`) with loss and metrics within 1e-5, the gradients
within 1e-5 of each leaf's largest and the updated tree as
`assert_step_close` states (the metrics of `dpo_loss`, means of terms
that cancel, within 1e-6 of those terms)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vila_tpu.data.collate import Collator as JCollator
from vila_tpu.train import dpo as jdpo
from vila_tpu_torch.data.collate import Collator as TCollator
from vila_tpu_torch.train import dpo as tdpo
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train.step import batch_to_device
from vila_tpu_torch.utils import weights

from test_torch_fp8 import _tcfg
from test_torch_train import _draw, _tiny_cfg

CPU = torch.device("cpu")


def _pairs(cfg, seed, n=2):
    """n (chosen, rejected) pairs sharing a prompt; chosen rows carry an
    image."""
    rng = np.random.default_rng(seed)
    tpi = cfg.tokens_per_image
    pairs = []
    for i in range(n):
        prompt = rng.integers(3, 90, 6).astype(np.int32)
        side = {}
        for name in ("chosen", "rejected"):
            ans = rng.integers(3, 90, int(rng.integers(5, 12))).astype(np.int32)
            ids = np.concatenate([prompt, ans])
            labels = np.concatenate([np.full(6, -100, np.int32), ans])
            ex = {"input_ids": ids, "labels": labels,
                  "tiles": np.zeros((0, 56, 56, 3), np.uint8),
                  "media_positions": np.zeros((0,), np.int32)}
            if name == "chosen":
                ids[:tpi] = 95
                ex["tiles"] = rng.integers(0, 256, (1, 56, 56, 3), dtype=np.uint8)
                ex["media_positions"] = np.arange(tpi, dtype=np.int32)
            side[name] = ex
        pairs.append(side)
    return pairs


def test_dpo_collator_matches_jax():
    cfg = _tiny_cfg()
    pairs = _pairs(cfg, 0, n=3)
    want = jdpo.DPOCollator(JCollator(seq_len=24, tile_size=56))(pairs)
    got = tdpo.DPOCollator(TCollator(seq_len=24, tile_size=56))(pairs)
    for side in ("chosen", "rejected"):
        assert sorted(got[side]) == sorted(want[side])
        for k, v in want[side].items():
            np.testing.assert_array_equal(got[side][k], v)


@pytest.mark.parametrize("loss_type,smoothing", [("sigmoid", 0.0), ("sigmoid", 0.2),
                                                 ("ipo", 0.0)])
def test_dpo_loss_and_metrics_match_jax(loss_type, smoothing):
    rng = np.random.default_rng(1)
    logps = [(rng.standard_normal(5) * 10).astype(np.float32) for _ in range(4)]
    jc = jdpo.DPOConfig(beta=0.3, label_smoothing=smoothing, loss_type=loss_type)
    tc = tdpo.DPOConfig(beta=0.3, label_smoothing=smoothing, loss_type=loss_type)
    wl, wm = jdpo.dpo_loss(*map(jnp.asarray, logps), jc)
    gl, gm = tdpo.dpo_loss(*map(torch.tensor, logps), tc)
    np.testing.assert_allclose(float(gl), float(wl), rtol=1e-6)
    assert sorted(gm) == sorted(wm)
    for k in wm:  # means of terms of size ~3 that cancel: 1e-6 of that size
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-6, atol=3e-6)


@pytest.mark.parametrize("chunk", [None, 8])
def test_sequence_logp_matches_jax(chunk):
    cfg = _tiny_cfg()
    params = _draw(cfg, 2)
    batch = JCollator(seq_len=24, tile_size=56)([p["chosen"] for p in _pairs(cfg, 3)])
    want = jdpo.sequence_logp(jax.tree.map(jnp.asarray, params), cfg,
                              {k: jnp.asarray(v) for k, v in batch.items()}, chunk)
    got = tdpo.sequence_logp(weights.from_jax_params(params, device="cpu"), _tcfg(cfg),
                             batch_to_device(batch, CPU), chunk)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5)


class Recording:
    """The port's tree optimizer, keeping a copy of the gradients it is
    handed."""

    def __init__(self, inner):
        self.inner, self.grads = inner, None

    def init(self, params):
        return self.inner.init(params)

    def update(self, state, params):
        self.grads = [torch.zeros_like(t) if t.grad is None else t.grad.detach().clone()
                      for t in topt.leaves(params)]
        return self.inner.update(state, params)


def recording(tx):
    """`tx` after a transformation whose state is the last gradients (so a
    jitted JAX step returns them in its optimizer state)."""
    keep = optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda g, s, p=None: (g, g))
    return optax.chain(keep, tx)


def assert_step_close(jstate, want_tree, rec, got_tree, lr):
    """One optimizer step against JAX's. The gradients: each leaf within
    1e-5 of its largest |g| (the k biases, whose true gradient is zero,
    within 1e-6 of the tree's largest). The updated trees: Adam's first update is
    about lr * g / (|g| + eps), so where a gradient element is itself a
    rounding residue (a cancellation of the chosen and rejected terms, or
    the k projection's bias, whose true gradient is zero) the two updates
    differ by a share of lr: every element within 0.1 lr (the k biases
    within 2 lr: two first updates of noise), and 99.9 % within 1e-5."""
    jgrads = jax.tree_util.tree_flatten_with_path(jstate[0])[0]
    assert len(jgrads) == len(rec.grads)
    top = max(float(np.abs(np.asarray(g)).max()) for _, g in jgrads)
    for (path, want), got in zip(jgrads, rec.grads):
        want, key = np.asarray(want), jax.tree_util.keystr(path)
        # the k bias's gradient is rounding noise: held to 1e-6 of the largest
        bar = 1e-6 * top if "k_proj']['bias" in key else 1e-5 * np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= bar, key
    n_off = n_all = 0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                                 topt.leaves(got_tree)):
        diff = np.abs(got.detach().numpy() - np.asarray(want))
        key = jax.tree_util.keystr(path)
        # Adam normalizes the k bias's noise: each first update is within lr
        assert diff.max() <= (2.002 if "k_proj']['bias" in key else 0.1) * lr, key
        n_off += int((diff > 1e-5 + 1e-5 * np.abs(np.asarray(want))).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


@pytest.mark.parametrize("loss_type", ["sigmoid", "ipo"])
def test_dpo_step_matches_jax(loss_type):
    cfg = _tiny_cfg()
    params = _draw(cfg, 4)
    ref = jax.tree.map(lambda x: x + np.float32(0.01) * np.sign(x), params)
    pair_batch = jdpo.DPOCollator(JCollator(seq_len=24, tile_size=56))(_pairs(cfg, 5))
    jc = jdpo.DPOConfig(loss_type=loss_type, chunk_size=8)
    opt = recording(optax.adamw(1e-3))
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(functools.partial(jdpo.dpo_step_fn, cfg=cfg, dcfg=jc, optimizer=opt))
    jp2, jstate, jm = step(jp, jax.tree.map(jnp.asarray, ref),
                           jax.tree.map(jnp.asarray, pair_batch), opt_state=opt.init(jp))

    tp = weights.from_jax_params(params, device="cpu")
    tref = weights.from_jax_params(ref, device="cpu")
    topt_ = Recording(topt.adamw(1e-3))
    tb = {k: batch_to_device(v, CPU) for k, v in pair_batch.items()}
    tp, _, tm = tdpo.dpo_step_fn(tp, tref, tb, cfg=_tcfg(cfg),
                                 dcfg=tdpo.DPOConfig(loss_type=loss_type, chunk_size=8),
                                 optimizer=topt_, opt_state=topt_.init(tp))
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert_step_close(jstate, jp2, topt_, tp, 1e-3)
    assert all(not t.requires_grad for t in topt.leaves(tref))
