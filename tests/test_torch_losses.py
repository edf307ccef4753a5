"""The port's remaining training losses (`vila_tpu_torch.train.losses`:
`chunked_sequence_logp`, `soft_cross_entropy`, `dice_loss`,
`token_selection_loss`) against `vila_tpu/train/losses.py` on the CPU in
f32, numpy-drawn inputs; values and gradients within 1e-6 (relative to the
largest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.train import losses as jlosses
from vila_tpu_torch.train import losses as tlosses

from test_torch_train import _labels, _same, tqwen2


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("chunk", [4, 16])
def test_chunked_sequence_logp_and_its_gradient_match_jax(chunk):
    """Per-row sums over 2 x (13 - 1) shifted positions, chunks of 4
    (padding in the last) and one chunk of 16; gradients to the hidden
    states and the tied embedding."""
    cfg = jqwen2.LLMConfig(vocab_size=40, hidden_size=16, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                           dtype="float32")
    rng = np.random.default_rng(0)
    emb = (0.3 * rng.standard_normal((40, 16))).astype(np.float32)
    hidden = rng.standard_normal((2, 13, 16)).astype(np.float32)
    labels = _labels(rng, 2, 13, 40)

    def jl(h, e):
        return jlosses.chunked_sequence_logp(h, {"embed_tokens": {"embedding": e}}, cfg,
                                             jnp.asarray(labels), chunk)

    want = jl(hidden, emb)
    wg = jax.grad(lambda h, e: (jl(h, e) * jnp.asarray([1.0, -2.0])).sum(),
                  argnums=(0, 1))(hidden, emb)
    th, te = torch.tensor(hidden, requires_grad=True), torch.tensor(emb, requires_grad=True)
    got = tlosses.chunked_sequence_logp(th, {"embed_tokens": {"embedding": te}},
                                        _same(tqwen2.LLMConfig, cfg), torch.tensor(labels),
                                        chunk)
    (got * torch.tensor([1.0, -2.0])).sum().backward()
    _close(got.detach().numpy(), want)
    _close(th.grad.numpy(), wg[0])
    _close(te.grad.numpy(), wg[1])


def test_soft_cross_entropy_matches_jax():
    """Time tokens 20..27 among a vocab of 32: soft labels, hard labels
    (ignored by this loss), IGNORE_INDEX; std 1 and 2.5; with the
    gradient to the logits."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 11, 32)).astype(np.float32)
    labels = rng.integers(0, 32, (2, 11)).astype(np.int32)
    labels[0, 3] = -100
    labels[1, 4:8] = [20, 27, 23, 25]
    soft = np.arange(20, 28, dtype=np.int32)
    for std in (1.0, 2.5):
        want, wg = jax.value_and_grad(lambda x: jlosses.soft_cross_entropy(
            x, jnp.asarray(labels), jnp.asarray(soft), std))(jnp.asarray(logits))
        t = torch.tensor(logits, requires_grad=True)
        got = tlosses.soft_cross_entropy(t, torch.tensor(labels), torch.tensor(soft), std)
        got.backward()
        _close(got.item(), float(want))
        _close(t.grad.numpy(), wg)


def test_dice_and_token_selection_losses_match_jax():
    """Selection probabilities at two scales (4 x 4 and 8 x 8 grids), gt
    maps at 8 x 8 (area-resized to each grid); instance 1 has no gt and
    is masked out; gradients to the probabilities."""
    rng = np.random.default_rng(2)
    probs = [rng.uniform(0.0, 1.0, (3, g, g)).astype(np.float32) for g in (4, 8)]
    probs[0][0, 0, 0] = 0.0  # clipped to 1e-6
    gt = (rng.random((3, 8, 8)) < 0.3).astype(np.float32)
    gt[1] = 0.0
    _close(tlosses.dice_loss(torch.tensor(probs[1]), torch.tensor(gt)).numpy(),
           jlosses.dice_loss(jnp.asarray(probs[1]), jnp.asarray(gt)))
    want, wg = jax.value_and_grad(lambda ps: jlosses.token_selection_loss(ps, jnp.asarray(gt)))(
        [jnp.asarray(p) for p in probs])
    ts = [torch.tensor(p, requires_grad=True) for p in probs]
    got = tlosses.token_selection_loss(ts, torch.tensor(gt))
    got.backward()
    _close(got.item(), float(want))
    for t, w in zip(ts, wg):
        _close(t.grad.numpy(), w)
    # no gt anywhere: the loss of every instance is masked out
    zero = tlosses.token_selection_loss([torch.tensor(p) for p in probs],
                                        torch.zeros((3, 8, 8)))
    assert float(zero) == float(jlosses.token_selection_loss(
        [jnp.asarray(p) for p in probs], jnp.zeros((3, 8, 8)))) == 0.0
