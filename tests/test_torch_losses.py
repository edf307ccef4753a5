"""The port's remaining training losses (`vila_tpu_torch.train.losses`:
`chunked_sequence_logp`, `soft_cross_entropy`, `dice_loss`,
`token_selection_loss`) against `vila_tpu/train/losses.py` on the CPU in
f32, numpy-drawn inputs; values and gradients within 1e-6 (relative to the
largest). Then the fused LM head + cross entropy (`ops.cross_entropy`), its
plain version forced on the CPU, against the logits route it replaces on
the card."""

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


# --------------------------------------------------------------------------
# The fused LM head + cross entropy (`ops.cross_entropy`), its plain version
# run forced on the CPU, against the logits route it replaces on the card
# --------------------------------------------------------------------------

from vila_tpu_torch.constants import IGNORE_INDEX  # noqa: E402
from vila_tpu_torch.ops import cross_entropy as tce  # noqa: E402
from vila_tpu_torch.utils import profiling  # noqa: E402

V_FUSED, D_FUSED = 40, 16


def _head_case(tied, seed=3):
    """bf16 hidden states (2, 11, D), an f32 head and its config."""
    cfg = tqwen2.LLMConfig(vocab_size=V_FUSED, hidden_size=D_FUSED, intermediate_size=32,
                           num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
                           dtype="bfloat16", tie_word_embeddings=tied)
    rng = np.random.default_rng(seed)
    hidden = torch.tensor(rng.standard_normal((2, 11, D_FUSED)), dtype=torch.bfloat16)
    emb = torch.tensor(0.3 * rng.standard_normal((V_FUSED, D_FUSED)), dtype=torch.float32)
    kernel = torch.tensor(0.3 * rng.standard_normal((D_FUSED, V_FUSED)), dtype=torch.float32)
    params = {"embed_tokens": {"embedding": emb}}
    if not tied:
        params["lm_head"] = {"kernel": kernel}
    return cfg, hidden, params, _labels(rng, 2, 11, V_FUSED)


def _loss_and_grads(fn, hidden, params):
    h = hidden.clone().requires_grad_(True)
    p = {k: {n: t.clone().requires_grad_(True) for n, t in v.items()} for k, v in params.items()}
    loss, n = fn(h, p)
    loss.backward()
    return loss.detach(), int(n), h.grad, {k: {n: t.grad for n, t in v.items()}
                                          for k, v in p.items()}


def _one_bf16_step(got, want):
    """Both rounded to bf16 from f32 sums in another order: within one bf16
    step of the value (2^-7 of its leading power of two)."""
    got, want = got.double(), want.double()
    bar = 2.0 ** -7 * want.abs() + 2.0 ** -16 * max(float(want.abs().max()), 1e-30)
    assert bool(((got - want).abs() <= bar).all())


@pytest.mark.parametrize("tied,z_loss,shift,chunk,labels_case", [
    (True, 0.0, True, None, "drawn"),
    (True, 1e-2, True, 5, "drawn"),
    (True, 0.0, True, 7, "first_chunk_ignored"),
    (False, 1e-2, False, 4, "drawn"),
    (False, 0.0, True, 3, "all_ignored"),
    (True, 1e-2, False, 64, "drawn"),
])
def test_fused_route_plain_matches_the_logits_route(monkeypatch, tied, z_loss, shift, chunk,
                                                    labels_case):
    """`chunked_causal_lm_loss` forced onto the fused route (its plain
    version on CPU tensors) against `causal_lm_loss` over `compute_logits`:
    the loss and its count, the gradients of the hidden states and of the
    head (the tied embedding or the untied kernel); 20 shifted or 22
    unshifted rows in chunks of 5, 7, 4, 3, 64 or `chunk_rows`' (most do
    not divide the rows), a first chunk with every label ignored, every
    label ignored, z_loss."""
    cfg, hidden, params, labels = _head_case(tied)
    labels = torch.tensor(labels).long()
    if labels_case == "first_chunk_ignored":
        labels[0, :9] = IGNORE_INDEX
    elif labels_case == "all_ignored":
        labels[:] = IGNORE_INDEX
    want = _loss_and_grads(lambda h, p: tlosses.causal_lm_loss(
        tqwen2.compute_logits(p, cfg, h), labels, z_loss=z_loss, shift=shift), hidden, params)
    monkeypatch.setattr(tlosses, "fused_route", lambda *a: True)
    got = _loss_and_grads(lambda h, p: tlosses.chunked_causal_lm_loss(
        h, p, cfg, labels, chunk_size=chunk, z_loss=z_loss, shift=shift), hidden, params)
    assert got[1] == want[1]
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-6, atol=1e-7)
    _one_bf16_step(got[2], want[2])
    head = ("embed_tokens", "embedding") if tied else ("lm_head", "kernel")
    _one_bf16_step(got[3][head[0]][head[1]], want[3][head[0]][head[1]])
    if labels_case == "all_ignored":
        assert float(got[0]) == 0.0 and not got[2].any()


def test_hi_lo_split_reconstructs_f32():
    """hi + lo of f32 values over 60 binades, zeros and signs: within
    2^-16 relative (bf16's 8 bits twice, 2^-18 in fact)."""
    rng = np.random.default_rng(4)
    g = torch.tensor(rng.standard_normal(4096) * 2.0 ** rng.integers(-30, 30, 4096),
                     dtype=torch.float32)
    g[::97] = 0.0
    hi, lo = tce.split_hi_lo(g)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = (hi.double() + lo.double() - g.double()).abs()
    assert bool((err <= 2.0 ** -16 * g.double().abs()).all())
    assert bool(((hi.double() - g.double()).abs() > 2.0 ** -16 * g.double().abs()).any())


@pytest.mark.parametrize("z_loss", [0.0, 1e-2])
def test_ce_rows_plain_is_the_gradient_of_nll(z_loss):
    """`ce_rows_plain`: the rows' nll as `_nll` gives it, and hi + lo as
    autograd's d nll / d logits (ignored rows 0)."""
    rng = np.random.default_rng(5)
    logits = torch.tensor(3.0 * rng.standard_normal((9, 33)), dtype=torch.float32,
                          requires_grad=True)
    targets = torch.tensor(rng.integers(0, 33, 9)).long()
    targets[[2, 7]] = IGNORE_INDEX
    nll, _ = tlosses._nll(logits, targets, z_loss)
    nll.sum().backward()
    got_nll, g2 = tce.ce_rows_plain(logits.detach(), targets, z_loss, grad=True)
    assert torch.equal(got_nll, nll.detach())
    got = g2[:9].double() + g2[9:].double()
    assert bool(((got - logits.grad.double()).abs()
                 <= 2.0 ** -16 * logits.grad.double().abs() + 1e-12).all())
    assert tce.ce_rows_plain(logits.detach(), targets, z_loss, grad=False)[1] is None


@pytest.mark.parametrize("tied", [True, False])
def test_head_logits_plain_matches_compute_logits(tied):
    """`head_logits` (compute_logits' route on the card) run on CPU
    tensors: the same f32 logits as the CPU's `compute_logits`, and its
    hi / lo backward's gradients within one bf16 step."""
    cfg, hidden, params, _ = _head_case(tied, seed=6)
    weights = torch.tensor(np.random.default_rng(7).standard_normal((2, 11, V_FUSED)),
                           dtype=torch.float32)
    outs = []
    for fn in (lambda h, p: tqwen2.compute_logits(p, cfg, h),
               lambda h, p: tce.head_logits(h, tqwen2.head_weight(p, cfg))):
        outs.append(_loss_and_grads(lambda h, p: ((fn(h, p) * weights).sum(), 0), hidden,
                                    params))
    want, got = outs
    assert float(got[0]) == float(want[0])
    _one_bf16_step(got[2], want[2])
    head = ("embed_tokens", "embedding") if tied else ("lm_head", "kernel")
    _one_bf16_step(got[3][head[0]][head[1]], want[3][head[0]][head[1]])


def test_fused_route_is_chosen_from_device_head_and_vocabulary_plan():
    """The route follows what the code sees: CUDA hidden states, a dense
    bf16 head (tied or untied), no vocabulary split. A W4 head, an f32
    compute dtype, a vocab-parallel plan or CPU tensors keep the logits
    route."""
    cfg, _, params, _ = _head_case(False)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tlosses.fused_route(cuda, params, cfg)
    assert tlosses.fused_route(cuda, {}, _head_case(True)[0])
    assert not tlosses.fused_route(cpu, params, cfg)
    assert not tlosses.fused_route(cuda, {"lm_head": {"packed": None, "scales": None}}, cfg)
    assert not tlosses.fused_route(cuda, params, cfg, vp=object())
    f32 = tqwen2.LLMConfig(**{**cfg.__dict__, "dtype": "float32"})
    assert not tlosses.fused_route(cuda, params, f32)


@pytest.mark.parametrize("fused", [True, False])
def test_lm_head_span_marks_the_route(monkeypatch, fused):
    """`train.lm_head` spans: the forward's on either route, with its
    tokens, chunks and route; the fused route's backward its own."""
    cfg, hidden, params, labels = _head_case(True)
    if fused:
        monkeypatch.setattr(tlosses, "fused_route", lambda *a: True)
    h = hidden.clone().requires_grad_(True)
    with profiling.recording():
        n0 = len(profiling._kept)
        loss, _ = tlosses.chunked_causal_lm_loss(h, params, cfg, torch.tensor(labels).long(),
                                                 chunk_size=None)
        loss.backward()
        spans = [s for s in list(profiling._kept)[n0:] if s[0] == "train.lm_head"]
    attrs = [s[-1] for s in spans]
    route = "fused" if fused else "logits"
    chunks = -(-20 // tce.chunk_rows(20, V_FUSED))
    assert attrs == [dict(route=route, tokens=20, chunks=chunks)] * (2 if fused else 1)


@pytest.mark.parametrize("device,dtype,vp,want", [
    ("cuda", torch.bfloat16, None, True),
    ("cpu", torch.bfloat16, None, False),
    ("cuda", torch.float32, None, False),
    ("cuda", torch.float16, None, False),
    ("cuda", torch.bfloat16, "plan", False),
])
def test_tensor_core_head_is_the_one_test_of_both_routes(monkeypatch, device, dtype, vp, want):
    """`cross_entropy.tensor_core_head` decides the head's products for
    both `compute_logits` and `fused_route`: the card, bf16 and no
    vocabulary split; `fused_route` adds only the head's kind (a W4 slot
    keeps `quantized_linear`)."""
    assert tce.tensor_core_head(torch.device(device), dtype, vp) is want
    cfg, _, params, _ = _head_case(False)
    seen = []
    monkeypatch.setattr(tce, "tensor_core_head", lambda *a: seen.append(a) or want)
    assert tlosses.fused_route(torch.device(device), params, cfg, vp) is want
    assert seen == [(torch.device(device), torch.bfloat16, vp)]
    packed = {"lm_head": {"packed": None, "scales": None}}
    assert tlosses.fused_route(torch.device(device), packed, cfg, vp) is False
    monkeypatch.setattr(tce, "head_logits", lambda x, w: "tensor cores")
    logits = tqwen2.compute_logits(params, cfg, torch.zeros((1, 2, D_FUSED)))
    assert (isinstance(logits, str)) is want
    assert seen[-1] == (torch.device("cpu"), torch.bfloat16, None)
