"""The fused LM head + cross entropy on the H100 (`-m card`; skips without
CUDA): at NVILA-Lite-2B's width (S 2048, V 152000, D 1536, the tied
embedding) the fused route (`train.losses.chunked_causal_lm_loss` with no
chunk size, hence `ops.cross_entropy.lm_head_nll`) against the path it
replaces, the f32 product of the bf16 values and `causal_lm_loss` over the
whole logits. This file imports no JAX; `tests/conftest.py` is the JAX
suite's, so run it without:

    python -m pytest tests/test_torch_lm_head_card.py -m card --noconftest -q -s
"""

import pytest
import torch

from vila_tpu_torch.constants import IGNORE_INDEX
from vila_tpu_torch.models import qwen2
from vila_tpu_torch.ops import _build, cross_entropy
from vila_tpu_torch.train import losses

S, V, D = 2048, 152000, 1536
BF16_ULP = 2.0 ** -7  # the spacing of bf16 values relative to their leading power of two


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA H100 (no CUDA here)")
    return torch.device("cuda")


def _inputs(dev):
    g = torch.Generator(device=dev).manual_seed(2026)
    hidden = torch.randn((1, S, D), generator=g, device=dev).to(torch.bfloat16)
    emb = 0.02 * torch.randn((V, D), generator=g, device=dev)
    labels = torch.randint(0, V, (1, S), generator=g, device=dev)
    labels[torch.rand((1, S), generator=g, device=dev) < 0.25] = IGNORE_INDEX
    return hidden, emb, labels


def _cfg():
    return qwen2.LLMConfig(vocab_size=V, hidden_size=D, intermediate_size=8960,
                           num_hidden_layers=1, num_attention_heads=12, num_key_value_heads=2,
                           dtype="bfloat16", tie_word_embeddings=True)


def _run(fn, hidden, emb, labels):
    """(loss, dX, dW, peak bytes above the inputs) of one forward and
    backward from fresh leaves."""
    h = hidden.clone().requires_grad_(True)
    e = emb.clone().requires_grad_(True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss = fn(h, e)
    loss.backward()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    return loss.detach(), h.grad, e.grad, peak


def _no_worse(got, want, exact):
    """The route's gradient against the f64 product, beside the replaced
    path's: both are rounded to bf16 at the end, so their errors are that
    rounding's, whatever order the f32 sums ran in. Returns (ok, a line)."""
    eg, ew = (got.double() - exact).abs(), (want.double() - exact).abs()
    ok = eg.mean() <= 1.05 * ew.mean() and eg.max() <= 1.25 * ew.max()
    return bool(ok), (f"error mean {float(eg.mean()):.3e} / {float(ew.mean()):.3e}, max "
                      f"{float(eg.max()):.3e} / {float(ew.max()):.3e}, "
                      f"{float((got != want).float().mean()):.4f} differ")


def _exact(hidden, emb, labels, z_loss):
    """dX and dW of the mean cross entropy in f64 from the bf16 values."""
    h = hidden[0, :-1].double()
    w = emb.to(torch.bfloat16).double()
    t = labels[0, 1:]
    valid = t != IGNORE_INDEX
    logits = h @ w.T
    lse = torch.logsumexp(logits, -1)
    g = torch.exp(logits - lse[:, None]) * (1 + 2 * z_loss * lse)[:, None]
    g[valid, t[valid]] -= 1.0
    g = torch.where(valid[:, None], g, 0.0) / valid.sum()
    dx = torch.zeros((1,) + hidden.shape[1:], dtype=torch.float64, device=hidden.device)
    dx[0, :-1] = g @ w
    return dx, g.T @ h


@pytest.mark.card
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_fused_route_matches_the_f32_path_at_full_width(card, z_loss):
    hidden, emb, labels = _inputs(card)
    cfg = _cfg()
    want_loss, want_dx, want_dw, want_peak = _run(  # the path the route replaces
        lambda h, e: losses.causal_lm_loss(
            h.to(torch.bfloat16).float() @ e.to(torch.bfloat16).float().T, labels,
            z_loss=z_loss)[0], hidden, emb, labels)
    before = _build.LAUNCHES["ce_rows"]
    got_loss, got_dx, got_dw, got_peak = _run(
        lambda h, e: losses.chunked_causal_lm_loss(
            h, {"embed_tokens": {"embedding": e}}, cfg, labels, chunk_size=None,
            z_loss=z_loss)[0], hidden, emb, labels)
    chunks = -(-(S - 1) // cross_entropy.chunk_rows(S - 1, V))
    launches = _build.LAUNCHES["ce_rows"] - before
    exact_dx, exact_dw = _exact(hidden, emb, labels, z_loss)
    ok_dx, line_dx = _no_worse(got_dx, want_dx, exact_dx)
    ok_dw, line_dw = _no_worse(got_dw, want_dw, exact_dw)
    rel = abs(float(got_loss) - float(want_loss)) / abs(float(want_loss))
    print(f"\n[lm_head z_loss {z_loss}] loss {float(got_loss):.7f} / {float(want_loss):.7f} "
          f"(rel {rel:.2e}); route / replaced path: dX {line_dx}; dW {line_dw}; ce_rows "
          f"launches {launches} (chunks {chunks}); peak above the inputs "
          f"{got_peak / 2**30:.3f} / {want_peak / 2**30:.3f} GiB")
    assert rel <= 1e-6
    assert ok_dx and ok_dw
    assert launches == chunks == 2
    assert want_peak - got_peak >= 2e9


@pytest.mark.card
def test_ce_rows_matches_its_plain_version(card):
    """The kernel against `ce_rows_plain` on the same logits: nll within
    f32 rounding, the hi / lo rows within a bf16 step of each part, ignored
    rows zero; and a width that is not a multiple of 4 (the scalar path)."""
    g = torch.Generator(device=card).manual_seed(7)
    for rows, vocab in ((1024, V), (37, 1001)):
        logits = 4.0 * torch.randn((rows, vocab), generator=g, device=card)
        targets = torch.randint(0, vocab, (rows,), generator=g, device=card)
        targets[::5] = IGNORE_INDEX
        for z in (0.0, 1e-4):
            nll, g2 = cross_entropy.ce_rows(logits, targets, z, grad=True)
            want_nll, want_g2 = cross_entropy.ce_rows_plain(logits, targets, z, grad=True)
            assert torch.allclose(nll, want_nll, rtol=1e-6, atol=1e-5)
            # the probabilities (g + onehot) agree to the few f32 steps of
            # lse (|lse| ~ 20) that exp(x - lse) carries into them
            onehot = torch.zeros_like(logits)
            keep = targets != IGNORE_INDEX
            onehot[keep.nonzero()[:, 0], targets[keep]] = 1.0
            got = g2[:rows].float() + g2[rows:].float() + onehot
            want = want_g2[:rows].float() + want_g2[rows:].float() + onehot
            gap = ((got - want).abs() / (want.abs() + 1e-30)).max()
            print(f"\n[ce_rows {rows} x {vocab} z_loss {z}] nll gap "
                  f"{float((nll - want_nll).abs().max()):.2e}, probabilities' gap {float(gap):.2e}")
            assert gap <= 3e-5
            assert not g2[:rows][::5].any() and not g2[rows:][::5].any()
            loss_only, none = cross_entropy.ce_rows(logits, targets, z, grad=False)
            assert none is None and torch.equal(loss_only, nll)


@pytest.mark.card
def test_compute_logits_on_the_card_keeps_its_gradients(card):
    """`compute_logits` on the card (one bf16 product with f32 output, the
    hi / lo backward) against the f32 product of the same bf16 values."""
    hidden, emb, _ = _inputs(card)
    hidden = hidden[:, :512]
    cfg = _cfg()
    weights = torch.randn((1, 512, V), device=card) * 1e-3
    outs = []
    for fn in (lambda h, e: h.float() @ e.to(torch.bfloat16).float().T,
               lambda h, e: qwen2.compute_logits({"embed_tokens": {"embedding": e}}, cfg, h)):
        h = hidden.clone().requires_grad_(True)
        e = emb.clone().requires_grad_(True)
        logits = fn(h, e)
        (logits * weights).sum().backward()
        outs.append((logits.detach(), h.grad, e.grad))
    (wl, wx, ww), (gl, gx, gw) = outs
    h64, w64, g64 = hidden.double(), emb.to(torch.bfloat16).double(), weights.double()
    ok_x, line_x = _no_worse(gx, wx, g64 @ w64)
    ok_w, line_w = _no_worse(gw, ww, (g64[0].T @ h64[0]))
    print(f"\n[compute_logits] logits gap {float((gl - wl).abs().max()):.2e} of "
          f"{float(wl.abs().max()):.2e}; dX {line_x}; dW {line_w}")
    assert gl.dtype == torch.float32
    assert (gl - wl).abs().max() <= 1e-5 * wl.abs().max()
    assert ok_x and ok_w
