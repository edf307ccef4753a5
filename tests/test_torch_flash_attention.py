"""Parity of the port's flash attention (`vila_tpu_torch.ops.flash_attention`,
the plain versions of K7-K9 on the CPU) with the JAX package's Pallas
kernels, run in interpret mode as `tests/test_flash_attention.py` runs them.
Inputs are drawn with numpy from a seed; float32 throughout except the
bf16 test. Tolerance atol 2e-5, rtol 1e-4: the JAX kernels sum blockwise
(online softmax over 128-wide blocks), the plain versions densely."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.ops.flash_attention import flash_attention as jflash
from vila_tpu.ops.flash_attention import flash_block_backward as jblock_bwd
from vila_tpu_torch.ops import attention as tattn
from vila_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=2e-5, rtol=1e-4)


def _qkv(b=1, s=256, hq=4, hkv=2, d=128, seed=0, skv=None):
    rng = np.random.default_rng(seed)
    skv = s if skv is None else skv
    q = (rng.standard_normal((b, s, hq, d)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((b, skv, hkv, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, skv, hkv, d)) * 0.3).astype(np.float32)
    return q, k, v


def _segments(s):
    seg = np.ones((1, s), np.int32)
    seg[:, s // 3:] = 2
    seg[:, 2 * s // 3:] = 3
    return seg


def _torch(*arrays):
    return [torch.tensor(a, requires_grad=a.dtype == np.float32) for a in arrays]


@pytest.mark.parametrize("s,with_seg", [(256, False), (256, True), (200, False), (200, True)])
def test_forward_lse_and_grads_match_jax(s, with_seg):
    q, k, v = _qkv(s=s)
    seg = _segments(s) if with_seg else None
    w = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    jseg = None if seg is None else jnp.asarray(seg)

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=True, q_segment_ids=jseg, kv_segment_ids=jseg,
                   block_q=128, block_kv=128)
        return jnp.sum(o * w)

    jl, jg = jax.value_and_grad(jloss, argnums=(0, 1, 2))(q, k, v)
    jo, jlse = jflash(q, k, v, causal=True, q_segment_ids=jseg, kv_segment_ids=jseg,
                      block_q=128, block_kv=128, return_lse=True)

    tq, tk, tv = _torch(q, k, v)
    tseg = None if seg is None else torch.tensor(seg)
    out = tfa.flash_attention(tq, tk, tv, causal=True, q_segment_ids=tseg,
                              kv_segment_ids=tseg)
    (out * torch.tensor(w)).sum().backward()
    to, tlse = tfa.flash_attention(tq.detach(), tk.detach(), tv.detach(), causal=True,
                                   q_segment_ids=tseg, kv_segment_ids=tseg,
                                   return_lse=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tlse.numpy(), np.asarray(jlse), **TOL)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_block_backward_matches_jax():
    """flash_block_backward with the forward's own LSE and delta."""
    q, k, v = _qkv(s=256, seed=3)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    seg = _segments(256)
    jo, jlse = jflash(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg,
                      block_q=128, block_kv=128, return_lse=True)
    delta = np.sum(w.transpose(0, 2, 1, 3) * np.asarray(jo).transpose(0, 2, 1, 3), -1)
    want = jblock_bwd(q, k, v, w, jlse, delta, causal=True, q_segment_ids=seg,
                      kv_segment_ids=seg, block_q=128, block_kv=128)
    got = tfa.flash_block_backward(
        *map(torch.tensor, (q, k, v, w, np.asarray(jlse), delta)), causal=True,
        q_segment_ids=torch.tensor(seg), kv_segment_ids=torch.tensor(seg))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_cross_attention_is_not_causal():
    """Sq != Skv: causal masking does not apply (JAX's causal_eff)."""
    q, k, v = _qkv(s=200, skv=256, seed=5)
    jo = jflash(q, k, v, causal=True, block_q=128, block_kv=128)
    to = tfa.flash_attention(*map(torch.tensor, (q, k, v)), causal=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_fully_masked_rows_output_zero():
    """A row with nothing to attend to: out 0, LSE -1e30, no gradient."""
    q, k, v = _qkv(s=64, skv=96, seed=6, d=16)
    q_seg = np.ones((1, 64), np.int32)
    q_seg[:, :5] = 7  # segment 7 has no keys
    kv_seg = np.ones((1, 96), np.int32)
    tq, tk, tv = _torch(q, k, v)
    out, lse = tfa.flash_fwd(tq.detach(), tk.detach(), tv.detach(),
                             torch.tensor(q_seg), torch.tensor(kv_seg),
                             causal=False, scale=0.25)
    assert torch.all(out[:, :5] == 0) and torch.all(lse[:, :, :5] == -1e30)
    assert torch.all(lse[:, :, 5:] > -1e3)
    o = tfa.flash_attention(tq, tk, tv, causal=False, q_segment_ids=torch.tensor(q_seg),
                            kv_segment_ids=torch.tensor(kv_seg))
    o.sum().backward()
    assert torch.all(tq.grad[:, :5] == 0) and torch.isfinite(tk.grad).all()


def test_bf16_grads_finite_and_close_to_jax():
    """bf16 in, bf16 gradients out; the dense plain version and the blocked
    kernel round P at different running maxima, so bf16 agreement is to a
    few bf16 ulps of the largest value."""
    q, k, v = _qkv(s=256, seed=5)
    jb = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    jg = jax.grad(lambda q, k, v: jnp.sum(jflash(q, k, v, causal=True, block_q=128,
                                                 block_kv=128).astype(jnp.float32)),
                  argnums=(0, 1, 2))(*jb)
    tb = [torch.tensor(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    tfa.flash_attention(*tb, causal=True).float().sum().backward()
    for t, j in zip(tb, jg):
        assert t.grad.dtype == torch.bfloat16 and torch.isfinite(t.grad.float()).all()
        want = np.asarray(j.astype(jnp.float32))
        err = np.abs(t.grad.float().numpy() - want).max()
        assert err <= 2 ** -5 * np.abs(want).max(), err


def test_cpu_route_never_picks_flash():
    """On the CPU "auto" keeps the plain and blocked routes (JAX off a TPU);
    "flash" forced by name runs the plain versions and agrees with them."""
    q, k, v = map(torch.tensor, _qkv(s=256, seed=7))
    assert not tattn._flash_supported(q, k, None)
    assert not tattn._flash_supported(q.to(torch.bfloat16), k.to(torch.bfloat16), None)
    auto = tattn.multi_head_attention(q, k, v, causal=True)
    xla = tattn.attention_xla(q, k, v, causal=True)
    flash = tattn.multi_head_attention(q, k, v, causal=True, impl="flash")
    assert torch.equal(auto, xla)
    np.testing.assert_allclose(flash.numpy(), xla.numpy(), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.multi_head_attention(q, k, v, impl="pallas")


# --------------------------------------------------------------------------
# The kernels' tile-skip test (`tile_may_attend`, the Python twin of the
# range test in csrc/flash_attn_sm90.cu): a tile pair it rejects must hold
# no allowed (q, k) pair of the dense mask; on ids that never decrease
# (the packing collator's layout, padding 0 ordered last) it is exact.
# --------------------------------------------------------------------------


def _packed(lengths, s):
    """(s,) int32: samples 1, 2, ... of the given lengths, padding 0 after."""
    seg = np.zeros(s, np.int32)
    at = 0
    for i, n in enumerate(lengths):
        seg[at:at + n] = i + 1
        at += n
    return seg


def _shuffled_runs(s, run, n_ids, seed):
    """(s,) int32: runs of `run` rows whose ids (0 among them) come in a
    shuffled order, so that tile ranges overlap without sharing ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_ids, size=(s + run - 1) // run)
    return np.repeat(ids, run)[:s].astype(np.int32)


def _smoke_segments(s):
    """chip_smoke's train_kernels layout: 40 / 35 / 20 % and a padding tail."""
    cuts = [int(s * f) for f in (0.4, 0.75, 0.95)]
    return _packed([cuts[0], cuts[1] - cuts[0], cuts[2] - cuts[1]], s)


def _check_tiles(q_seg, kv_seg, sq, skv, causal, tq, tkv, exact):
    qt = None if q_seg is None else torch.tensor(q_seg)[None]
    kt = None if kv_seg is None else torch.tensor(kv_seg)[None]
    mask = tfa._mask(1, sq, skv, causal, qt, kt, "cpu")
    mask = torch.ones((sq, skv), dtype=torch.bool) if mask is None else mask[0]
    live = 0
    for q0 in range(0, sq, tq):
        for kv0 in range(0, skv, tkv):
            keep = tfa.tile_may_attend(q_seg, kv_seg, q0, kv0, (tq, tkv), causal)
            any_pair = bool(mask[q0:q0 + tq, kv0:kv0 + tkv].any())
            assert keep or not any_pair, (q0, kv0)
            if exact:
                assert keep == any_pair, (q0, kv0)
            live += keep
    return live


@pytest.mark.parametrize("tiles", [(128, 128), (128, 64), (64, 128)], ids=["k7", "k8", "k9"])
@pytest.mark.parametrize("layout", [
    "three_segments_2048", "three_segments_2000", "causal_only_2048",
    "train_row_2048", "non_monotone_2048", "cross_1024_2048"])
def test_tile_may_attend_rejects_only_empty_tiles(layout, tiles):
    tq, tkv = tiles
    causal, sq, skv, exact = True, 2048, 2048, True
    if layout == "three_segments_2048":
        q_seg = _smoke_segments(2048)
    elif layout == "three_segments_2000":
        sq = skv = 2000
        q_seg = _smoke_segments(2000)
    elif layout == "causal_only_2048":
        q_seg = None
    elif layout == "train_row_2048":  # ~6 DummyDataset samples and the padding tail
        q_seg = _packed([341, 337, 352, 329, 346, 330], 2048)
    elif layout == "non_monotone_2048":
        q_seg, exact = _shuffled_runs(2048, 24, 9, seed=3), False
    else:
        causal, sq = False, 1024
        q_seg = _shuffled_runs(1024, 40, 5, seed=1)
        kv_seg, exact = _shuffled_runs(2048, 40, 5, seed=2), False
    if layout != "cross_1024_2048":
        kv_seg = q_seg
    live = _check_tiles(q_seg, kv_seg, sq, skv, causal, tq, tkv, exact)
    if layout == "three_segments_2048" and tiles == (128, 128):
        assert live == 58  # of the 136 causal tile pairs
    if layout == "causal_only_2048" and tiles == (128, 128):
        assert live == 136
    if layout == "three_segments_2048" and tiles == (128, 64):
        assert live == 116  # of the 272 causal tile pairs


@pytest.mark.parametrize("shuffle", [False, True], ids=["packed", "shuffled"])
def test_tile_may_attend_on_drawn_packings(shuffle):
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=25, deadline=None, derandomize=True, database=None)
    @hypothesis.given(lengths=st.lists(st.integers(1, 300), min_size=1, max_size=8),
                      s=st.sampled_from([256, 384, 500, 640]), seed=st.integers(0, 99))
    def check(lengths, s, seed):
        seg = _packed(lengths, s)
        if shuffle:  # the samples' ids in another order
            perm = np.random.default_rng(seed).permutation(len(lengths)) + 1
            seg = np.where(seg > 0, perm[np.maximum(seg - 1, 0)], 0).astype(np.int32)
        for tiles in ((128, 128), (128, 64), (64, 128)):
            _check_tiles(seg, seg, s, s, True, *tiles, exact=not shuffle)

    check()


def test_skipping_rejected_tiles_keeps_the_forward():
    """A blockwise online softmax that walks only the tiles `tile_may_attend`
    keeps (as K7 does) gives the plain forward's output and LSE."""
    s, tile = 512, 64
    q, k, v = (torch.tensor(x) for x in _qkv(s=s, hq=2, hkv=1))
    seg = torch.tensor(_packed([100, 150, 37, 160], s))[None]
    want, want_lse = tfa.flash_fwd_plain(q, k, v, seg, seg, causal=True, scale=0.1)
    mask = tfa._mask(1, s, s, True, seg, seg, "cpu")[0]
    out = torch.zeros_like(q)
    lse = torch.full((1, 2, s), -1e30)
    walked = 0
    for h in range(2):
        for q0 in range(0, s, tile):
            rows = slice(q0, q0 + tile)
            m = torch.full((tile, 1), -1e30)
            l = torch.zeros((tile, 1))
            acc = torch.zeros((tile, 128))
            for kv0 in range(0, s, tile):
                if not tfa.tile_may_attend(seg[0], seg[0], q0, kv0, tile, True):
                    continue
                walked += 1
                cols = slice(kv0, kv0 + tile)
                sc = (q[0, rows, h] @ k[0, cols, 0].T) * 0.1
                sc = sc.masked_fill(~mask[rows, cols], float("-inf"))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p @ v[0, cols, 0]
                m = m_new
            out[0, rows, h] = torch.where(l > 0, acc / torch.where(l > 0, l, 1.0), 0.0)
            lse[0, h, rows] = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)),
                                          -1e30)[:, 0]
    assert walked < 2 * (s // tile) * (s // tile + 1) // 2  # some tiles were skipped
    np.testing.assert_allclose(out.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), **TOL)


def _skipping_dq(q, k, v, do, lse, delta, seg, causal, scale, tiles=(128, 64)):
    """Blockwise dQ that walks only the tile pairs `tile_may_attend` keeps,
    K8's walk: 128 q rows x 64 kv rows, P from the LSE (rows at -1e30 carry
    none), dS = P * (dP - delta), dQ += dS K, scaled once at the end."""
    _, s, hq, d = q.shape
    grp = hq // k.shape[2]
    tq, tkv = tiles
    mask = tfa._mask(1, s, s, causal, seg, seg, "cpu")[0]
    dq = torch.zeros_like(q)
    walked = 0
    for h in range(hq):
        kh, vh = k[0, :, h // grp], v[0, :, h // grp]
        for q0 in range(0, s, tq):
            rows = slice(q0, q0 + tq)
            lse_r = lse[0, h, rows][:, None]
            valid = lse_r > -1e30 / 2
            acc = torch.zeros((min(tq, s - q0), d))
            for kv0 in range(0, s, tkv):
                if not tfa.tile_may_attend(seg[0], seg[0], q0, kv0, tiles, causal):
                    continue
                walked += 1
                cols = slice(kv0, kv0 + tkv)
                sc = (q[0, rows, h] @ kh[cols].T) * scale
                p = torch.exp(sc - torch.where(valid, lse_r, 0.0))
                p = torch.where(valid & mask[rows, cols], p, 0.0)
                dp = do[0, rows, h] @ vh[cols].T
                acc = acc + (p * (dp - delta[0, h, rows][:, None])) @ kh[cols]
            dq[0, rows, h] = acc * scale
    return dq, walked


@pytest.mark.parametrize("layout", ["packed", "shuffled"])
def test_skipping_dq_matches_dense_and_jax(layout):
    """K8's skipping walk (128 x 64 tiles) gives the dense plain dQ and the
    JAX package's `_bwd_dq_kernel` (interpret mode, through
    `flash_block_backward`), on packed samples (padding 0 last) and on
    shuffled runs of ids (the skip test stays conservative)."""
    s, scale = 256, 128 ** -0.5
    q, k, v = _qkv(s=s, seed=11)
    w = (np.random.default_rng(12).standard_normal(q.shape) * 0.3).astype(np.float32)
    seg_np = (_packed([70, 90, 41], s) if layout == "packed"
              else _shuffled_runs(s, 24, 5, seed=4))[None]
    tq, tk, tv, tdo, seg = (torch.tensor(x) for x in (q, k, v, w, seg_np))
    out, lse = tfa.flash_fwd_plain(tq, tk, tv, seg, seg, causal=True, scale=scale)
    delta = (tdo * out).sum(-1).transpose(1, 2).contiguous()
    got, walked = _skipping_dq(tq, tk, tv, tdo, lse, delta, seg, True, scale)
    want = tfa.flash_bwd_dq_plain(tq, tk, tv, tdo, lse, delta, seg, seg, causal=True,
                                  scale=scale)
    jdq, _, _ = jblock_bwd(q, k, v, w, lse.numpy(), delta.numpy(), causal=True,
                           q_segment_ids=seg_np, kv_segment_ids=seg_np, scale=scale,
                           block_q=128, block_kv=128)
    if layout == "packed":
        assert walked < 4 * 6  # of the 6 causal tile pairs per head, 4 heads
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdq), **TOL)
