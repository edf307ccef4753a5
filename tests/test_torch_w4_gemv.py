"""K1, the W4 GEMV for M <= 32 rows (`csrc/w4_gemv_sm90.cu`), on the CPU.

K1 has two forms on the card, picked by one rule (`quant.k1_form`): M = 1
streams the weights through a ring of TMA boxes into dp4a, M >= 2 is one
persistent launch on the int8 tensor cores over digits written once in
`_w4_digits_ref`'s padded layout. What the host decides is checked here:
the rule, both forms' unit plans (every (column, group) once), that the
wgmma form's padded-digit arithmetic (`_w4_rows_ref`) is K1's function
(`_w4_gemv_ref`) bit for bit, and that the launchers refuse CPU tensors.
The plain version against the JAX decode kernel is in
`test_torch_quant.py` (and at group 112 in `test_torch_w4_pair.py`).
Inputs are drawn with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from vila_tpu_torch.ops import quant as tquant

N_SM = 132  # the H100's SMs


def _slot(rng, lead, din, dout, group):
    w = torch.from_numpy((0.05 * rng.standard_normal(lead + (din, dout))).astype(np.float32))
    q = tquant.quantize_w4(w, group)
    return q["packed"], q["scales"]


def _x(rng, m, din):
    return torch.from_numpy(rng.standard_normal((m, din)).astype(np.float32)).to(torch.bfloat16)


ROWS_CASES = [(m, g, lead) for m in (2, 9, 24, 32) for g in (112, 128) for lead in ((), (2,))]


@pytest.mark.parametrize("m,group,lead", ROWS_CASES,
                         ids=[f"M{m}-g{g}-{'stacked' if l else 'flat'}" for m, g, l in ROWS_CASES])
def test_rows_arithmetic_is_k1_bit_for_bit(m, group, lead):
    """The wgmma form's arithmetic: the padded digits of `_w4_digits_ref`
    (no prologue) through `_w4_gemv_rows_ref` give `_w4_gemv_ref`'s f32 sums
    bit for bit, flat and stacked (layer 1), at groups 112 and 128."""
    rng = np.random.default_rng(100 + m + group + len(lead))
    din = 4 * group
    packed, scales = _slot(rng, lead, din, 384, group)
    li = 1 if lead else None
    x = _x(rng, m, din)
    got = tquant._w4_rows_ref(x, packed, scales, li)
    want = tquant._w4_gemv_ref(x, packed, scales, li, out_f32=True)
    assert got.dtype == torch.float32 and got.shape == (m, 384)
    assert torch.equal(got, want)
    assert torch.equal(got.to(torch.bfloat16), tquant._w4_gemv_ref(x, packed, scales, li))


def test_k1_form_rule():
    """One row streams (dp4a, the ring of TMA boxes) where the stream form's
    consumers can hold the row (20480 inputs: every NVILA-8B and Qwen2-0.5B
    slot); two rows and more, and longer rows (Qwen2-72B's down_proj, 29568
    inputs), take the persistent tensor-core form; no other answer."""
    for din in (3584, 896, 18944, 4864, 20480):
        assert tquant.k1_form(1, din) == "stream"
        for m in range(2, 33):
            assert tquant.k1_form(m, din) == "wgmma"
    assert tquant.k1_form(1, 29568) == "wgmma"


def _widths():
    """(din, dout, bout, group) of K1's slots at NVILA-8B (the untied lm_head
    and the four projections) and Qwen2-0.5B (the four projections, groups
    of 112 where D = 896)."""
    out = {}
    for model, (d, inter, hq, hkv, hd, vocab) in (
            ("nvila-8b", (3584, 18944, 28, 4, 128, 152064)),
            ("qwen2-0.5b", (896, 4864, 14, 2, 64, None))):
        shapes = {"qkv": (d, (hq + 2 * hkv) * hd, None), "o": (hkv * 8 * hd, d, None),
                  "gate_up": (d, 2 * inter, None), "down": (inter, d, 5 << 20)}
        if vocab:
            shapes["lm_head"] = (d, vocab, None)
        for name, (din, dout, budget) in shapes.items():
            bout = tquant.pick_bout(din, dout, budget or tquant._BLOCK_BUDGET)
            out[f"{model}-{name}"] = (din, dout, bout, tquant.group_for(din // 2))
    return out


WIDTHS = _widths()


@pytest.mark.parametrize("name", list(WIDTHS))
def test_k1_plan_covers_every_column_and_group_once(name):
    """At every M from 1 to 32 on a 132-SM card, the units K1's launch deals
    (the stream form's spans and splits at M = 1, the wgmma form's tiles and
    splits above) cover every (output column, group) exactly once, each
    inside one bout block, on at most one CTA per SM."""
    din, dout, bout, group = WIDTHS[name]
    ngh = din // 2 // group
    for m in range(1, 33):
        seen = np.zeros((dout, ngh), np.int32)
        for cta, (c0, c1), (g0, g1) in tquant.k1_work(m, dout, bout, ngh, N_SM, group):
            assert 0 <= cta < N_SM and g0 < g1 and c0 < c1
            assert c0 // bout == (c1 - 1) // bout
            seen[c0:c1, g0:g1] += 1
        assert (seen == 1).all(), (name, m)


def test_stream_plan_balances_the_lm_head():
    """The stream form's plan at the NVILA-8B lm_head (1188 spans of 128
    columns): every SM busy and the busiest CTA within 10 % of the mean
    (group, column) pairs; the qkv (36 spans) is split over K so that at
    least three quarters of the SMs take a unit."""
    din, dout, bout, group = WIDTHS["nvila-8b-lm_head"]
    ngh = din // 2 // group
    ks, gps, n_cta = tquant.stream_plan(dout, bout, ngh, N_SM, group)
    load = np.zeros(n_cta)
    for cta, (c0, c1), (g0, g1) in tquant.k1_work(1, dout, bout, ngh, N_SM, group):
        load[cta] += (c1 - c0) * (g1 - g0)
    assert n_cta == N_SM and load.max() <= 1.1 * load.mean()
    din, dout, bout, group = WIDTHS["nvila-8b-qkv"]
    ks, gps, n_cta = tquant.stream_plan(dout, bout, din // 2 // group, N_SM, group)
    assert ks > 1 and n_cta >= 0.75 * N_SM


def test_wgmma_plan_is_k4_k5_plan():
    """K1's wgmma form takes K4/K5's unit plan (`quant.unit_plan`), every
    tile whole where it takes no split: the lm_head's 1188 tiles fill nine
    waves whole, the qkv's 36 are split over K."""
    assert tquant.wgmma_plan(152064, 14, N_SM) == (1188, 1, 14)
    assert tquant.wgmma_plan(4608, 14, N_SM) == tquant.unit_plan(4608, 14, N_SM)
    whole, ks, gps = tquant.wgmma_plan(4608, 14, N_SM)
    assert whole == 0 and ks > 1 and (ks - 1) * gps < 14 <= ks * gps


def test_stream_spans_put_narrow_spans_last():
    """Where the box does not divide bout (256-byte spans of the lm_head's
    1408-column blocks), the spans are numbered as the kernel numbers them:
    every whole span first, block by block, then each block's narrower last
    span; together they tile every block once."""
    spans = tquant._spans(152064, 1408, 256)
    assert len(spans) == 108 * 6
    assert all(w == 256 for _, _, w in spans[:540]) and all(w == 128 for _, _, w in spans[540:])
    cover = np.zeros(152064, np.int32)
    for jb, o0, w in spans:
        cover[jb * 1408 + o0:jb * 1408 + o0 + w] += 1
    assert (cover == 1).all()


def test_k1_launchers_raise_off_the_card():
    """A CPU tensor never reaches K1's launch functions (either form, or the
    probe): they raise; the public wrapper takes the plain version first."""
    rng = np.random.default_rng(7)
    packed, scales = _slot(rng, (), 512, 256, 128)
    for m in (1, 2, 8, 24):
        x = _x(rng, m, 512)
        out = torch.empty((m, 256), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA"):
            tquant.launch_gemv(x, packed, scales, None, out)
    with pytest.raises(ValueError, match="CUDA"):
        tquant.launch_probe(packed, 256)
    x = _x(rng, 8, 512)
    got = tquant.w4_matmul_decode(x, packed, scales)
    assert torch.equal(got, tquant._w4_gemv_ref(x, packed, scales))
