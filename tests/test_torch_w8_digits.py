"""Parity of the port's W8A16 flat slot and of K1's one-digit form with the
JAX package on the CPU.

* `quantize_w8` gives the JAX package's int8 bytes and bf16 scales;
  `dequantize` and `quantized_linear` over a W8 slot agree with JAX's.
* `w4_matmul_decode(act_digits=1)` (the plain version of K1's one-digit
  form, which its wrapper takes for CPU tensors) equals the exact integer
  product of the one-digit expansion, agrees with the JAX decode kernel at
  `act_digits=1` (interpret mode) and with dequantize + matmul within the
  JAX package's bar (`tests/test_quant.py:53`: 0.06). The JAX kernel's
  compiled body rounds x / s1 through a reciprocal (XLA on the CPU): where
  that quotient rounds to another digit than the IEEE one, the two differ
  by that digit's step, which the comparison allows, counted from the
  inputs (`_reciprocal_allowance`).
* The one-digit expansion is the first digit of the two-digit one.

Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vila_tpu.ops import quant as jquant
from vila_tpu_torch.ops import quant as tquant
from vila_tpu_torch.utils import weights

DIN, DOUT = 512, 384


def _bf16_np(rng, shape, scale=1.0):
    """Random values exactly representable in bf16, as float32."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _w(seed, shape=(DIN, DOUT)):
    return (0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


def _torch_tree(tree):
    return weights.from_jax_params(tree, device="cpu")


def _planes(jq, layer=None):
    """The lo and hi nibble weights (int64, - 8) and f32 scales of a flat
    (nj = 1) W4 slot, or of one layer of a stacked one."""
    p, s = np.asarray(jq["packed"]), np.asarray(jq["scales"]).astype(np.float32)
    if layer is not None:
        p, s = p[layer], s[layer]
    assert p.shape[0] == 1
    p, s = p[0], s[0]
    return ((p & 15).astype(np.int64) - 8, (p >> 4).astype(np.int64) - 8), s


def _one_digit_exact(x, jq, layer=None, group=128):
    """The one-digit K1 product in integers and f64 scales: IEEE quotients
    x / s1, s1 = max(amax / 127, 1e-20) per row and half-plane."""
    (lo, hi), s = _planes(jq, layer)
    half = x.shape[1] // 2
    ngh = half // group
    out = np.zeros((x.shape[0], lo.shape[1]))
    for h, w in enumerate((lo, hi)):
        xs = x[:, h * half:(h + 1) * half]
        s1 = np.maximum(np.abs(xs).max(1, keepdims=True) / np.float32(127), np.float32(1e-20))
        q = np.clip(np.round(xs / s1), -127, 127).astype(np.int64)
        for g in range(ngh):
            sl = slice(g * group, (g + 1) * group)
            out += (q[:, sl] @ w[sl]) * (s1.astype(np.float64) * s[h * ngh + g][None])
    return out


def _reciprocal_allowance(x, jq, layer=None):
    """Per row: the steps by which the JAX kernel's digits (x * (1 / s1))
    may stand from the IEEE ones, times the largest weight a digit meets."""
    (lo, hi), s = _planes(jq, layer)
    wmax = float(np.abs(np.concatenate([lo, hi])).max() * np.abs(s).max())
    half = x.shape[1] // 2
    allow = np.zeros((x.shape[0], 1))
    for h in range(2):
        xs = x[:, h * half:(h + 1) * half]
        s1 = np.maximum(np.abs(xs).max(1, keepdims=True) / np.float32(127), np.float32(1e-20))
        flips = (np.round(xs / s1) != np.round(xs * (np.float32(1) / s1))).sum(1, keepdims=True)
        allow += flips * s1 * wmax
    return allow


@pytest.mark.parametrize("lead", [(), (3,)])
@pytest.mark.parametrize("group", [128, 64])
def test_quantize_w8_bytes_identical(lead, group):
    w = _w(1, lead + (DIN, DOUT))
    jq = jquant.quantize_w8(jnp.asarray(w), group_size=group)
    tq = tquant.quantize_w8(torch.from_numpy(w), group_size=group)
    assert tq["packed"].dtype == torch.int8 and tq["scales"].dtype == torch.bfloat16
    assert (tq["group_size"], tq["bits"]) == (group, 8)
    np.testing.assert_array_equal(tq["packed"].numpy(), np.asarray(jq["packed"]))
    np.testing.assert_array_equal(tq["scales"].view(torch.int16).numpy(),
                                  np.asarray(jq["scales"]).view(np.int16))


def test_quantize_w8_of_bf16_weights_identical():
    """A bf16 kernel, as a checkpoint holds it (the chip check's input)."""
    w = _bf16_np(np.random.default_rng(2), (DIN, DOUT), 0.02)
    jq = jquant.quantize_w8(jnp.asarray(w, jnp.bfloat16))
    tq = tquant.quantize_w8(torch.from_numpy(w).bfloat16())
    np.testing.assert_array_equal(tq["packed"].numpy(), np.asarray(jq["packed"]))
    np.testing.assert_array_equal(tq["scales"].view(torch.int16).numpy(),
                                  np.asarray(jq["scales"]).view(np.int16))


def test_dequantize_w8_bit_for_bit():
    jq = jquant.quantize_w8(jnp.asarray(_w(3)))
    want = np.asarray(jquant.dequantize(jq)).view(np.int16)
    t = _torch_tree({"packed": np.asarray(jq["packed"]), "scales": np.asarray(jq["scales"])})
    got = tquant.dequantize({**t, "group_size": 128, "bits": 8})
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 40])
def test_quantized_linear_w8_matches_jax(dtype, m):
    """The W8 branch (dequantize, then a plain product) with a bias; f32
    within 1e-5 (summation order), bf16 within 2^-7 of the largest output
    (one bf16 rounding step either side)."""
    rng = np.random.default_rng(4 + m)
    jq = jquant.quantize_w8(jnp.asarray(_w(5)))
    bias = (0.1 * rng.standard_normal(DOUT)).astype(np.float32)
    x = _bf16_np(rng, (2, m, DIN))
    jdt = getattr(jnp, dtype)
    jslot = {"packed": jq["packed"], "scales": jq["scales"], "bias": jnp.asarray(bias)}
    want = np.asarray(jquant.quantized_linear(jnp.asarray(x, jdt), jslot, jdt), np.float32)
    tslot = _torch_tree({k: np.asarray(v) for k, v in jslot.items()})
    got = tquant.quantized_linear(torch.from_numpy(x).to(getattr(torch, dtype)), tslot,
                                  getattr(torch, dtype))
    assert got.shape == (2, m, DOUT) and got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("m", [1, 3, 8, 24])
def test_one_digit_plain_matches_jax_decode_kernel(m):
    """K1's one-digit plain version, f32 in and out on bf16-exact inputs:
    the exact product within 1e-5 (f32 summation order); the JAX decode
    kernel at act_digits=1 (interpret mode) within 1e-4 (summation order)
    plus its reciprocal-rounded digits' steps; and the JAX package's
    one-digit bar of dequantize + matmul (0.06)."""
    rng = np.random.default_rng(10 + m)
    jq = jquant.quantize_w4(jnp.asarray(_w(6)))
    x = _bf16_np(rng, (m, DIN))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jq["packed"], jq["scales"],
                                              act_digits=1))
    t = _torch_tree({"packed": np.asarray(jq["packed"]), "scales": np.asarray(jq["scales"])})
    got = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"], t["scales"], act_digits=1)
    np.testing.assert_allclose(got.numpy(), _one_digit_exact(x, jq), rtol=1e-5, atol=1e-5)
    assert (np.abs(got.numpy() - want) <= 1e-4 + _reciprocal_allowance(x, jq)).all()
    ref = x @ np.asarray(jquant.dequantize(jq).astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0.06, atol=0.06)
    two = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"], t["scales"])
    # one digit (~7 bits) sits further from the dequantized product than two
    assert np.abs(got.numpy() - ref).max() > np.abs(two.numpy() - ref).max()


def test_jax_kernel_rounds_one_digit_through_a_reciprocal():
    """Pins the JAX reference's deviation the comparisons allow: on this
    draw a row's hi plane has two quotients x / s1 that round to another
    digit through x * (1 / s1), and there the JAX kernel's one-digit
    product leaves the exact one by about those digits' step while the
    port's holds it."""
    rng = np.random.default_rng(20)
    jq = jquant.quantize_w4(jnp.asarray(_w(7, (2, DIN, DOUT))))
    x = _bf16_np(rng, (5, DIN))
    allow = _reciprocal_allowance(x, jq, layer=1)[:, 0]
    assert (allow > 0).tolist() == [False, False, True, False, False]
    exact = _one_digit_exact(x, jq, layer=1)
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jq["packed"], jq["scales"],
                                              act_digits=1,
                                              layer_index=jnp.asarray(1, jnp.int32)))
    t = _torch_tree({"packed": np.asarray(jq["packed"]), "scales": np.asarray(jq["scales"])})
    got = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"], t["scales"], act_digits=1,
                                  layer_index=1).numpy()
    assert np.abs(want - exact).max(1)[2] > 1e-3 > np.abs(got - exact).max()


def test_one_digit_stacked_layer_and_quantized_linear():
    rng = np.random.default_rng(20)
    jq = jquant.quantize_w4(jnp.asarray(_w(7, (2, DIN, DOUT))))
    x = _bf16_np(rng, (5, DIN))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jq["packed"], jq["scales"],
                                              act_digits=1,
                                              layer_index=jnp.asarray(1, jnp.int32)))
    t = _torch_tree({"packed": np.asarray(jq["packed"]), "scales": np.asarray(jq["scales"])})
    got = tquant.w4_matmul_decode(torch.from_numpy(x), t["packed"], t["scales"], act_digits=1,
                                  layer_index=1)
    np.testing.assert_allclose(got.numpy(), _one_digit_exact(x, jq, layer=1), rtol=1e-5,
                               atol=1e-5)
    assert (np.abs(got.numpy() - want) <= 1e-4 + _reciprocal_allowance(x, jq, layer=1)).all()

    jflat = jquant.quantize_w4(jnp.asarray(_w(8)))
    want = np.asarray(jquant.quantized_linear(jnp.asarray(x, jnp.bfloat16), jflat,
                                              jnp.float32, act_digits=1))
    tf = _torch_tree({"packed": np.asarray(jflat["packed"]),
                      "scales": np.asarray(jflat["scales"])})
    got = tquant.quantized_linear(torch.from_numpy(x).bfloat16(), tf, torch.float32,
                                  act_digits=1)
    # both round K1's output to bf16 before the cast: one bf16 step apart at most
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("act_digits", [0, 3])
def test_other_digit_counts_raise(act_digits):
    t = tquant.quantize_w4(torch.from_numpy(_w(9)))
    x = torch.zeros((1, DIN), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act_digits"):
        tquant.w4_matmul_decode(x, t["packed"], t["scales"], act_digits=act_digits)


def test_one_digit_is_the_first_of_two_and_jax_s():
    """`_digits(x, 1)` is `_digits(x, 2)`'s first digit and scale, and the
    JAX package's `_int8_digits(x, 1)` bit for bit; the one-digit workspace
    of K1's wgmma form (`_w4_digits_ref(n_digits=1)`) is the first-digit
    slice of the two-digit one."""
    x = torch.from_numpy(_bf16_np(np.random.default_rng(30), (6, DIN // 2)))
    (q1, s1), = tquant._digits(x, 1)
    (q1b, s1b), _ = tquant._digits(x, 2)
    assert torch.equal(q1, q1b) and torch.equal(s1, s1b)
    (jq1, js1), = jquant._int8_digits(jnp.asarray(x.numpy()), 1)
    np.testing.assert_array_equal(q1.numpy(), np.asarray(jq1).astype(np.float32))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(js1))

    xf = torch.from_numpy(_bf16_np(np.random.default_rng(31), (5, DIN)))
    d1, sc1, g1 = tquant._w4_digits_ref(xf, n_digits=1)
    d2, sc2, g2 = tquant._w4_digits_ref(xf)
    assert d1.shape == (2, 1, 8, DIN // 2) and g1.shape == (DIN // 256, 1, 8)
    assert torch.equal(d1, d2[:, :1]) and torch.equal(sc1, sc2[..., :1])
    assert torch.equal(g1, g2[:, :1])
