"""The port's QAT fake quantizers (`vila_tpu_torch.ops.fake_quant`) against
`vila_tpu/ops/fake_quant.py` on the CPU, numpy-drawn inputs: the
quantize-dequantize values and the straight-through gradient exactly, for
every format and scale layout; the simulated ops (`fq_linear`, `fq_gelu`,
`fq_silu_mul`, `fq_rms_norm`) within 1e-6 and `quantization_error` within
1e-6 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.ops import fake_quant as jfq
from vila_tpu_torch.ops import fake_quant as tfq


def _x(seed, shape=(6, 256)):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp(rng.normal(0.0, 1.5, shape[:-1] + (1,))).astype(np.float32)
    x[1] = 0.0  # a zero row: scale 1e-12
    return x


CASES = [("e4m3", 128, False), ("e4m3", 128, True), ("e5m2", 128, False),
         ("e5m2", 128, True), ("int8", 128, False), ("int8", 96, False),
         ("int4", 64, False), ("int4", 128, False)]


@pytest.mark.parametrize("fmt,group,per_tensor", CASES)
def test_fake_quant_values_and_straight_through_gradient_exact(fmt, group, per_tensor):
    """int groups of 64 and 128 divide 256; 96 does not (the whole row is
    one group, as in JAX)."""
    x = _x(0)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda v: jfq.fake_quant(v, fmt, group, per_tensor), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = tfq.fake_quant(xt, fmt, group, per_tensor)
    got.backward(torch.tensor(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), g)
    np.testing.assert_allclose(float(tfq.quantization_error(torch.tensor(x), fmt, group)),
                               float(jfq.quantization_error(jnp.asarray(x), fmt, group)),
                               rtol=1e-6)


@pytest.mark.parametrize("cfg", [
    dict(weight_fmt="int4", act_fmt="e4m3"),
    dict(weight_fmt="int8", act_fmt="e5m2", per_tensor=True, group_size=64),
    dict(weight_fmt=None, act_fmt=None),
])
def test_simulated_ops_match_jax(cfg):
    jcfg, tcfg = jfq.FakeQuantConfig(**cfg), tfq.FakeQuantConfig(**cfg)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 128)).astype(np.float32)
    up = rng.standard_normal((3, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, 64))).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    X, U, W, B, S = map(jnp.asarray, (x, up, w, b, s))
    tX, tU, tW, tB, tS = map(torch.tensor, (x, up, w, b, s))
    pairs = [
        (tfq.fq_linear(tX, tW, tcfg, tB), jfq.fq_linear(X, W, jcfg, B)),
        (tfq.fq_linear(tX, tW, tcfg), jfq.fq_linear(X, W, jcfg)),
        (tfq.fq_gelu(tX, tcfg), jfq.fq_gelu(X, jcfg)),
        (tfq.fq_silu_mul(tX, tU, tcfg), jfq.fq_silu_mul(X, U, jcfg)),
        (tfq.fq_rms_norm(tX, tS, tcfg), jfq.fq_rms_norm(X, S, jcfg)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
