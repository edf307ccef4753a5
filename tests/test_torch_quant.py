"""Parity of the port's W4 quantization and W4 matmuls (kernels K1, K2)
with the JAX package on the CPU.

The JAX side runs its Pallas kernels as its own tests do off a TPU (in
interpret mode); the port runs the plain PyTorch versions that its kernel
wrappers take for CPU tensors. Inputs are made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from vila_tpu.ops import quant as jquant
from vila_tpu_torch.ops import quant as tquant
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIN, DOUT = 512, 384


def _bf16_np(rng, shape, scale=1.0):
    """Random values exactly representable in bf16, as float32."""
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16).astype(np.float32)


def _w(seed, shape=(DIN, DOUT)):
    return (0.05 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32
    )


def _jax_q(w, **kw):
    q = jquant.quantize_w4(jnp.asarray(w), **kw)
    return np.asarray(q["packed"]), np.asarray(q["scales"])


def _torch_slot(packed, scales):
    tree = weights.from_jax_params(
        {"packed": packed, "scales": scales}, device="cpu"
    )
    return tree["packed"], tree["scales"]


@pytest.mark.parametrize("lead", [(), (3,)])
def test_quantize_w4_bytes_identical(lead):
    w = _w(0, lead + (DIN, DOUT))
    jp, js = _jax_q(w)
    tq = tquant.quantize_w4(torch.from_numpy(w))
    assert tq["bout"] == jquant.pick_bout(DIN, DOUT)
    np.testing.assert_array_equal(tq["packed"].numpy(), jp)
    np.testing.assert_array_equal(
        tq["scales"].view(torch.int16).numpy(), js.view(np.int16)
    )


def test_from_jax_params_round_trip_bit_exact():
    cfg_w = _w(1, (2, 256, 384))
    jp, js = _jax_q(cfg_w)
    tree = {
        "slot": {"packed": jp, "scales": js},
        "gamma": np.linspace(0.5, 1.5, 256, dtype=np.float32),
        "bf16": np.asarray(jnp.asarray(cfg_w[0, 0], jnp.bfloat16)),
    }
    t = weights.from_jax_params(tree, device="cpu")
    assert t["slot"]["packed"].dtype == torch.uint8
    assert t["slot"]["scales"].dtype == torch.bfloat16
    assert t["bf16"].dtype == torch.bfloat16
    back = weights.to_numpy_tree(t, ml_dtypes.bfloat16)
    np.testing.assert_array_equal(back["slot"]["packed"], jp)
    np.testing.assert_array_equal(
        back["slot"]["scales"].view(np.uint16), js.view(np.uint16)
    )
    np.testing.assert_array_equal(back["gamma"], tree["gamma"])
    np.testing.assert_array_equal(
        back["bf16"].view(np.uint16), tree["bf16"].view(np.uint16)
    )


def test_dequantize_matches():
    jp, js = _jax_q(_w(2))
    want = np.asarray(
        jquant.dequantize({"packed": jp, "scales": js}).astype(jnp.float32)
    )
    tp, ts = _torch_slot(jp, js)
    got = tquant.dequantize({"packed": tp, "scales": ts}).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("m", [1, 5, 32])
def test_k1_plain_matches_jax_decode_kernel(m):
    """K1's plain version == the JAX decode kernel (interpret mode), two
    int8 digits. Both run in f32 on bf16-exact inputs so the comparison
    sees the algorithm, not the output rounding; tolerance 1e-4 covers the
    f32 summation order over groups."""
    rng = np.random.default_rng(10 + m)
    jp, js = _jax_q(_w(3))
    x = _bf16_np(rng, (m, DIN))
    want = np.asarray(jquant.w4_matmul_decode(jnp.asarray(x), jp, js))
    tp, ts = _torch_slot(jp, js)
    got = tquant.w4_matmul_decode(torch.from_numpy(x), tp, ts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_k1_plain_matches_jax_stacked_layer_index():
    rng = np.random.default_rng(20)
    jp, js = _jax_q(_w(4, (3, DIN, DOUT)))
    x = _bf16_np(rng, (4, DIN))
    want = np.asarray(
        jquant.w4_matmul_decode(
            jnp.asarray(x), jp, js, layer_index=jnp.asarray(2, jnp.int32)
        )
    )
    tp, ts = _torch_slot(jp, js)
    got = tquant.w4_matmul_decode(
        torch.from_numpy(x), tp, ts, layer_index=2
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m", [40, 96])
def test_k2_plain_matches_jax_prefill_flat(m):
    """K2's plain version == the JAX prefill kernel, bf16 in and out;
    2e-3 covers one bf16 output rounding step flipping on a different f32
    summation order."""
    rng = np.random.default_rng(30 + m)
    jp, js = _jax_q(_w(5))
    x = _bf16_np(rng, (m, DIN))
    want = np.asarray(
        jquant.w4_matmul_prefill(jnp.asarray(x, jnp.bfloat16), jp, js)
    ).astype(np.float32)
    tp, ts = _torch_slot(jp, js)
    got = (
        tquant.w4_matmul_prefill(torch.from_numpy(x).bfloat16(), tp, ts)
        .float()
        .numpy()
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_k2_plain_matches_jax_prefill_stacked():
    rng = np.random.default_rng(40)
    jp, js = _jax_q(_w(6, (2, DIN, DOUT)))
    x = _bf16_np(rng, (48, DIN))
    want = np.asarray(
        jquant.w4_matmul_prefill(
            jnp.asarray(x, jnp.bfloat16), jp, js,
            layer_index=jnp.asarray(1, jnp.int32),
        )
    ).astype(np.float32)
    tp, ts = _torch_slot(jp, js)
    got = (
        tquant.w4_matmul_prefill(
            torch.from_numpy(x).bfloat16(), tp, ts, layer_index=1
        )
        .float()
        .numpy()
    )
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_w4_matmul_dispatch_by_rows():
    jp, js = _jax_q(_w(7))
    tp, ts = _torch_slot(jp, js)
    rng = np.random.default_rng(50)
    for m, ref in ((32, tquant._w4_gemv_ref), (33, tquant._w4_gemm_ref)):
        x = torch.from_numpy(_bf16_np(rng, (m, DIN))).bfloat16()
        torch.testing.assert_close(
            tquant.w4_matmul(x, tp, ts), ref(x, tp, ts), rtol=0, atol=0
        )


def test_quantize_llm_params_matches_jax():
    """Fused slots, GQA-padded o and the untied lm_head: same bytes."""
    from vila_tpu.models import qwen2 as jqwen2

    cfg = jqwen2.LLMConfig(
        vocab_size=384, hidden_size=256, intermediate_size=512,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        tie_word_embeddings=False,
    )
    params = jax.tree.map(
        np.asarray, jqwen2.init_params(jax.random.PRNGKey(0), cfg)
    )
    want = jax.tree.map(
        np.asarray, jquant.quantize_llm_params(params, fuse=True, cfg=cfg)
    )
    got = tquant.quantize_llm_params(
        weights.from_jax_params(params, device="cpu"), fuse=True, cfg=cfg
    )
    got = weights.to_numpy_tree(got, ml_dtypes.bfloat16)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert set(flat_g) == {p for p, _ in flat_w}
    for path, w in flat_w:
        np.testing.assert_array_equal(
            np.asarray(flat_g[path]).view(np.uint8),
            np.asarray(w).view(np.uint8),
            err_msg=str(path),
        )
