"""Parity of the port's AWQ (`vila_tpu_torch/ops/awq.py`) with the JAX
package's (`vila_tpu/ops/awq.py`) on the CPU, mirroring `tests/test_awq.py`:
the scale search on the outlier case, the calibration walk, the fold's
invariance and the whole pipeline's W4 bytes.

The JAX walk draws its calibration rows with `jax.random.choice`, the
port's with a torch generator; with `sample_rows` >= B*S both keep every
row, in another order, and the comparisons undo each side's order.
Parameters are drawn by the JAX package and reach the port through
`from_jax_params`; other inputs are made with numpy from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.ops import awq as jawq
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.ops import awq as tawq
from vila_tpu_torch.ops import quant as tquant
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False


def tiny_cfg(**kw):
    d = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2, dtype="float32")
    d.update(kw)
    return jqwen2.LLMConfig(**d)


def _port_cfg(jcfg):
    return tqwen2.LLMConfig(**{f.name: getattr(jcfg, f.name)
                               for f in dataclasses.fields(tqwen2.LLMConfig)})


def _port(tree):
    return weights.from_jax_params(jax.tree.map(np.asarray, tree), device="cpu")


def _ids(seed, shape=(2, 16)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def test_search_matches_jax_on_outlier_channels():
    """The motivating case: 4 activation channels at 50x. The port's search
    picks the JAX package's grid point (its scales within 1e-5: pow, log
    and exp differ by an ulp between the two libraries; the loss within
    1e-4), and keeps the JAX test's claims: never worse than RTN, clearly
    better here, and the scales reproduce the loss."""
    rng = np.random.default_rng(0)
    din, dout, m = 256, 128, 64
    w = (0.05 * rng.standard_normal((din, dout))).astype(np.float32)
    x = rng.standard_normal((m, din)).astype(np.float32)
    x[:, :4] *= 50.0
    g = tawq.fit_group(din)
    assert g == jawq.fit_group(din)
    s_j, loss_j = jawq.search_awq_scales(jnp.asarray(w), jnp.asarray(x), group_size=g)
    s, loss, best, losses = tawq.search_awq_scales(torch.from_numpy(w), torch.from_numpy(x),
                                                   group_size=g, return_losses=True)
    assert losses.shape == (20,) and float(losses[best]) == float(loss)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-5)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-4)

    tw, tx = torch.from_numpy(w), torch.from_numpy(x)
    ref = tx @ tw
    rtn_loss = float(((tx @ tawq._rtn_dequant(tw, g) - ref) ** 2).sum())
    np.testing.assert_allclose(tawq._rtn_dequant(tw, g).numpy(),
                               np.asarray(jawq._rtn_dequant(jnp.asarray(w), g)), rtol=0, atol=0)
    assert float(loss) <= rtn_loss
    assert float(loss) < 0.7 * rtn_loss
    applied = float((((tx / s) @ tawq._rtn_dequant(tw * s[:, None], g) - ref) ** 2).sum())
    assert applied == pytest.approx(float(loss), rel=1e-5)


def test_stacked_search_matches_jax():
    """Per-layer search over a stack (the fit group of din 96 is 48): the
    port's scales are the JAX package's within 1e-5 (transcendental ulps)."""
    rng = np.random.default_rng(1)
    w = (0.05 * rng.standard_normal((3, 96, 64))).astype(np.float32)
    x = rng.standard_normal((3, 40, 96)).astype(np.float32)
    x[:, :, :3] *= 20.0
    want = np.asarray(jawq.search_awq_scales_stacked(jnp.asarray(w), jnp.asarray(x), n_grid=8))
    got = tawq.search_awq_scales_stacked(torch.from_numpy(w), torch.from_numpy(x), n_grid=8)
    assert got.shape == (3, 96) and tawq.fit_group(96) == jawq.fit_group(96) == 48
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_alpha_grid_is_jax_linspace():
    for n in (1, 6, 8, 12, 20):
        np.testing.assert_array_equal(tawq._alpha_grid(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_calibration_walk_matches_forward_and_jax():
    """The walk's final hidden state equals the port's
    `qwen2.forward(return_hidden=True)` (2e-5, as the JAX test), and every
    captured row equals JAX's (f32: 1e-4 relative, 1e-5 absolute), each
    side's row order undone."""
    jcfg = tiny_cfg()
    jp = jqwen2.init_params(jax.random.PRNGKey(1), jcfg)
    ids = _ids(2)
    cfg, params = _port_cfg(jcfg), _port(jp)
    stats = tawq.collect_act_stats(params, cfg, torch.from_numpy(ids).long())
    h_ref, _ = tqwen2.forward(params, cfg, input_ids=torch.from_numpy(ids).long(),
                              return_hidden=True)
    np.testing.assert_allclose(stats["hidden"].numpy(), h_ref.numpy(), rtol=2e-5, atol=2e-5)
    L, n = cfg.num_hidden_layers, ids.size
    assert stats["qkv"].shape == (L, n, cfg.hidden_size)
    assert stats["down"].shape == (L, n, cfg.intermediate_size)
    assert stats["o"].shape == (L, n, cfg.num_attention_heads * cfg.head_dim_)

    jstats = jawq.collect_act_stats(jp, jcfg, jnp.asarray(ids))
    t_idx = tawq.sample_row_indices(n, 128).numpy()
    j_idx = np.asarray(jax.random.choice(jax.random.PRNGKey(0), n, shape=(n,), replace=False))
    for fam in ("qkv", "o", "gate_up", "down"):
        got = np.empty_like(stats[fam].numpy())
        want = np.empty_like(got)
        got[:, t_idx] = stats[fam].numpy()
        want[:, j_idx] = np.asarray(jstats[fam])
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(stats["hidden"].numpy(), np.asarray(jstats["hidden"]),
                               rtol=1e-4, atol=1e-5)


def test_fold_is_forward_invariant():
    """apply_awq rescales in cancelling pairs: the unquantized model's
    logits are unchanged (f32, 1e-3 as the JAX test), the input tree is
    left as it was, and each layer's four searches are reported."""
    jcfg = tiny_cfg()
    cfg, params = _port_cfg(jcfg), _port(jqwen2.init_params(jax.random.PRNGKey(3), jcfg))
    ids = torch.from_numpy(_ids(4)).long()
    before = {k: v["kernel"].clone() for k, v in params["layers"].items() if "kernel" in v}
    stats = tawq.collect_act_stats(params, cfg, ids)
    searches = []
    folded = tawq.apply_awq(params, cfg, stats, n_grid=6, searches=searches)
    assert len(searches) == cfg.num_hidden_layers
    idx, loss = tawq.search_summary(searches)
    assert all(0 <= i < 6 for row in idx for i in row) and len(loss[0]) == 4
    for k, v in before.items():
        assert torch.equal(params["layers"][k]["kernel"], v)
    logits_ref, _ = tqwen2.forward(params, cfg, input_ids=ids)
    logits_awq, _ = tqwen2.forward(folded, cfg, input_ids=ids)
    np.testing.assert_allclose(logits_awq.numpy(), logits_ref.numpy(), rtol=1e-3, atol=1e-3)


def _outlier_params(jcfg, seed):
    """The JAX test's outlier model: a few embedding channels x30 and the
    matching q/k/v rows / 30 (the bf16 forward unchanged in distribution,
    RTN wastes its range on those channels)."""
    p = jqwen2.init_params(jax.random.PRNGKey(seed), jcfg)
    emb = p["embed_tokens"]["embedding"]
    p["embed_tokens"]["embedding"] = emb.at[:, :4].multiply(30.0)
    for n in ("q_proj", "k_proj", "v_proj"):
        kk = p["layers"][n]["kernel"]
        p["layers"][n]["kernel"] = kk.at[:, :4, :].multiply(1 / 30.0)
    return p


def test_awq_quantize_llm_bytes_match_jax():
    """The whole pipeline (calibrate, fold, quantize) with every row kept
    (`sample_rows` 128 >= B*S = 32) gives the JAX package's W4 bytes, slot
    for slot, and the JAX test's claim holds on the port: AWQ tracks the
    unquantized logits at least as well as RTN (5 %)."""
    jcfg = tiny_cfg()
    jp = _outlier_params(jcfg, 5)
    ids = _ids(6)
    jq = jawq.awq_quantize_llm(jp, jcfg, jnp.asarray(ids), n_grid=8)
    cfg, params = _port_cfg(jcfg), _port(jp)
    tq = tawq.awq_quantize_llm(params, cfg, torch.from_numpy(ids).long(), n_grid=8)
    assert "qkv_proj" in tq["layers"]
    for name in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        for key in ("packed", "scales"):
            got = tq["layers"][name][key]
            want = np.asarray(jq["layers"][name][key])
            if key == "scales":
                got, want = got.view(torch.int16), want.view(np.int16)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{name}.{key}")
    assert "lm_head" not in tq and "lm_head" not in jq  # tied embeddings
    # the folded norm scales (f32 here) carry the ulps by which the two
    # libraries' pow, log and exp differ
    for name in ("input_layernorm", "post_attention_layernorm"):
        np.testing.assert_allclose(tq["layers"][name]["scale"].numpy(),
                                   np.asarray(jq["layers"][name]["scale"]), rtol=1e-6, atol=0)

    t_ids = torch.from_numpy(ids).long()
    logits_ref, _ = tqwen2.forward(params, cfg, input_ids=t_ids)
    q_rtn = tquant.quantize_llm_params(params, cfg=cfg)
    logits_rtn, _ = tqwen2.forward(q_rtn, cfg, input_ids=t_ids)
    logits_awq, _ = tqwen2.forward(tq, cfg, input_ids=t_ids)
    err_rtn = float(((logits_rtn - logits_ref) ** 2).mean())
    err_awq = float(((logits_awq - logits_ref) ** 2).mean())
    assert err_awq <= err_rtn * 1.05, (err_awq, err_rtn)
    assert err_awq < float((logits_ref ** 2).mean())
