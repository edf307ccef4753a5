"""The port's NIAH harness (`vila_tpu_torch.eval.niah`, `niah_cli`)
against the JAX package's on the CPU: `splice_needle` bit for bit;
`forward_embeds_sharded`'s logits (float32, atol 2e-5 / rtol 1e-4, the JAX
package's own sharded-against-single bar, 2e-4 / 1e-3, tightened) on one
process and in gloo processes at world sizes 2 and 4 (ring sp 2 and 4,
zigzag); a `run_niah` grid equal to JAX's on the same mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_helpers as dh
from vila_tpu.eval import niah as jniah
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu_torch.eval import niah as tniah
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.utils import weights

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
CONTEXTS, DEPTHS = (64, 128), (0.0, 0.5, 1.0)


def cfg():
    return jqwen2.LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                            dtype="float32")


def params():
    return jax.tree.map(np.asarray, jqwen2.init_params(jax.random.PRNGKey(0), cfg()))


def inputs():
    rng = np.random.default_rng(1)
    embeds = rng.normal(size=(1, 64, 32)).astype(np.float32)
    haystack = rng.normal(size=(256, 32)).astype(np.float32)
    needle = rng.normal(size=(8, 32)).astype(np.float32)
    answers = rng.integers(0, 64, 4).astype(np.int64)
    return embeds, haystack, needle, answers


def jax_run(world):
    embeds, haystack, needle, answers = inputs()
    p = jax.tree.map(jnp.asarray, params())
    mesh = None if world == 1 else Mesh(np.array(jax.devices()[:world]), ("sp",))
    logits = jniah.forward_embeds_sharded(p, cfg(), jnp.asarray(embeds), mesh)
    grid = jniah.run_niah(p, cfg(), jnp.asarray(haystack), jnp.asarray(needle), answers,
                          jniah.NIAHConfig(context_lengths=CONTEXTS, depths=DEPTHS), mesh=mesh)
    return np.asarray(logits), grid


@pytest.fixture(scope="module")
def port():
    out = {}
    embeds, haystack, needle, answers = inputs()
    for world in (2, 4):
        call = ("niah_case", dict(mesh_axes=dict(sp=world), llm=dh.config_fields(cfg()),
                                  params=params(), embeds=embeds, haystack=haystack,
                                  needle=needle, answers=answers, contexts=CONTEXTS,
                                  depths=DEPTHS))
        ranks = dh.spawn([call], world)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[0][0], ranks[0][0][0])
            assert r[0][1] == ranks[0][0][1]
        out[world] = ranks[0][0]
    return out


def test_splice_needle_matches_jax():
    rng = np.random.default_rng(2)
    hs = rng.normal(size=(100, 8)).astype(np.float32)
    nd = rng.normal(size=(10, 8)).astype(np.float32)
    for depth in (0.0, 0.37, 0.5, 1.0):
        want, wpos = jniah.splice_needle(jnp.asarray(hs), jnp.asarray(nd), depth)
        got, pos = tniah.splice_needle(torch.as_tensor(hs), torch.as_tensor(nd), depth)
        assert pos == wpos
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_one_process_matches_jax():
    embeds, haystack, needle, answers = inputs()
    tp = weights.to_torch_tree(params(), torch.device("cpu"))
    tcfg = tqwen2.LLMConfig(**dh.config_fields(cfg()))
    logits = tniah.forward_embeds_sharded(tp, tcfg, torch.as_tensor(embeds), None)
    timings = []
    grid = tniah.run_niah(tp, tcfg, torch.as_tensor(haystack), torch.as_tensor(needle),
                          answers, tniah.NIAHConfig(context_lengths=CONTEXTS, depths=DEPTHS),
                          timings=timings)
    want_logits, want_grid = jax_run(1)
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGIT_TOL)
    assert grid == want_grid
    assert len(timings) == len(CONTEXTS) * len(DEPTHS)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_forward_and_grid_match_jax(world, port):
    logits, grid = port[world]
    want_logits, want_grid = jax_run(world)
    np.testing.assert_allclose(logits, want_logits, **LOGIT_TOL)
    assert grid == want_grid


def test_niah_cli_heatmap_is_optional(tmp_path):
    """`save_heatmap` returns False without matplotlib, as JAX's."""
    from vila_tpu_torch.eval import niah_cli

    ok = niah_cli.save_heatmap([{"context": 64, "depth": 0.0, "acc": 1.0}],
                               str(tmp_path / "h.png"))
    try:
        import matplotlib  # noqa: F401
        assert ok
    except ImportError:
        assert ok is False
