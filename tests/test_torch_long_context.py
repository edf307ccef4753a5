"""The port's sequence-sharded long-context engine
(`vila_tpu_torch.inference.long_context`, `qwen2.forward`'s deferred
`cache_append` mode) against the JAX package's `LongContextEngine` on the
CPU: the port in gloo processes at world sizes 1, 2 and 4 (one spawn a
world size) against JAX's engine on a one-device mesh (the JAX package's
own tests hold its sharded engine to its single-device tokens). Greedy
tokens are compared exactly (float32); the cache append's shards bit for
bit against JAX's shard_map append on as many virtual devices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import torch_dist_helpers as dh
from vila_tpu.inference.long_context import LongContextEngine as JEngine
from vila_tpu.models import qwen2 as jqwen2


def cfg():
    return jqwen2.LLMConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=4,
                            num_key_value_heads=2, dtype="float32")


def params():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), cfg()))

    def one(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.08 * x

    return jax.tree_util.tree_map_with_path(one, shapes)


def embeds(s, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(scale=0.5, size=(1, s, 64)).astype(np.float32)


# (id, prompt length, seed, engine kwargs, generate kwargs)
RUNS = [
    ("unaligned-tail", 700, 0, dict(max_cache_len=2048, prefill_chunk=256),
     dict(max_new_tokens=12)),
    ("multichunk", 512, 1, dict(max_cache_len=1024, prefill_chunk=128),
     dict(max_new_tokens=8)),
    # 16 asked, 9 fit: the first comes from the prefill, 8 decode steps fill
    # rows 248..255; chunks of 8 straddle the shards
    ("capacity", 248, 2, dict(max_cache_len=256, prefill_chunk=128),
     dict(max_new_tokens=16, decode_chunk=8)),
]
WORLDS = (1, 2, 4)


@functools.lru_cache(maxsize=None)
def _jax_engine(ekw):
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    return JEngine(jax.tree.map(jnp.asarray, params()), cfg(), mesh, **dict(ekw))


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    _, s, seed, ekw, kw = next(r for r in RUNS if r[0] == name)
    eng = _jax_engine(tuple(sorted(ekw.items())))
    return eng.generate(jnp.asarray(embeds(s, seed)), **kw)


def _jax_tokens(run):
    return list(_jax_run(run[0]))


@pytest.fixture(scope="module")
def port():
    """Per world size: every run's tokens, then the stop-id runs, then the
    cache append; the results of rank 0 (all ranks return the same
    tokens)."""
    multi = RUNS[1]
    full = _jax_tokens(multi)
    stops = [dict(stop_ids=[full[1]]), dict(stop_ids=[full[0]])]
    out = {"full": full, "stops": stops}
    for world in WORLDS:
        runs = [(embeds(s, seed), ekw, gkw) for _, s, seed, ekw, gkw in RUNS]
        runs += [(embeds(multi[1], multi[2]), multi[3], dict(multi[4], **st)) for st in stops]
        calls = [("long_context", dict(mesh_axes=dict(sp=world), llm=dh.config_fields(cfg()),
                                       params=params(), runs=runs))]
        if world > 1:
            calls.append(("cache_append", dict(APPEND, mesh_axes=dict(sp=world))))
        ranks = dh.spawn(calls, world)
        for r in ranks[1:]:
            assert r[0] == ranks[0][0]
        out[world] = ranks
    return out


def _append_inputs():
    rng = np.random.default_rng(4)
    k_rows = rng.standard_normal((2, 1, 12, 32)).astype(np.float32)
    v_rows = rng.standard_normal((2, 1, 12, 32)).astype(np.float32)
    tv = np.ones((1, 12), bool)
    tv[0, 9:] = False  # a padded tail
    return k_rows, v_rows, tv


APPEND = dict(mesh_axes=None, llm=dh.config_fields(cfg()), max_len=64,
              k_rows=_append_inputs()[0], v_rows=_append_inputs()[1],
              token_valid=_append_inputs()[2], fill=26)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_tokens_match_jax(run, world, port):
    got = port[world][0][0][RUNS.index(run)]
    want = _jax_tokens(run)
    assert got == want
    if run[0] == "capacity":
        assert len(got) == 256 - 248 + 1


@pytest.mark.parametrize("world", WORLDS)
def test_stop_ids(world, port):
    """A stop id ends the output there and is never emitted; a first
    token that is a stop id gives nothing (JAX's semantics)."""
    full = port["full"]
    got = port[world][0][0][len(RUNS):]
    assert port[world][0][0][RUNS.index(RUNS[1])] == full
    assert got[0] == ([] if full[1] == full[0] else full[:1])
    assert got[1] == []


@pytest.mark.parametrize("world", [2, 4])
def test_cache_append_matches_jax(world, port):
    """Rows 26..37 (the last three padding) into a 64-slot cache split over
    the ranks: each shard is JAX's shard_map append's, bit for bit."""
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world), ("sp",))
    eng = JEngine(jax.tree.map(jnp.asarray, params()), cfg(), mesh, max_cache_len=64,
                  prefill_chunk=64)
    append = eng._make_cache_append()
    k_rows, v_rows, tv = _append_inputs()
    z = jnp.zeros((2, 1, 64, 32), jnp.float32)
    with mesh:
        want = append(z, z, jnp.zeros((1, 64), bool), jnp.asarray(k_rows), jnp.asarray(v_rows),
                      jnp.asarray(tv), jnp.asarray(26, jnp.int32))
    got = [np.concatenate([r[1][i] for r in port[world]], axis=2 if i < 2 else 1)
           for i in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
