"""The port's MM-SP attention (`vila_tpu_torch.parallel.ring_attention`,
`parallel.sp`'s host layout) against the JAX package's on the CPU.

The port runs in gloo processes at world sizes 2 and 4 (one spawn a world
size, `torch_dist_helpers.spawn`, every case in it); JAX runs the same
mesh shape on the conftest's virtual CPU devices with impl="xla". Forward
outputs and the gradients of sum(out * cot) are compared shard by shard
in float32 (atol 3e-5, rtol 1e-4 on outputs as the JAX package's own ring
tests; 1e-4 / 1e-4 on gradients, summed over the ring steps). The ring's
step functions are also driven by list indexing for n virtual ranks in
one process, as `chip_smoke.py`'s `sp_ring` phase drives them on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

import torch_dist_helpers as dh
from vila_tpu.ops.attention import attention_xla
from vila_tpu.parallel import mesh as jmesh
from vila_tpu.parallel import ring_attention as jra
from vila_tpu.parallel import sp as jsp
from vila_tpu_torch.parallel import mesh as tmesh
from vila_tpu_torch.parallel import ring_attention as tra
from vila_tpu_torch.parallel import sp as tsp

OUT_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
S, D = 64, 16


def _inputs(hq, hkv, seed, b=2):
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.standard_normal((b, S, hq, D))).astype(np.float32)
    k = (0.3 * rng.standard_normal((b, S, hkv, D))).astype(np.float32)
    v = (0.3 * rng.standard_normal((b, S, hkv, D))).astype(np.float32)
    cot = rng.standard_normal((b, S, hq, D)).astype(np.float32)
    seg = np.ones((b, S), np.int32)
    seg[0, 23:] = 2
    seg[1, 10:41] = 2
    seg[1, 41:] = 3
    return q, k, v, cot, seg


# (id, world, mesh axes, kind, layout, hq, hkv, segments, port impl)
CASES = [
    ("ring2-contig", 2, dict(sp=2), "ring", "contiguous", 8, 4, False, "xla"),
    ("ring2-zigzag", 2, dict(sp=2), "ring", "zigzag", 8, 4, False, "xla"),
    ("ring2-zigzag-seg", 2, dict(sp=2), "ring", "zigzag", 8, 4, True, "xla"),
    ("ring2-zigzag-seg-flash", 2, dict(sp=2), "ring", "zigzag", 8, 2, True, "flash"),
    ("ulysses2-hkv1", 2, dict(su=2), "ulysses", "contiguous", 4, 1, True, "xla"),
    ("ulysses2-hkv2", 2, dict(su=2), "ulysses", "contiguous", 4, 2, False, "xla"),
    ("ring4-contig", 4, dict(sp=4), "ring", "contiguous", 8, 4, False, "xla"),
    ("ring4-zigzag", 4, dict(sp=4), "ring", "zigzag", 8, 4, False, "xla"),
    ("ring4-contig-seg", 4, dict(sp=4), "ring", "contiguous", 8, 2, True, "xla"),
    ("ring4-zigzag-seg", 4, dict(sp=4), "ring", "zigzag", 8, 2, True, "xla"),
    ("ulysses4-hkv1", 4, dict(su=4), "ulysses", "contiguous", 8, 1, False, "xla"),
    ("ulysses4-hkv2", 4, dict(su=4), "ulysses", "contiguous", 8, 2, True, "xla"),
    ("ulysses4-hkv4", 4, dict(su=4), "ulysses", "contiguous", 8, 4, False, "xla"),
    ("hybrid2x2-zigzag", 4, dict(sp=2, su=2), "hybrid", "zigzag", 8, 4, True, "xla"),
    ("hybrid2x2-contig-hkv1", 4, dict(sp=2, su=2), "hybrid", "contiguous", 8, 1, False, "xla"),
]


def _laid_out(case, seed):
    """The global inputs in the case's layout (zigzag: permuted as the
    JAX package's `zigzag_batch` permutes a batch)."""
    _, _, axes, kind, layout, hq, hkv, segs, _ = case
    q, k, v, cot, seg = _inputs(hq, hkv, seed)
    if layout == "zigzag":
        order = jra.zigzag_order(S, axes.get("sp", 1))
        q, k, v, cot, seg = (x[:, order] for x in (q, k, v, cot, seg))
    return q, k, v, cot, (seg if segs else None)


def _jax_run(case, seed):
    """JAX's out and gradients of sum(out * cot) on the same mesh shape."""
    _, world, axes, kind, layout, *_ = case
    q, k, v, cot, seg = _laid_out(case, seed)
    mesh = jmesh.make_mesh(**axes)
    seq = tuple(a for a in ("sp", "su") if axes.get(a, 1) > 1)
    spec = P(None, seq)

    def inner(q_, k_, v_, *s):
        s_ = s[0] if s else None
        kw = dict(causal=True, q_segment_ids=s_, kv_segment_ids=s_, impl="xla")
        if kind == "ring":
            return jra.ring_flash_attention(q_, k_, v_, "sp", layout=layout, **kw)
        if kind == "ulysses":
            return jra.ulysses_attention(q_, k_, v_, "su", **kw)
        return jra.hybrid_attention(q_, k_, v_, "su", "sp", ring_layout=layout, **kw)

    extra = () if seg is None else (jnp.asarray(seg),)
    fn = shard_map(inner, mesh=mesh, in_specs=(spec,) * (3 + len(extra)), out_specs=spec,
                   check_rep=False)

    @jax.jit
    def out_and_grads(q_, k_, v_):
        out, vjp = jax.vjp(lambda a, b_, c: fn(a, b_, c, *extra), q_, k_, v_)
        return (out,) + vjp(jnp.asarray(cot))

    return [np.asarray(x) for x in out_and_grads(*(jnp.asarray(x) for x in (q, k, v)))]


def _port_cases(world):
    return [(c, 7 + i) for i, c in enumerate(CASES) if c[1] == world]


@pytest.fixture(scope="module")
def port_results():
    """Every case's per-rank results, one spawn a world size."""
    out = {}
    for world in (2, 4):
        cases = _port_cases(world)
        calls = []
        for case, seed in cases:
            q, k, v, cot, seg = _laid_out(case, seed)
            calls.append(("attention", dict(mesh_axes=case[2], kind=case[3], q=q, k=k, v=v,
                                            cot=cot, seg=seg, layout=case[4], impl=case[8])))
        ranks = dh.spawn(calls, world)
        for i, (case, seed) in enumerate(cases):
            out[case[0]] = (seed, [r[i] for r in ranks])
    return out


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sp_attention_matches_jax(case, port_results):
    seed, ranks = port_results[case[0]]
    want = _jax_run(case, seed)
    # the sequence is split over the ranks in rank order (dp = 1)
    got = [np.concatenate([r[i] for r in ranks], axis=1) for i in range(4)]
    np.testing.assert_allclose(got[0], want[0], **OUT_TOL)
    for g, w, name in zip(got[1:], want[1:], ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("layout", ["contiguous", "zigzag"])
@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_virtual_ring_steps_match_jax(layout, impl):
    """`_ring_step_fwd` / `_merge` / `_ring_step_bwd` for 4 virtual ranks,
    the rotation by list indexing (the card's `sp_ring` phase), against
    JAX's attention over the whole sequence with packed segments."""
    n = 4
    q, k, v, cot, seg = _inputs(8, 2, 3)
    order = jra.zigzag_order(S, n) if layout == "zigzag" else np.arange(S)
    ref = attention_xla(*(jnp.asarray(x) for x in (q, k, v)), causal=True,
                        q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg))
    jgrads = jax.grad(lambda a, b_, c: (attention_xla(
        a, b_, c, causal=True, q_segment_ids=jnp.asarray(seg),
        kv_segment_ids=jnp.asarray(seg)) * cot).sum(), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))

    def shard(x, r):
        return torch.as_tensor(x[:, order][:, r * S // n:(r + 1) * S // n])

    qs, ks, vs, cs, ss = ([shard(x, r) for r in range(n)] for x in (q, k, v, cot, seg))
    kw = dict(causal=True, impl=impl, layout=layout)
    outs, lses = [], []
    for my in range(n):
        out = torch.zeros(qs[my].shape)
        lse = torch.full((2, 8, S // n), tra._NEG_INF)
        for step in range(n):
            src = (my - step) % n
            o, l = tra._ring_step_fwd(qs[my], ks[src], vs[src], ss[my], ss[src], src=src,
                                      my=my, **kw)
            out, lse = tra._merge(out, lse, o, l)
        outs.append(out)
        lses.append(lse)
    dq = [torch.zeros(x.shape) for x in qs]
    dk = [torch.zeros(x.shape) for x in ks]
    dv = [torch.zeros(x.shape) for x in vs]
    for my in range(n):
        delta = (cs[my] * outs[my]).sum(-1).transpose(1, 2)
        for src in range(n):
            a, b_, c = tra._ring_step_bwd(qs[my], ks[src], vs[src], cs[my], lses[my], delta,
                                          ss[my], ss[src], src=src, my=my, **kw)
            dq[my] += a
            dk[src] += b_
            dv[src] += c
    for got, want, tol in ((outs, ref, OUT_TOL), (dq, jgrads[0], GRAD_TOL),
                           (dk, jgrads[1], GRAD_TOL), (dv, jgrads[2], GRAD_TOL)):
        np.testing.assert_allclose(torch.cat(got, 1).numpy(), np.asarray(want)[:, order],
                                   **tol)


def test_fully_masked_rows_merge_to_nothing():
    """A step whose rows see no key (segments) returns LSE -1e30, and the
    merge ignores it: the merged result is the other step's, bit for bit."""
    q, k, v, _, _ = _inputs(4, 2, 5)
    qt, kt, vt = (torch.as_tensor(x[:, :16]) for x in (q, k, v))
    qs = torch.ones((2, 16), dtype=torch.int32)
    ks = torch.full((2, 16), 9, dtype=torch.int32)
    for impl in ("xla", "flash"):
        o, l = tra._local_attention_with_lse(qt, kt, vt, causal=False, q_segment_ids=qs,
                                             kv_segment_ids=ks, impl=impl)
        assert bool((l == tra._NEG_INF).all())
        o2, l2 = tra._local_attention_with_lse(qt, kt, vt, causal=True, impl=impl)
        merged, lse = tra._merge(o2.float(), l2, o.float(), l)
        assert torch.equal(merged, o2.float()) and torch.equal(lse, l2)


@pytest.mark.parametrize("hkv,target", [(1, 4), (2, 4), (4, 4)])
def test_expand_kv_heads_matches_jax(hkv, target):
    rng = np.random.default_rng(hkv)
    k = rng.standard_normal((1, 8, hkv, 4)).astype(np.float32)
    want = jra.expand_kv_heads(jnp.asarray(k), jnp.asarray(k), target)[0]
    got = tra.expand_kv_heads(torch.as_tensor(k), torch.as_tensor(k), target)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seq,n", [(16, 2), (64, 4), (48, 3), (64, 8)])
def test_zigzag_orders_match_jax(seq, n):
    np.testing.assert_array_equal(tra.zigzag_order(seq, n), jra.zigzag_order(seq, n))
    np.testing.assert_array_equal(tra.inverse_zigzag_order(seq, n),
                                  jra.inverse_zigzag_order(seq, n))


def test_shift_labels_matches_jax():
    labels = np.random.default_rng(0).integers(-100, 50, (3, 11)).astype(np.int32)
    np.testing.assert_array_equal(tsp.shift_labels(labels), jsp.shift_labels(labels))


@pytest.mark.parametrize("axes,layout,seq", [
    (dict(sp=2), "zigzag", 64), (dict(sp=4), "zigzag", 64), (dict(sp=2, su=2), "zigzag", 64),
    (dict(sp=4), "zigzag", 60), (dict(sp=2), "contiguous", 64)])
def test_zigzag_batch_and_unzigzag_match_jax(axes, layout, seq):
    """Every per-token array, the shifted labels and the remapped media
    positions (sentinels kept) bit for bit; `unzigzag_logits` undoes it."""
    rng = np.random.default_rng(seq)
    batch = {
        "input_ids": rng.integers(0, 90, (2, seq)).astype(np.int32),
        "labels": rng.integers(-100, 90, (2, seq)).astype(np.int32),
        "positions": np.tile(np.arange(seq, dtype=np.int32), (2, 1)),
        "segment_ids": np.repeat(np.arange(1, 5, dtype=np.int32), seq // 4)[None].repeat(2, 0),
        "media_positions": np.array([[3, 4, 5, seq], [seq - 1, 0, seq, seq]], np.int32),
    }
    want = jsp.zigzag_batch(batch, jsp.SPConfig(mesh=jmesh.make_mesh(**axes),
                                                ring_layout=layout))
    tplan = tsp.SPConfig(mesh=tmesh.Mesh.layout(**axes), ring_layout=layout)
    got = tsp.zigzag_batch(batch, tplan)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    logits = rng.standard_normal((2, seq, 5)).astype(np.float32)
    jplan = jsp.SPConfig(mesh=jmesh.make_mesh(**axes), ring_layout=layout)
    np.testing.assert_array_equal(
        tsp.unzigzag_logits(torch.as_tensor(logits), tplan).numpy(),
        np.asarray(jsp.unzigzag_logits(jnp.asarray(logits), jplan)))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_local_attention_matches_jax(causal):
    """The "xla" route over a KV length past its 4096 threshold walks KV
    chunks of 2048 with the LSE merge (a ragged last chunk, packed
    segments): out and LSE against JAX's `_chunked_attention_with_lse`."""
    rng = np.random.default_rng(11)
    s = 4608
    q = (0.3 * rng.standard_normal((1, s, 2, 8))).astype(np.float32)
    k = (0.3 * rng.standard_normal((1, s, 1, 8))).astype(np.float32)
    v = rng.standard_normal((1, s, 1, 8)).astype(np.float32)
    seg = np.ones((1, s), np.int32)
    seg[:, 3000:] = 2
    got = tra._local_attention_with_lse(*(torch.as_tensor(x) for x in (q, k, v)),
                                        causal=causal, q_segment_ids=torch.as_tensor(seg),
                                        kv_segment_ids=torch.as_tensor(seg), impl="xla")
    want = jra._chunked_attention_with_lse(*(jnp.asarray(x) for x in (q, k, v)), causal=causal,
                                           q_segment_ids=jnp.asarray(seg),
                                           kv_segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **OUT_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **OUT_TOL)
