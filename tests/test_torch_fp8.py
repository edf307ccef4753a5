"""The port's fp8 training stack (`vila_tpu_torch.ops.fp8`,
`train/fp8_adamw.py`, `LLMConfig.fp8_matmul`, `optimizer="fp8_adamw"`)
against `vila_tpu/ops/fp8.py` and `vila_tpu/train/fp8_adamw.py` on the CPU,
with numpy-drawn inputs.

* Quantizer bytes (as uint8) and scales bit for bit against the JAX
  functions run op by op. Jitted, XLA divides amax by FP8_MAX through a
  reciprocal: only the group scales it rounds one ulp away from the IEEE
  quotient (and the bytes they move) differ; one test counts them.
* The cast past fp8's range gives JAX's bytes (`to_fp8`), where PyTorch's
  own cast saturates E4M3 and writes another E5M2 NaN.
* `fp8_linear` / `fp8_linear_grouped` forward and both gradients, the
  activation ops and a whole fp8 `train_step` within stated tolerances;
  the fp8 AdamW moments' bytes equal over 5 steps; a `Trainer` on
  `fp8_adamw` resumes to the uninterrupted run's losses.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vila_tpu.ops import fp8 as jfp8
from vila_tpu.train import fp8_adamw as jadamw
from vila_tpu.train import optimizer as jopt
from vila_tpu.train.step import train_step as jtrain_step
from vila_tpu_torch.ops import fp8 as tfp8
from vila_tpu_torch.train import fp8_adamw as tadamw
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train.step import batch_to_device, make_train_step, train_step
from vila_tpu_torch.utils import weights

from test_torch_train import _draw, _packed_batch, _same, _tiny_cfg, tvlm, tqwen2, tsiglip, tproj

DTYPES = {"e4m3": (jnp.float8_e4m3fn, tfp8.E4M3), "e5m2": (jnp.float8_e5m2, tfp8.E5M2)}


def _lognormal_rows(rng, shape):
    """Rows of standard normals scaled by lognormal row factors."""
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.exp(rng.normal(0.0, 2.0, shape[:-1] + (1,))).astype(np.float32)


def _bytes(q):
    return np.asarray(q).view(np.uint8) if not isinstance(q, torch.Tensor) else \
        q.view(torch.uint8).numpy()


def _quantize_both(kind, x, fmt):
    jd, td = DTYPES[fmt]
    xt = torch.as_tensor(x)
    if kind == "blockwise":
        jq, js, _ = jfp8.quantize_blockwise(jnp.asarray(x), jd, 128)
        tq, ts, _ = tfp8.quantize_blockwise(xt, td, 128)
    elif kind == "tensor":
        jq, js = jfp8.quantize_tensor(jnp.asarray(x), jd)
        tq, ts = tfp8.quantize_tensor(xt, td)
    elif kind == "grouped":
        jq, js = jfp8.quantize_grouped(jnp.asarray(x), jd)
        tq, ts = tfp8.quantize_grouped(xt, td)
    else:
        jq, js = jfp8.quantize_block2d(jnp.asarray(x), jd)
        tq, ts = tfp8.quantize_block2d(xt, td)
    return (jq, js), (tq, ts)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("kind", ["blockwise", "tensor", "grouped", "block2d"])
def test_quantizers_bit_exact_against_jax_op_by_op(kind, fmt):
    """Ragged shapes (zero padding in the last block, group and tile),
    lognormal row scales and an exact-zero row (scale 1e-12)."""
    rng = np.random.default_rng(0)
    x = _lognormal_rows(rng, (70, 300))
    x[3] = 0.0
    (jq, js), (tq, ts) = _quantize_both(kind, x, fmt)
    assert tq.dtype == DTYPES[fmt][1] and tq.shape == jq.shape
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = {"blockwise": lambda q, s: tfp8.dequantize_blockwise(q, s, x.shape),
           "tensor": lambda q, s: q.float() * s,
           "grouped": lambda q, s: tfp8.dequantize_grouped(q, s, x.shape[-1]),
           "block2d": lambda q, s: tfp8.dequantize_block2d(q, s, *x.shape)}[kind]
    jdeq = {"blockwise": lambda q, s: jfp8.dequantize_blockwise(q, s, x.shape),
            "tensor": lambda q, s: q.astype(jnp.float32) * s,
            "grouped": lambda q, s: jfp8.dequantize_grouped(q, s, x.shape[-1]),
            "block2d": lambda q, s: jfp8.dequantize_block2d(q, s, *x.shape)}[kind]
    np.testing.assert_array_equal(deq(tq, ts).numpy(), np.asarray(jdeq(jq, js)))


def test_jitted_jax_rounds_group_scales_through_a_reciprocal():
    """Under `jax.jit` XLA turns amax / 448 into amax * (1/448): on a
    seeded 2048 x 1536 draw with lognormal row scales, the group scales it
    rounds one ulp away from the IEEE quotient are exactly those equal to
    the reciprocal product; the port (IEEE on every device) equals the op
    by op run, and every byte it differs from the jitted one in lies in a
    group whose scale moved."""
    rng = np.random.default_rng(1)
    x = _lognormal_rows(rng, (2048, 1536))
    jq, js = jax.jit(jfp8.quantize_grouped)(jnp.asarray(x))
    tq, ts = tfp8.quantize_grouped(torch.as_tensor(x))
    amax = np.abs(x.reshape(2048, -1, 128)).max(-1)
    ieee = np.maximum(amax / np.float32(448.0), np.float32(1e-12))
    recip = np.maximum(amax * (np.float32(1.0) / np.float32(448.0)), np.float32(1e-12))
    np.testing.assert_array_equal(ts.numpy(), ieee)
    moved = np.asarray(js) != ts.numpy()
    assert moved.sum() > 1000  # thousands of the 24576 scales
    np.testing.assert_array_equal(np.asarray(js)[moved], recip[moved])
    np.testing.assert_array_equal(np.asarray(js)[~moved], ieee[~moved])
    diff = (_bytes(jq) != _bytes(tq)).any(-1)
    assert (diff <= moved).all()
    # one scale for the whole tensor: the jitted quotient happens to agree
    jq1, js1 = jax.jit(jfp8.quantize_tensor)(jnp.asarray(x))
    tq1, ts1 = tfp8.quantize_tensor(torch.as_tensor(x))
    assert float(js1) == float(ts1)
    np.testing.assert_array_equal(_bytes(jq1), _bytes(tq1))


EDGE = np.array([500.0, 1e6, -7e4, np.nan, -np.nan, 464.0, 470.0, -np.inf, 61440.0],
                np.float32)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_fp8_cast_past_the_range_gives_jax_bytes(fmt):
    """PyTorch's own CPU cast saturates E4M3 (500 -> 448, byte 126, where
    JAX gives NaN, 127) and writes E5M2's NaN as 127 (JAX: 126);
    `to_fp8` gives JAX's bytes in both formats, sign bit included."""
    jd, td = DTYPES[fmt]
    want = np.asarray(jnp.asarray(EDGE).astype(jd)).view(np.uint8)
    got = tfp8.to_fp8(torch.as_tensor(EDGE), td).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    own = torch.as_tensor(EDGE).to(td).view(torch.uint8).numpy()
    if fmt == "e4m3":
        np.testing.assert_array_equal(want[:3], [127, 127, 255])
        np.testing.assert_array_equal(own[:3], [126, 126, 254])
    else:
        assert want[3] == 126 and own[3] == 127
    # a quantizer meets the edge only through an inf or NaN input
    x = np.ones((2, 128), np.float32)
    x[0, 5] = np.inf
    (jq, js), (tq, ts) = _quantize_both("grouped", x, fmt)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("grouped", [False, True])
def test_fp8_linear_forward_and_gradients_match_jax(grouped):
    """x (2, 40, 200) @ w (200, 136): leading dims contracted in dw, ragged
    groups and tiles; forward, dx and dw within 1e-5 of max |JAX|."""
    rng = np.random.default_rng(2)
    x = _lognormal_rows(rng, (2, 40, 200))
    w = (0.05 * rng.standard_normal((200, 136))).astype(np.float32)
    g = rng.standard_normal((2, 40, 136)).astype(np.float32)
    jfn = jfp8.fp8_linear_grouped if grouped else jfp8.fp8_linear
    tfn = tfp8.fp8_linear_grouped if grouped else tfp8.fp8_linear
    y, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    yt = tfn(xt, wt)
    yt.backward(torch.as_tensor(g))
    for got, want in ((yt.detach(), y), (xt.grad, jdx), (wt.grad, jdw)):
        assert got.shape == want.shape
        assert _rel(got.numpy(), want) <= 1e-5


def test_fp8_linear_keeps_the_compute_dtype():
    """bf16 operands: bf16 output and gradients (the products' f32 sums
    rounded once); the plain route is the CPU's."""
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((16, 64)), dtype=torch.bfloat16, requires_grad=True)
    w = torch.tensor(0.1 * rng.standard_normal((64, 32)), dtype=torch.bfloat16,
                     requires_grad=True)
    for fn in (tfp8.fp8_linear, tfp8.fp8_linear_grouped):
        x.grad = w.grad = None
        y = fn(x, w)
        y.float().sum().backward()
        assert y.dtype == x.grad.dtype == w.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("op", ["gelu", "silu_mul", "rms_norm"])
def test_fp8_activation_ops_match_jax(op):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5, 200)).astype(np.float32)
    b = rng.standard_normal((3, 5, 200)).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(200)).astype(np.float32)
    g = rng.standard_normal((3, 5, 200)).astype(np.float32)
    if op == "gelu":
        jf, tf, args = jfp8.fp8_gelu, tfp8.fp8_gelu, (a,)
    elif op == "silu_mul":
        jf, tf, args = jfp8.fp8_silu_mul, tfp8.fp8_silu_mul, (a, b)
    else:
        jf, tf, args = (lambda x, sc: jfp8.fp8_rms_norm(x, sc, 1e-6),
                        lambda x, sc: tfp8.fp8_rms_norm(x, sc, 1e-6), (a, s))
    y, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    jgrads = vjp(jnp.asarray(g))
    ts = [torch.tensor(v, requires_grad=True) for v in args]
    yt = tf(*ts)
    yt.backward(torch.as_tensor(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)
    for t, want in zip(ts, jgrads):
        assert _rel(t.grad.numpy(), want) <= 1e-6


# --------------------------------------------------------------------------
# fp8 AdamW
# --------------------------------------------------------------------------


def test_fp8_adamw_moments_and_updates_match_jax_over_five_steps():
    """Leaves of 300, 7 x 5 and 128 elements (ragged blocks), weight decay,
    5 steps: the moments' fp8 bytes and scales bit for bit, the parameters
    within 1e-6 of max |JAX|; the functional `scale_by_fp8_adam` gives the
    same moments and steps."""
    rng = np.random.default_rng(5)
    shapes = [(300,), (7, 5), (128,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[_lognormal_rows(rng, s).astype(np.float32) for s in shapes] for _ in range(5)]
    tx = jadamw.fp8_adamw(1e-2, weight_decay=0.1)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p) for p in params]
    opt = tadamw.fp8_adamw(tp, 1e-2, weight_decay=0.1)
    sx = tadamw.scale_by_fp8_adam()
    jsx = jadamw.scale_by_fp8_adam()
    fstate, jfstate = sx.init(tp), jsx.init(jp)
    for gs in grads:
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, g in zip(tp, gs):
            t.grad = torch.tensor(g)
        opt.step()
        fsteps, fstate = sx.update([torch.tensor(g) for g in gs], fstate)
        jfsteps, jfstate = jsx.update([jnp.asarray(g) for g in gs], jfstate)
        for a, b in zip(fsteps, jfsteps):
            assert _rel(a.numpy(), b) <= 1e-6
    inner = state[0]
    assert int(inner.count) == fstate.count == 5
    for i, t in enumerate(tp):
        st = opt.state[t]
        for key, jm, fm in (("mu", inner.mu[i], fstate.mu[i]),
                            ("nu", inner.nu[i], fstate.nu[i])):
            np.testing.assert_array_equal(_bytes(st[key]), _bytes(jm.q))
            np.testing.assert_array_equal(st[key + "_scale"].numpy(), np.asarray(jm.scale))
            np.testing.assert_array_equal(_bytes(fm.q), _bytes(jm.q))
        assert st["mu"].dtype == tfp8.E4M3 and st["nu"].dtype == tfp8.E5M2
        assert _rel(t.numpy(), jp[i]) <= 1e-6


def test_component_optimizer_fp8_adamw_matches_optax():
    """`OptimizerConfig(optimizer="fp8_adamw")`: per-component learning
    rates, clipping, a frozen tower and the warmup schedule around the fp8
    moments, three steps against JAX's `make_optimizer`."""
    cfg = jopt.OptimizerConfig(learning_rate=1e-2, mm_projector_lr=3e-2, weight_decay=0.1,
                               warmup_ratio=0.2, total_steps=5, optimizer="fp8_adamw",
                               tune_vision_tower=False)
    rng = np.random.default_rng(6)
    shapes = {"llm": {"a": (4, 64), "b": (5,)}, "vision_tower": {"w": (3, 3)},
              "mm_projector": {"p": (2, 130)}}
    draw = lambda: {c: {k: (0.5 * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
                        for k, s in v.items()} for c, v in shapes.items()}
    params, grads = draw(), [draw() for _ in range(3)]
    opt = jopt.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)
    for g in grads:
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
    tp = weights.to_torch_tree(params, torch.device("cpu"))
    topt_ = topt.make_optimizer(_same(topt.OptimizerConfig, cfg))
    tstate = topt_.init(tp)
    for g in grads:
        for t, gv in zip(topt.leaves(tp), topt.leaves(weights.to_torch_tree(
                g, torch.device("cpu")))):
            t.grad = gv
        tstate = topt_.update(tstate, tp)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                                 topt.leaves(tp)):
        assert _rel(got.numpy(), want) <= 1e-6, jax.tree_util.keystr(path)
    np.testing.assert_array_equal(tp["vision_tower"]["w"].numpy(),
                                  params["vision_tower"]["w"])
    assert isinstance(tstate.adamw["llm"], tadamw.FP8AdamW)


# --------------------------------------------------------------------------
# the fp8 route through the model
# --------------------------------------------------------------------------


def test_llm_config_takes_the_fp8_routes():
    for v in (False, True, "tensor", "group"):
        assert tqwen2.LLMConfig(fp8_matmul=v).fp8_matmul == v
    with pytest.raises(ValueError, match="fp8_matmul"):
        tqwen2.LLMConfig(fp8_matmul="row")
    with pytest.raises(ValueError, match="optimizer"):
        topt.make_optimizer(topt.OptimizerConfig(optimizer="lion")).init(
            {"llm": {"w": torch.zeros(2)}, "vision_tower": {"w": torch.zeros(2)},
             "mm_projector": {"w": torch.zeros(2)}})


def _fp8_cfg(fp8, remat=False):
    cfg = _tiny_cfg(remat)
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, fp8_matmul=fp8))


def _tcfg(cfg):
    return tvlm.VLMConfig(llm=_same(tqwen2.LLMConfig, cfg.llm),
                          vision=_same(tsiglip.SigLIPConfig, cfg.vision),
                          projector=_same(tproj.ProjectorConfig, cfg.projector))


@pytest.mark.parametrize("fp8", [True, "group"])
def test_fp8_train_step_matches_jax(fp8):
    """One `train_step` of the tiny VLM (images, packed rows) with every
    decoder projection in fp8 and `fp8_adamw`, against JAX's (jitted):
    loss within 1e-5, grad norm within 1e-4. The updated tree: a gradient
    element whose f32 value lands one ulp across an fp8 rounding boundary
    moves by a whole fp8 step (E5M2 keeps 2 mantissa bits), and Adam's
    first update (about lr * sign(g)) of such a small element can then move
    by up to 2 lr; so every element must lie within 2 lr of JAX's and
    99.9 % of them within `test_torch_train.py`'s tolerance."""
    cfg = _fp8_cfg(fp8)
    params = _draw(cfg, 3)
    batch = _packed_batch(cfg, 4)
    lr = {"llm": 1e-3, "vision_tower": 2e-4, "mm_projector": 1e-3}
    ocfg = jopt.OptimizerConfig(learning_rate=lr["llm"], vision_tower_lr=lr["vision_tower"],
                                schedule="constant", warmup_ratio=0.0, max_grad_norm=0.5,
                                weight_decay=0.01, optimizer="fp8_adamw")
    jopt_ = jopt.make_optimizer(ocfg)
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(functools.partial(jtrain_step, cfg=cfg, optimizer=jopt_))
    jp2, _, jm = step(jp, jopt_.init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tcfg = _tcfg(cfg)
    topt_ = topt.make_optimizer(_same(topt.OptimizerConfig, ocfg))
    _, tp, tstate = make_train_step(tcfg, weights.from_jax_params(params, device="cpu"), topt_)
    tp, tstate, tm = train_step(tp, tstate, batch_to_device(batch, torch.device("cpu")),
                                cfg=tcfg, optimizer=topt_)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    n_off = n_all = 0
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp2)[0],
                                 topt.leaves(tp)):
        got, want = got.detach().numpy(), np.asarray(want)
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr[path[0].key] * (1 + 1e-3), jax.tree_util.keystr(path)
        n_off += int((diff > 1e-5 + 1e-4 * np.abs(want)).sum())
        n_all += diff.size
    assert n_off <= 1e-3 * n_all, (n_off, n_all)


def test_trainer_on_fp8_adamw_resumes_exactly(tmp_path):
    """A `Trainer` with `optimizer="fp8_adamw"` and fp8 matmuls: 4 steps
    with a checkpoint at 2; a fresh `Trainer` resumed from step 2 (the fp8
    moments' bytes and scales restored) repeats steps 3-4 exactly."""
    from vila_tpu_torch.data.collate import PackingCollator
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    cfg = _tcfg(_fp8_cfg("group"))
    params = _draw(_fp8_cfg("group"), 7)
    rng = np.random.default_rng(8)
    examples = []
    for _ in range(12):
        n = int(rng.integers(8, 18))
        ids = rng.integers(3, 90, n).astype(np.int32)
        examples.append({"input_ids": ids, "labels": ids.copy(),
                         "tiles": np.zeros((0, 56, 56, 3), np.uint8),
                         "media_positions": np.zeros((0,), np.int32)})
    coll = PackingCollator(seq_len=40, rows=1, tile_size=56)

    def run(out, steps, resume):
        args = TrainArgs(output_dir=str(out), max_steps=steps, per_device_batch_size=2,
                         seq_len=40, logging_steps=1, save_steps=2, optimizer="fp8_adamw",
                         learning_rate=1e-2, warmup_ratio=0.0, lr_schedule="constant",
                         resume=resume)
        tr = Trainer(cfg, weights.from_jax_params(params, device="cpu"), examples, coll,
                     args, device="cpu")
        return tr, [h["loss"] for h in tr.train()["log_history"]]

    _, full = run(tmp_path / "a", 4, False)
    run(tmp_path / "b", 2, False)
    tr, resumed = run(tmp_path / "b", 4, True)
    assert tr.start_step == 2
    st = tr.opt_state.adamw["llm"].state
    assert any(v["mu"].dtype == tfp8.E4M3 for v in st.values())
    assert resumed == full[2:]
