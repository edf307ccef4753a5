"""Continuous batching in the port (`vila_tpu_torch`), on the CPU: per-slot
cache cursors and the two batched decode routes of `qwen2.forward` against
the JAX package, per-row sampling parameters, and the `ContinuousBatcher`
end to end against the port's serial engine and the JAX batcher.

Inputs are drawn with numpy from a seed and handed to both sides; W4 slots
come from the JAX quantizer (fused, GQA-padded o) and reach the port
through `from_jax_params`. The JAX side runs its Pallas kernels as its own
tests do off a TPU; the port runs the plain versions its kernel wrappers
take for CPU tensors.
"""

import concurrent.futures as cf
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from test_torch_qwen2 import _cfg, numpy_params, port_cfg
from vila_tpu.data.tokenizer_utils import add_media_tokens
from vila_tpu.inference import generate as jgen
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.ops import fused_decode as jfused
from vila_tpu.ops import quant as jquant
from vila_tpu.serving import batcher as jbatcher
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.ops import _build
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.serving import batcher as tbatcher
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

S = 64  # cache rows of the forward tests
# logits of a W4 decode step: bf16 activations into the W4 products and
# int8-digit rounding of each row, so the two packages agree to a few bf16
# ulps (the tolerance of tests/test_torch_qwen2.py)
W4_ATOL = 2e-2


@pytest.fixture(scope="module")
def w4_llm():
    """Tiny W4 LLM (2:1 GQA, group padded to 8): JAX config and params,
    port config and params."""
    jcfg = _cfg(hidden_size=256, num_attention_heads=4, num_key_value_heads=2)
    jq = jax.tree.map(np.asarray, jquant.quantize_llm_params(
        numpy_params(jcfg, 2), fuse=True, cfg=jcfg))
    tcfg = port_cfg(jcfg)
    return jcfg, jq, tcfg, weights.from_jax_params(jq, cfg=tcfg, device="cpu")


@pytest.fixture(scope="module")
def f32_llm():
    """Tiny unquantized f32 LLM: the per-op route on both sides."""
    jcfg = _cfg(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                intermediate_size=128)
    p = numpy_params(jcfg, 1)
    tcfg = port_cfg(jcfg)
    return jcfg, p, tcfg, weights.from_jax_params(p, device="cpu")


def _staggered_cache(jcfg, b, seed):
    """Random cache rows, each batch row valid up to its own cursor; row 0
    sits at S - 1 (its write lands in the cache's last slot)."""
    rng = np.random.default_rng(seed)
    kv = jcfg.num_key_value_heads * jcfg.head_dim_
    shape = (jcfg.num_hidden_layers, b, S, kv)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    fill = rng.integers(1, S - 1, b).astype(np.int32)
    fill[0] = S - 1
    valid = np.arange(S)[None] < fill[:, None]
    ids = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    return k, v, valid, fill, ids


def _port_cache(tcfg, k, v, valid, fill):
    c = tqwen2.init_cache(tcfg, k.shape[1], S, device="cpu", per_slot_fill=True)
    c["k"][:] = torch.as_tensor(k)
    c["v"][:] = torch.as_tensor(v)
    c["valid"][:] = torch.as_tensor(valid)
    c["fill"][:] = torch.as_tensor(fill)
    c["fill_host"][:] = fill
    return c


def _counting(monkeypatch, module, names):
    calls = {n: 0 for n in names}
    for n in names:
        real = getattr(module, n)

        def wrapped(*a, _n=n, _real=real, **k):
            calls[_n] += 1
            return _real(*a, **k)

        monkeypatch.setattr(module, n, wrapped)
    return calls


@pytest.mark.parametrize("b,route", [(3, "fused_layer_batched"), (20, "fused_o_gateup")])
def test_batched_decode_step_matches_jax(w4_llm, monkeypatch, b, route):
    """One decode step of a per-slot cache with staggered cursors: b = 3
    takes K6 (`fused_layer_batched`) and b = 20 K4/K5 on both sides; logits
    within W4_ATOL, the new cache rows within 1e-2 (their bf16 roundings),
    the same validity and cursors."""
    jcfg, jq, tcfg, tq = w4_llm
    k, v, valid, fill, ids = _staggered_cache(jcfg, b, seed=b)
    names = ["fused_layer", "fused_layer_batched", "fused_o_gateup"]
    jcalls = _counting(monkeypatch, jfused, names)
    tcalls = _counting(monkeypatch, tfused, names + ["fused_down_qkv"])
    jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "valid": jnp.asarray(valid),
              "fill": jnp.asarray(fill)}
    want, jnew = jqwen2.forward(jq, jcfg, input_ids=jnp.asarray(ids), cache=jcache)
    got, tnew = tqwen2.forward(tq, tcfg, input_ids=torch.as_tensor(ids),
                               cache=_port_cache(tcfg, k, v, valid, fill))
    # JAX traces its layer scan once; the port calls once per layer
    L = jcfg.num_hidden_layers
    assert jcalls[route] > 0 and sum(jcalls.values()) == jcalls[route]
    want_calls = {n: 0 for n in tcalls}
    want_calls[route] = L
    if route == "fused_o_gateup":
        want_calls["fused_down_qkv"] = L
    assert tcalls == want_calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=W4_ATOL, rtol=0)
    np.testing.assert_allclose(tnew["k"].numpy(), np.asarray(jnew["k"]), atol=1e-2, rtol=0)
    np.testing.assert_allclose(tnew["v"].numpy(), np.asarray(jnew["v"]), atol=1e-2, rtol=0)
    np.testing.assert_array_equal(tnew["valid"].numpy(), np.asarray(jnew["valid"]))
    np.testing.assert_array_equal(tnew["fill"].numpy(), np.asarray(jnew["fill"]))
    np.testing.assert_array_equal(tnew["fill_host"], np.asarray(jnew["fill"]))


@pytest.mark.parametrize("which", ["f32", "w4"])
def test_vector_cursor_matches_scalar(request, which):
    """The same cursor on every row: a vector-cursor forward equals the
    scalar one, for a prefill and then a decode step (W4: the K6 route with
    a shared or a per-row cursor)."""
    _, _, tcfg, tp = request.getfixturevalue(f"{which}_llm")
    b, s = 2, 4
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, tcfg.vocab_size, (b, s)))
    c_s = tqwen2.init_cache(tcfg, b, S, device="cpu")
    c_v = tqwen2.init_cache(tcfg, b, S, device="cpu", per_slot_fill=True)
    lg_s, c_s = tqwen2.forward(tp, tcfg, input_ids=ids, cache=c_s)
    lg_v, c_v = tqwen2.forward(tp, tcfg, input_ids=ids, cache=c_v)
    torch.testing.assert_close(lg_v, lg_s, rtol=2e-5, atol=2e-5)
    assert c_v["fill"].tolist() == [s, s] and list(c_v["fill_host"]) == [s, s]
    torch.testing.assert_close(c_v["k"], c_s["k"], rtol=0, atol=0)
    tok = torch.tensor([[3], [7]])
    lg_s2, _ = tqwen2.forward(tp, tcfg, input_ids=tok, cache=c_s)
    lg_v2, _ = tqwen2.forward(tp, tcfg, input_ids=tok, cache=c_v)
    torch.testing.assert_close(lg_v2, lg_s2, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("which", ["f32", "w4"])
def test_staggered_rows_match_separate_runs(request, monkeypatch, which):
    """Two rows at different depths decode like two bs=1 runs (greedy, 3
    steps). f32: the per-op route on both, equal logits to 1e-5; W4: K6
    against K3, the same digits per row, so logits within 1e-3 and equal
    tokens."""
    _, _, tcfg, tp = request.getfixturevalue(f"{which}_llm")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size, (1, n)) for n in (3, 6)]
    refs = []
    for p in prompts:
        c = tqwen2.init_cache(tcfg, 1, S, device="cpu")
        lg, c = tqwen2.forward(tp, tcfg, input_ids=torch.as_tensor(p), cache=c)
        steps = [lg[0, -1]]
        for i in range(3):
            lg, c = tqwen2.forward(
                tp, tcfg, input_ids=steps[-1].argmax().reshape(1, 1),
                positions=torch.tensor([[p.shape[1] + i]], dtype=torch.int32), cache=c)
            steps.append(lg[0, -1])
        refs.append(torch.stack(steps))

    calls = _counting(monkeypatch, tfused, ["fused_layer_batched"])
    batch = tqwen2.init_cache(tcfg, 2, S, device="cpu", per_slot_fill=True)
    first = []
    for i, p in enumerate(prompts):
        c1 = tqwen2.init_cache(tcfg, 1, S, device="cpu")
        lg, c1 = tqwen2.forward(tp, tcfg, input_ids=torch.as_tensor(p), cache=c1)
        first.append(lg[0, -1])
        batch["k"][:, i] = c1["k"][:, 0]
        batch["v"][:, i] = c1["v"][:, 0]
        batch["valid"][i] = c1["valid"][0]
        batch["fill"][i] = c1["fill"]
        batch["fill_host"][i] = c1["fill"]
    steps = [torch.stack(first)]
    pos = torch.tensor([[p.shape[1]] for p in prompts], dtype=torch.int32)
    for _ in range(3):
        lg, batch = tqwen2.forward(tp, tcfg, input_ids=steps[-1].argmax(-1)[:, None],
                                   positions=pos, cache=batch)
        pos = pos + 1
        steps.append(lg[:, 0])
    got = torch.stack(steps, 1)  # (2, 4, V)
    assert calls["fused_layer_batched"] == (3 * tcfg.num_hidden_layers if which == "w4" else 0)
    tol = 1e-5 if which == "f32" else 1e-3
    for row, ref in zip(got, refs):
        torch.testing.assert_close(row, ref, rtol=0, atol=tol)
        assert row.argmax(-1).tolist() == ref.argmax(-1).tolist()


@pytest.mark.parametrize("b", [3, 20])
def test_idle_slot_past_max_len_drops_its_write(w4_llm, b):
    """An idle slot whose cursor ran past the cache (the batcher decodes
    every slot) writes nothing, raises nothing, and still advances; the
    other rows are written as usual. b = 3 runs K6, b = 20 K4/K5."""
    _, _, tcfg, tq = w4_llm
    jcfg = w4_llm[0]
    k, v, valid, fill, ids = _staggered_cache(jcfg, b, seed=10 + b)
    fill[1] = S + 5  # idle, past the cache
    cache = _port_cache(tcfg, k, v, valid, fill)
    logits, new = tqwen2.forward(tq, tcfg, input_ids=torch.as_tensor(ids), cache=cache,
                                 token_valid=torch.tensor([[i != 1] for i in range(b)]))
    assert torch.isfinite(logits).all()
    np.testing.assert_array_equal(new["k"][:, 1].numpy(), k[:, 1])
    np.testing.assert_array_equal(new["valid"][1].numpy(), valid[1])
    assert new["fill_host"][1] == S + 6 and int(new["fill"][1]) == S + 6
    assert bool(new["valid"][0, S - 1]) and not np.array_equal(new["k"][:, 0, S - 1].numpy(),
                                                              k[:, 0, S - 1])


def test_sample_token_vector_params():
    """Per-row (B,) temperature / top_p / top_k: greedy rows (temperature
    0) equal JAX's greedy rows and the argmax exactly, top_k = 1 rows too;
    sampled rows stay in range."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((5, 300))).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 0.0, 1.3, 5.0], np.float32)
    top_ps = np.asarray([1.0, 0.9, 0.5, 1.0, 1.0], np.float32)
    top_ks = np.asarray([0, 5, 3, 0, 1], np.int32)
    want = np.asarray(jgen.sample_token(jnp.asarray(logits), jax.random.PRNGKey(0), True,
                                        temps, top_ps, top_ks))
    gen = torch.Generator().manual_seed(0)
    for args in ((temps, top_ps, top_ks),
                 tuple(torch.as_tensor(a) for a in (temps, top_ps, top_ks))):
        got = tgen.sample_token(torch.as_tensor(logits), gen, True, *args).numpy()
        for row in (0, 2, 4):
            assert got[row] == want[row] == logits[row].argmax()
        assert ((0 <= got) & (got < 300)).all()
    greedy = tgen.sample_token(torch.as_tensor(logits), gen, True, 0.0, 1.0, 0)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_launch_counts_are_thread_safe():
    """The serving loop and its admission thread both count launches: no
    increment is lost under a short switch interval."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    before = _build.LAUNCHES["w4_gemv"]
    try:
        threads = [threading.Thread(target=lambda: [_build.count("w4_gemv")
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert _build.LAUNCHES["w4_gemv"] - before == 16 * 2000


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_new_entry_points_never_fall_back(no_cuda, w4_llm):
    """Without CUDA the per-slot cache and the batcher default to the card
    and raise; K4, K5 and K6 given tensors off the CPU launch or raise,
    never take their plain versions."""
    _, _, tcfg, tq = w4_llm
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tqwen2.init_cache(tcfg, 2, 8, per_slot_fill=True)

    class CardEngine:
        cfg = tvlm.VLMConfig(llm=tcfg, vision=tsiglip.SigLIPConfig(),
                             projector=tproj.ProjectorConfig())
        tokenizer = None
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbatcher.ContinuousBatcher(CardEngine(), max_batch=2, max_len=8)

    lay = tq["layers"]
    slots = [lay[n] for n in ("o_proj", "gate_up_proj", "down_proj", "qkv_proj")]
    gpost, gin = lay["post_attention_layernorm"]["scale"], lay["input_layernorm"]["scale"]
    meta = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device="meta")  # noqa: E731
    hd, d = tcfg.head_dim_, tcfg.hidden_size
    with pytest.raises((ValueError, RuntimeError)):
        tfused.fused_layer_batched(
            meta(2, 16, hd), torch.zeros(2, 8), meta(2, d), 0, torch.zeros(2, 2, 8, 2 * hd),
            torch.zeros(2, 2, 8, 2 * hd), *slots, gpost, gin, hkv=2, hd=hd, fill=[1, 2])
    with pytest.raises((ValueError, RuntimeError)):
        tfused.fused_o_gateup(meta(20, 16 * hd), meta(20, d), 0, slots[0], slots[1], gpost)
    with pytest.raises((ValueError, RuntimeError)):
        tfused.fused_down_qkv(meta(20, 2 * tcfg.intermediate_size), meta(20, d), 0,
                              slots[2], slots[3], gin)


# ---------------------------------------------------------------------------
# the scheduler end to end
# ---------------------------------------------------------------------------

# Greedy transcripts of two implementations agree unless a step's top-2
# logits tie within one bf16 ulp of the W4 lm_head (tests/test_torch_engine.py);
# this draw has no such tie in any transcript below.
SEED = 2


def _same(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def tiny_vlm(seed=SEED):
    """(tokenizer, JAX VLMConfig, numpy params with a W4 LLM, port
    VLMConfig): the tiny checkpoint of tests/test_torch_engine.py."""
    tok = helpers.make_tiny_tokenizer()
    add_media_tokens(tok)
    llm = jqwen2.LLMConfig(vocab_size=len(tok), hidden_size=256, intermediate_size=512,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dtype="float32",
                           tie_word_embeddings=False)
    vis = jsiglip.SigLIPConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                               num_attention_heads=4, image_size=56, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=48,
                                 hidden_size=256)
    cfg = jvlm.VLMConfig(llm=llm, vision=vis, projector=proj)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.05 * x

    p = jax.tree_util.tree_map_with_path(draw, shapes)
    p["llm"] = jquant.quantize_llm_params(p["llm"], fuse=True, cfg=llm)
    p = jax.tree.map(np.asarray, p)
    tcfg = tvlm.VLMConfig(llm=_same(tqwen2.LLMConfig, llm),
                          vision=_same(tsiglip.SigLIPConfig, vis),
                          projector=_same(tproj.ProjectorConfig, proj))
    return tok, cfg, p, tcfg


@pytest.fixture(scope="module")
def engines():
    tok, cfg, p, tcfg = tiny_vlm()
    jengine = jgen.GenerationEngine(jax.tree.map(jnp.asarray, p), cfg, tok)
    tengine = tgen.GenerationEngine(weights.from_jax_params(p, cfg=tcfg, device="cpu"),
                                    tcfg, tok, device="cpu")
    return jengine, tengine


PROMPTS = ["hello world", "the quick brown fox", "abc"]
IMAGE = np.random.default_rng(1).integers(0, 256, (56, 56, 3), dtype=np.uint8)


def _concurrently(batcher, prompts, gc):
    try:
        with cf.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(batcher.generate_content, p, gc) for p in prompts]
            return [f.result(timeout=300) for f in futs]
    finally:
        batcher.shutdown()


def test_batcher_matches_serial_engine_and_jax_batcher(engines, monkeypatch):
    """Three concurrent greedy requests (one with an image) on two slots:
    the port's batcher gives the port's serial engine's transcripts and the
    JAX batcher's. Every decode step runs K6 (b = 2)."""
    jengine, tengine = engines
    prompts = [[IMAGE, PROMPTS[0]]] + PROMPTS[1:]
    gc = dict(max_new_tokens=6, do_sample=False)
    serial = [tengine.generate_content(list(p) if isinstance(p, list) else p,
                                       tgen.GenerationConfig(**gc)) for p in prompts]
    calls = _counting(monkeypatch, tfused, ["fused_layer_batched"])
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=256)
    got = _concurrently(tb, [list(p) if isinstance(p, list) else p for p in prompts],
                        tgen.GenerationConfig(**gc))
    assert got == serial
    assert calls["fused_layer_batched"] == 2 * tb.steps > 0
    jb = jbatcher.ContinuousBatcher(jengine, max_batch=2, max_len=256)
    want = _concurrently(jb, [list(p) if isinstance(p, list) else p for p in prompts],
                         jgen.GenerationConfig(**gc))
    assert got == want


def test_batcher_feeds_each_token_at_its_own_position(engines):
    """After admission a slot is fed its first sampled token at that
    token's own RoPE position (the prompt length), as the serial engine
    does. The JAX batcher feeds it one position later (`_emit` has already
    advanced `position`); on the second prompt its greedy transcript then
    departs from the serial engine's at the second token, while the port's
    batcher keeps the serial transcript (the port's serial engine is held
    against the JAX one in tests/test_torch_engine.py)."""
    _, tengine = engines
    prompts = ["alpha beta", "delta epsilon zeta"]
    gc = tgen.GenerationConfig(max_new_tokens=5, do_sample=False)
    serial = [tengine.generate_content(p, gc) for p in prompts]
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=256)
    assert _concurrently(tb, prompts, gc) == serial


def test_batcher_chunked_prefill_matches_serial(engines):
    """A prompt of 129-256 tokens prefills in two 128-token chunks on the
    admission worker; the transcript equals the serial engine's, and a
    short prompt in the same batcher takes the single-shot path."""
    _, tengine = engines
    gc = tgen.GenerationConfig(max_new_tokens=5, do_sample=False)
    prompt = "word " * 40
    n = tengine.prepare_inputs(prompt)["input_ids"].shape[0]
    assert 128 < n <= 256, n
    serial = tengine.generate_content(prompt, gc)
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=512, prefill_chunk=128)
    try:
        got = tb.generate_content(prompt, gc)
        short = tb.generate_content("hi there", gc)
    finally:
        tb.shutdown()
    assert got == serial
    assert short == tengine.generate_content("hi there", gc)


def test_batcher_mixed_sampling_streaming_and_errors(engines):
    """Greedy and sampled requests share steps (greedy ones keep the serial
    transcript); the text stream joins to the blocking text; an overlong
    prompt is reported to its caller."""
    _, tengine = engines
    configs = [tgen.GenerationConfig(max_new_tokens=4, do_sample=False),
               tgen.GenerationConfig(max_new_tokens=3, do_sample=True, temperature=0.9,
                                     top_p=0.9, top_k=5),
               tgen.GenerationConfig(max_new_tokens=5, do_sample=False),
               tgen.GenerationConfig(max_new_tokens=2, do_sample=True, temperature=1.3)]
    prompts = ["alpha beta", "gamma", "delta epsilon zeta", "eta"]
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=256)
    try:
        with cf.ThreadPoolExecutor(4) as ex:
            futs = [ex.submit(tb.generate_content, p, g) for p, g in zip(prompts, configs)]
            got = [f.result(timeout=300) for f in futs]
        deltas = list(tb.generate_content_stream("stream me", configs[0]))
        with pytest.raises(ValueError, match="exceeds batcher max_len"):
            list(tb.stream_ids("word " * 100, configs[0]))
    finally:
        tb.shutdown()
    for i in (0, 2):
        assert got[i] == tengine.generate_content(prompts[i], configs[i])
    assert all(isinstance(t, str) for t in got)
    assert "".join(deltas).strip() == tengine.generate_content("stream me", configs[0])


def test_batcher_single_slot_reuse_runs_k3(engines, monkeypatch):
    """max_batch=1: each step takes the bs=1 route (K3) with the slot's own
    cursor, and the slot is reused by the next request; transcripts equal
    the serial engine's. (The JAX package cannot trace this case on W4
    weights: its K3 route takes only a scalar cursor.)"""
    _, tengine = engines
    gcs = [tgen.GenerationConfig(max_new_tokens=3, do_sample=False),
           tgen.GenerationConfig(max_new_tokens=5, do_sample=False)]
    prompts = ["one two three", "four five"]
    calls = _counting(monkeypatch, tfused, ["fused_layer", "fused_layer_batched"])
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=1, max_len=256)
    try:
        got = [tb.generate_content(p, g) for p, g in zip(prompts, gcs)]
    finally:
        tb.shutdown()
    assert calls == {"fused_layer": 2 * tb.steps, "fused_layer_batched": 0}
    assert got == [tengine.generate_content(p, g) for p, g in zip(prompts, gcs)]


def test_batcher_reports_a_failed_step(engines, monkeypatch):
    """A decode step that raises fails every request in flight with that
    error, and the batcher refuses later requests instead of hanging."""
    _, tengine = engines
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=256)

    def broken(active):
        raise RuntimeError("injected step failure")

    monkeypatch.setattr(tb, "_step", broken)
    try:
        with pytest.raises(RuntimeError, match="injected step failure"):
            tb.generate_content("alpha", tgen.GenerationConfig(max_new_tokens=4))
        with pytest.raises(RuntimeError, match="decode loop failed"):
            tb.submit("beta")
    finally:
        tb.shutdown()
