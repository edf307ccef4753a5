"""The port's prompt-lookup speculative decoding
(`vila_tpu_torch/inference/speculative.py`, `GenerationEngine._spec_loop`)
against `vila_tpu/inference/speculative.py` on the CPU.

Both sides take the same parameters, drawn with numpy from a seed (or, at
the engine level, loaded from one checkpoint), and the same prefilled state.
The load-bearing property is greedy exactness: the speculative chunk emits
the vanilla greedy stream. Every case holds the port's chunk to the JAX
package's exactly (emitted ids, counts, cursor, positions, the final fill
and the `valid` mask: integers and booleans, no tolerance) and, in f32, to
the port's own one-token greedy loop. The W4 case runs the port's plain
K1/K2 versions against the JAX package's Pallas kernels in interpret mode,
as its own tests run them on the CPU.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_qwen2 import port_cfg  # noqa: E402
from vila_tpu.inference import speculative as jspec  # noqa: E402
from vila_tpu.models import qwen2 as jqwen2  # noqa: E402
from vila_tpu.ops import quant as jquant  # noqa: E402
from vila_tpu_torch.inference import speculative as tspec  # noqa: E402
from vila_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from vila_tpu_torch.utils import weights  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


def tiny_cfg(**kw):
    base = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, dtype="float32")
    base.update(kw)
    return jqwen2.LLMConfig(**base)


def draw_params(jcfg, seed, std=0.1):
    """The JAX tree drawn with numpy: norm scales near 1, the rest normal(std)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jqwen2.init_params(jax.random.PRNGKey(0), jcfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else std * x

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def repetitive_prompt(rng, vocab, n=24):
    """A prompt with a repeated motif so that the 2-gram lookup has material."""
    motif = rng.integers(2, vocab, 6)
    filler = rng.integers(2, vocab, n - 2 * len(motif))
    return np.concatenate([motif, filler, motif]).astype(np.int32)


class Pair:
    """One parameter set on both sides, each with its own cache."""

    def __init__(self, jcfg, p):
        self.jcfg, self.tcfg = jcfg, port_cfg(jcfg)
        self.jp = jax.tree.map(jnp.asarray, p)
        self.tp = weights.from_jax_params(p, device="cpu")

    def prefill(self, prompt, max_len):
        """Both sides' unpadded prefill: (first token, JAX cache, port cache)."""
        jc = jqwen2.init_cache(self.jcfg, batch=1, max_len=max_len)
        jl, jc = jqwen2.forward(self.jp, self.jcfg, input_ids=jnp.asarray(prompt[None]),
                                cache=jc)
        tc = tqwen2.init_cache(self.tcfg, batch=1, max_len=max_len, device="cpu")
        tl, tc = tqwen2.forward(self.tp, self.tcfg,
                                input_ids=torch.as_tensor(prompt[None]).long(), cache=tc)
        first = int(jnp.argmax(jl[0, -1]))
        assert int(tl[0, -1].argmax()) == first
        return first, jc, tc

    def spec(self, prompt, first, jc, tc, hist_len, max_out, gamma):
        """The same chunk on both sides: (JAX result, port result), each
        (out, out_len, cur, prev, pos, cache, hist, hlen, n_iters)."""
        jh, jhl = jspec.init_history(prompt, first, hist_len)
        th, thl = tspec.init_history(prompt, first, hist_len)
        np.testing.assert_array_equal(th, np.asarray(jh))
        assert thl == int(jhl)
        want = jspec.build_spec_decode(self.jcfg)(
            self.jp, jnp.asarray([first], jnp.int32), jnp.asarray([int(prompt[-1])], jnp.int32),
            jnp.asarray(len(prompt), jnp.int32), jc, jh, jhl, max_out=max_out, gamma=gamma)
        got = tspec.spec_chunk(self.tp, self.tcfg, [first], [int(prompt[-1])], len(prompt),
                               tc, th, thl, max_out=max_out, gamma=gamma)
        return want, got

    def port_vanilla(self, prompt, n, max_len):
        """The port's unpadded prefill and one-token greedy loop."""
        tc = tqwen2.init_cache(self.tcfg, batch=1, max_len=max_len, device="cpu")
        logits, tc = tqwen2.forward(self.tp, self.tcfg,
                                    input_ids=torch.as_tensor(prompt[None]).long(), cache=tc)
        toks = [int(logits[0, -1].argmax())]
        for _ in range(n - 1):
            logits, tc = tqwen2.forward(self.tp, self.tcfg,
                                        input_ids=torch.tensor([[toks[-1]]]), cache=tc)
            toks.append(int(logits[0, -1].argmax()))
        return toks


def assert_same_chunk(want, got):
    """Exact equality of two chunks' results (ids, counts, cursors, the
    cache's fill and valid mask, the live history)."""
    jout, jn, jcur, jprev, jpos, jcache, jhist, jhlen, jiters = want
    tout, tn, tcur, tprev, tpos, tcache, thist, thlen, titers = got
    assert tn == int(jn) and titers == int(jiters)
    np.testing.assert_array_equal(tout[:tn], np.asarray(jout)[:tn])
    np.testing.assert_array_equal(tcur, np.asarray(jcur))
    np.testing.assert_array_equal(tprev, np.asarray(jprev))
    assert tpos == int(jpos) and thlen == int(jhlen)
    np.testing.assert_array_equal(thist[:, :thlen], np.asarray(jhist)[:, :thlen])
    assert int(tcache["fill"]) == int(jcache["fill"])
    np.testing.assert_array_equal(tcache["valid"].numpy(), np.asarray(jcache["valid"]))


@pytest.mark.parametrize("gamma", [3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_chunk_matches_jax_and_vanilla_greedy(seed, gamma):
    jcfg = tiny_cfg()
    pair = Pair(jcfg, draw_params(jcfg, seed))
    prompt = repetitive_prompt(np.random.default_rng(seed), 128)
    n_new = 40
    max_len = len(prompt) + n_new + gamma + 2
    first, jc, tc = pair.prefill(prompt, max_len)
    want, got = pair.spec(prompt, first, jc, tc, max_len + 2 * gamma, n_new - 1, gamma)
    assert_same_chunk(want, got)
    out, n = got[0], got[1]
    assert n >= n_new - 1
    assert [first] + out[:n_new - 1].tolist() == pair.port_vanilla(prompt, n_new, max_len)
    # the cursor sits past the last accepted slot; nothing after it is valid
    assert int(got[5]["fill"]) == len(prompt) + n
    assert not got[5]["valid"][0, len(prompt) + n:].any()


def test_prompt_lookup_accepts_drafts():
    """Some seed verifies more than one token in a forward: random tiny
    models under greedy argmax enter short cycles, which prompt lookup then
    drafts correctly (JAX's `any_accepted`)."""
    jcfg = tiny_cfg()
    accepted = []
    for seed in range(3):
        pair = Pair(jcfg, draw_params(jcfg, seed))
        prompt = repetitive_prompt(np.random.default_rng(seed), 128)
        first, _, tc = pair.prefill(prompt, len(prompt) + 45)
        hist, hlen = tspec.init_history(prompt, first, len(prompt) + 60)
        _, n, *_, iters = tspec.spec_chunk(pair.tp, pair.tcfg, [first], [int(prompt[-1])],
                                           len(prompt), tc, hist, hlen, max_out=39, gamma=3)
        accepted.append(iters < n)
    assert any(accepted), "no seed ever accepted a draft"


def test_draft_takes_the_latest_match_and_skips_the_live_2gram():
    hist = np.zeros((1, 16), np.int32)
    hist[0, :10] = [5, 6, 1, 2, 5, 6, 3, 4, 5, 6]
    # (5, 6) occurs at 0 and 4 before the live one at 8: the latest wins
    np.testing.assert_array_equal(tspec.draft_tokens(hist, 10, 6, 5, 3), [3, 4, 5])
    # a 2-gram seen only live drafts zeros
    np.testing.assert_array_equal(tspec.draft_tokens(hist, 10, 4, 3, 2), [5, 6])
    np.testing.assert_array_equal(tspec.draft_tokens(hist, 10, 9, 9, 2), [0, 0])


def test_spec_then_vanilla_continuation():
    """A width-1 decode continuing from a speculative chunk matches pure
    greedy decoding, on both sides: the exit-time `valid` re-mask hides the
    rejected drafts' slots from later steps."""
    jcfg = tiny_cfg()
    pair = Pair(jcfg, draw_params(jcfg, 7))
    prompt = repetitive_prompt(np.random.default_rng(7), 128)
    gamma, n_spec, n_vanilla = 4, 8, 8
    max_len = len(prompt) + n_spec + n_vanilla + 2 * gamma + 4
    want_stream = pair.port_vanilla(prompt, 1 + n_spec + gamma + n_vanilla, max_len)
    first, jc, tc = pair.prefill(prompt, max_len)
    want, got = pair.spec(prompt, first, jc, tc, max_len + 2 * gamma, n_spec, gamma)
    assert_same_chunk(want, got)
    out, n, cur, _, pos, tc, *_ = got
    jcache, jcur, jpos = want[5], int(np.asarray(want[2])[0]), int(want[4])
    got_stream, jstream = [first] + out[:n].tolist(), [first] + out[:n].tolist()
    cur = int(cur[0])
    for _ in range(n_vanilla):
        logits, tc = tqwen2.forward(pair.tp, pair.tcfg, input_ids=torch.tensor([[cur]]),
                                    positions=torch.tensor([[pos]], dtype=torch.int32),
                                    cache=tc)
        cur = int(logits[0, -1].argmax())
        got_stream.append(cur)
        pos += 1
        jl, jcache = jqwen2.forward(pair.jp, pair.jcfg, input_ids=jnp.asarray([[jcur]]),
                                    positions=np.asarray([[jpos]], np.int32), cache=jcache)
        jcur = int(jnp.argmax(jl[0, -1]))
        jstream.append(jcur)
        jpos += 1
    assert got_stream == jstream == want_stream[:len(got_stream)]


def test_spec_respects_cache_capacity():
    """With fewer than gamma+1 free slots the loop stops, returning a short
    out_len, on both sides."""
    jcfg = tiny_cfg()
    pair = Pair(jcfg, draw_params(jcfg, 3))
    prompt = repetitive_prompt(np.random.default_rng(3), 128)
    gamma, budget = 3, 6
    max_len = len(prompt) + budget
    first, jc, tc = pair.prefill(prompt, max_len)
    want, got = pair.spec(prompt, first, jc, tc, max_len + 2 * gamma, 32, gamma)
    assert_same_chunk(want, got)
    out, n = got[0], got[1]
    assert n <= budget
    assert [first] + out[:n].tolist() == pair.port_vanilla(prompt, 1 + n, max_len)


@pytest.mark.parametrize("seed", [0, 1])
def test_w4_spec_chunk_matches_jax(seed):
    """A W4-quantized tiny LLM (D = 2 x group, fused qkv / gate_up slots,
    GQA-padded o, W4 lm_head): the verify forward at M = gamma+1 runs every
    projection through K1's plain version on the port and through the JAX
    decode kernel in interpret mode; ids, counts, cursor and mask equal."""
    jcfg = tiny_cfg(vocab_size=96, hidden_size=256, intermediate_size=512,
                    tie_word_embeddings=False)
    p = draw_params(jcfg, seed, std=0.05)
    p = jax.tree.map(np.asarray, jquant.quantize_llm_params(p, fuse=True, cfg=jcfg))
    pair = Pair(jcfg, p)
    calls = []
    real = tqwen2.w4_matmul_stacked_dispatch
    prompt = repetitive_prompt(np.random.default_rng(seed), 96, n=40)
    gamma, n_new = 4, 12
    max_len = len(prompt) + n_new + gamma + 2
    first, jc, tc = pair.prefill(prompt, max_len)
    try:
        tqwen2.w4_matmul_stacked_dispatch = (
            lambda x, *a, **k: calls.append(x.shape[0]) or real(x, *a, **k))
        want, got = pair.spec(prompt, first, jc, tc, max_len + 2 * gamma, n_new, gamma)
    finally:
        tqwen2.w4_matmul_stacked_dispatch = real
    assert_same_chunk(want, got)
    # every projection of every layer at M = gamma+1, each verify forward
    assert calls == [gamma + 1] * (4 * jcfg.num_hidden_layers * got[8])


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX and the port engine over one tiny checkpoint (f32)."""
    import helpers
    import vila_tpu
    from gen_goldens import FLAVORS
    from vila_tpu_torch import entry

    d = str(tmp_path_factory.mktemp("spec") / "base")
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    jengine, tengine = vila_tpu.load(d), entry.load(d, device="cpu")
    jengine.decode_chunk = tengine.decode_chunk = 3
    return jengine, tengine


PROMPT = ("the quick brown fox jumps over the lazy dog; the quick brown fox jumps "
          "over the lazy dog again and again")


@pytest.mark.parametrize("gamma", [2, 4])
def test_engine_lookup_gamma_equals_jax_and_vanilla(engines, gamma):
    """`stream_ids` with lookup_gamma: a prompt off its bucket (the cursor at
    the real length, RoPE positions from it), chunks of 3, the JAX
    engine's ids, and the port's vanilla ids."""
    from vila_tpu.inference.generate import GenerationConfig as JGC
    from vila_tpu_torch.inference.generate import GenerationConfig as TGC

    jengine, tengine = engines
    jin, tin = jengine.prepare_inputs(PROMPT), tengine.prepare_inputs(PROMPT)
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    assert tin["input_ids"].shape[0] not in (128, 192)  # off its bucket
    kw = dict(max_new_tokens=24, stop_token_ids=(-1,))
    base = tengine.generate_ids(tin, TGC(**kw))
    want = jengine.generate_ids(jin, JGC(lookup_gamma=gamma, **kw))
    got = tengine.generate_ids(tin, TGC(lookup_gamma=gamma, **kw))
    assert len(got) == 24
    assert got == want == base
    # a stop id inside the stream ends it there, on both sides
    stop = got[10]
    kw["stop_token_ids"] = (stop,)
    got = tengine.generate_ids(tin, TGC(lookup_gamma=gamma, **kw))
    assert got == jengine.generate_ids(jin, JGC(lookup_gamma=gamma, **kw))
    assert got == base[:base.index(stop)]
