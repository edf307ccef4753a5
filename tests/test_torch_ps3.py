"""The port's PS3 tower (`vila_tpu_torch.models.ps3`) and `vlm`'s PS3
encode against `vila_tpu/models/ps3.py` on the CPU, in f32, with numpy-drawn
parameters handed to both sides: `forward` at `num_look_close` 0, 1 and 2,
with and without a top-down prompt, under `gt_selection_maps` teacher
forcing and with `smooth_selection_prob`: selection maps equal, the
selected tokens in JAX's order (features at 1e-5 of their largest value:
a token out of order would move a whole row), probabilities at 1e-5; the
top-k's order among tied scores (`jax.lax.top_k`: lower index first) on a
score tensor built to hold ties and on a tower whose scores all tie; the
helpers (`_upsample_grid`, `_area_resize`, `selection_logits`) and
`PS3Config.from_hf_config`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.models import projector as jproj
from vila_tpu.models import ps3 as jps3
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import ps3 as tps3
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False

RTOL = 1e-5  # f32 on both sides, sums in another order
PROMPT_DIM = 24


def _cfgs(nlc=1, k=5, scales=(28, 56, 112), prompt_dim=PROMPT_DIM):
    vit = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
               num_attention_heads=2, image_size=scales[0], patch_size=14)
    kw = dict(s3_scales=scales, num_hires_select=k, num_look_close=nlc,
              prompt_dim=prompt_dim)
    return (jps3.PS3Config(vit=jsiglip.SigLIPConfig(**vit), **kw),
            tps3.PS3Config(vit=tsiglip.SigLIPConfig(**vit), **kw))


def ps3_params(cfg, seed, flat_head=False):
    """JAX-layout PS3 tree of numpy f32 arrays (trunk, scale embeddings,
    heads), norms and biases drawn; `flat_head` zeroes the saliency kernel,
    so that every bottom-up score ties."""
    shapes = jax.eval_shape(lambda: jps3.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if "scale'" in key and "scale_embedding" not in key:
            return 1.0 + 0.1 * x
        if "select_head" in key and "kernel" in key:
            return 0.0 * x if flat_head else 0.3 * x
        return 0.05 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pixels(cfg, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8) for s in cfg.s3_scales]


def _run(nlc, prompt=False, gt=False, smooth=False, seed=0, flat_head=False, n=2):
    jcfg, tcfg = _cfgs(nlc=nlc)
    p = ps3_params(jcfg, seed, flat_head)
    px = _pixels(jcfg, seed + 1, n)
    kw, jkw, tkw = {}, {}, {}
    if prompt:
        pr = np.random.default_rng(seed + 2).standard_normal((n, PROMPT_DIM)).astype(np.float32)
        jkw["prompt"], tkw["prompt"] = jnp.asarray(pr), torch.as_tensor(pr)
    if gt:
        g = jcfg.hi_grid(1)
        maps = np.zeros((n, g, g), np.float32)
        maps[:, 1, 2] = maps[:, 3, 0] = maps[:, g - 1, g - 1] = 1.0
        jkw["gt_selection_maps"], tkw["gt_selection_maps"] = (jnp.asarray(maps),
                                                              torch.as_tensor(maps))
    kw.update(num_look_close=nlc, smooth_selection_prob=smooth)
    want = jps3.forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(px[0]),
                        [jnp.asarray(x) for x in px[1:]], **kw, **jkw)
    got = tps3.forward(weights.from_jax_params(p, device="cpu"), tcfg,
                       torch.as_tensor(px[0]), [torch.as_tensor(x) for x in px[1:]],
                       **kw, **tkw)
    return got, want, jcfg


def _assert_same(got, want):
    (gf, gp, gm), (wf, wp, wm) = got, want
    wf = np.asarray(wf)
    assert gf.shape == wf.shape
    np.testing.assert_allclose(gf.numpy(), wf, rtol=0, atol=RTOL * np.abs(wf).max())
    assert len(gp) == len(wp) and len(gm) == len(wm)
    for a, b in zip(gp, wp):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=RTOL)
    for a, b in zip(gm, wm):
        assert a.dtype == torch.bool
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("nlc", [0, 1, 2])
@pytest.mark.parametrize("prompt", [False, True])
def test_forward_matches_jax(nlc, prompt):
    got, want, cfg = _run(nlc, prompt=prompt)
    _assert_same(got, want)
    feats, _, maps = got
    if nlc == 0:
        assert feats.shape == (2, cfg.low_grid ** 2, 32)
        assert not any(bool(m.any()) for m in maps)
    else:
        assert feats.shape == (2, cfg.low_grid ** 2 + 2 * 5 * nlc, 32)
        assert [int(m.sum()) for m in maps] == [2 * 5 * nlc] * 2


@pytest.mark.parametrize("prompt", [False, True])
def test_teacher_forced_selection_matches_jax(prompt):
    got, want, cfg = _run(1, prompt=prompt, gt=True, seed=3)
    _assert_same(got, want)
    g = cfg.hi_grid(1)
    marked = np.zeros((g, g), bool)
    marked[1, 2] = marked[3, 0] = marked[g - 1, g - 1] = True
    assert (got[2][0][0].numpy() >= marked).all()  # every marked patch selected


@pytest.mark.parametrize("nlc", [1, 2])
def test_smooth_selection_prob_matches_jax(nlc):
    _assert_same(*_run(nlc, prompt=True, smooth=True, seed=4)[:2])


def test_all_scores_tied_selects_in_index_order():
    """A flat saliency head and no prompt: every score of a scale ties, so
    JAX's top-k takes the first K indices, and so must the port."""
    got, want, cfg = _run(1, seed=5, flat_head=True)
    _assert_same(got, want)
    for i, m in enumerate(got[2]):
        flat = m.reshape(2, -1).numpy()
        assert (flat[:, :5].all() and not flat[:, 5:].any()), i


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_k_order_with_ties_matches_jax(seed):
    """Scores built to hold ties (four levels over 64 entries, and runs of
    equal values as an upsampled grid makes them): indices equal to
    `jax.lax.top_k`'s, in order."""
    rng = np.random.default_rng(seed)
    levels = (rng.integers(0, 4, (3, 64)) / 4.0).astype(np.float32)
    grid = np.repeat(np.repeat(rng.standard_normal((3, 4, 4)), 2, 1), 2, 2)
    for score in (levels, grid.reshape(3, 64).astype(np.float32)):
        for k in (1, 7, 16, 64):
            _, want = jax.lax.top_k(jnp.asarray(score), k)
            got = tps3.top_k_indices(torch.as_tensor(score), k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("g_from,g_to", [(2, 4), (3, 9), (4, 4)])
def test_upsample_grid_matches_jax(g_from, g_to):
    x = np.random.default_rng(g_to).standard_normal((2, g_from ** 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tps3._upsample_grid(torch.as_tensor(x), g_from, g_to).numpy(),
        np.asarray(jps3._upsample_grid(jnp.asarray(x), g_from, g_to)))


@pytest.mark.parametrize("hw,out", [((8, 8), (4, 4)), ((4, 4), (8, 8)), ((6, 6), (6, 6)),
                                    ((8, 4), (2, 2))])
def test_area_resize_matches_jax(hw, out):
    x = np.random.default_rng(sum(hw)).random((2,) + hw).astype(np.float32)
    np.testing.assert_allclose(tps3._area_resize(torch.as_tensor(x), *out).numpy(),
                               np.asarray(jps3._area_resize(jnp.asarray(x), *out)),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="non-integer"):
        tps3._area_resize(torch.as_tensor(x), 3, 5)


@pytest.mark.parametrize("prompt", [False, True])
def test_selection_logits_match_jax(prompt):
    jcfg, tcfg = _cfgs()
    p = ps3_params(jcfg, 6)
    low = np.random.default_rng(7).standard_normal((2, 4, 32)).astype(np.float32)
    pr = np.random.default_rng(8).standard_normal((2, PROMPT_DIM)).astype(np.float32)
    want = np.asarray(jps3.selection_logits(jax.tree.map(jnp.asarray, p), jcfg,
                                            jnp.asarray(low), 8,
                                            jnp.asarray(pr) if prompt else None))
    got = tps3.selection_logits(weights.from_jax_params(p, device="cpu"), tcfg,
                                torch.as_tensor(low), 8,
                                torch.as_tensor(pr) if prompt else None).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("hf", [
    {},
    {"vision_config": {"width": 1152, "layers": 27, "heads": 16, "patch_size": 14,
                       "ps3_scales": [378, 756, 1512], "num_hires_select": 64}},
    {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
     "num_attention_heads": 4, "patch_size": 14, "ps3_scales": [56, 112],
     "num_hires_select": 4, "num_look_close": 2},
])
def test_config_from_hf_matches_jax(hf):
    want = jps3.PS3Config.from_hf_config(dict(hf), dtype="bfloat16", prompt_dim=64)
    got = tps3.PS3Config.from_hf_config(dict(hf), dtype="bfloat16", prompt_dim=64)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.low_grid, got.k_per_scale, got.n_output_tokens, got.image_size) == (
        want.low_grid, want.k_per_scale, want.n_output_tokens, want.image_size)


def test_init_params_has_jax_structure():
    jcfg, tcfg = _cfgs()
    want = jax.eval_shape(lambda: jps3.init_params(jax.random.PRNGKey(0), jcfg))
    got = tps3.init_params(torch.Generator().manual_seed(0), tcfg)
    shapes = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)  # noqa: E731
                        for k, v in jax.tree_util.tree_flatten_with_path(t)[0]}
    assert shapes(got) == shapes(want)


def _vlm_cfgs(nlc=1):
    jcfg, tcfg = _cfgs(nlc=nlc, prompt_dim=64)
    llm = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2)
    proj = dict(projector_type="mlp2x_gelu", mm_hidden_size=32, hidden_size=64)
    j = jvlm.VLMConfig(llm=jqwen2.LLMConfig(**llm), vision=jcfg,
                       projector=jproj.ProjectorConfig(**proj), vision_tower_type="ps3")
    t = tvlm.VLMConfig(llm=tqwen2.LLMConfig(**llm), vision=tcfg,
                       projector=tproj.ProjectorConfig(**proj), vision_tower_type="ps3")
    return j, t


def test_vlm_tokens_and_encode_images_ps3_match_jax():
    jcfg, tcfg = _vlm_cfgs()
    assert tcfg.tokens_per_image == jcfg.tokens_per_image == 4 + 2 * 5
    assert tcfg.ps3_tokens_low == jcfg.ps3_tokens_low == 4
    assert tcfg.ps3_look_close_mode == jcfg.ps3_look_close_mode == "after_image"
    assert tvlm.vision_module(tcfg) is tps3
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(9)
    p = jax.tree.map(lambda s: (0.05 * rng.standard_normal(s.shape)).astype(np.float32),
                     shapes)
    px = _pixels(jcfg.vision, 10, 1)
    pr = rng.standard_normal((1, 64)).astype(np.float32)
    want = jvlm.encode_images_ps3(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(px[0]),
                                  [jnp.asarray(x) for x in px[1:]], prompt=jnp.asarray(pr))
    got = tvlm.encode_images_ps3(weights.from_jax_params(p, cfg=tcfg, device="cpu"), tcfg,
                                 torch.as_tensor(px[0]),
                                 [torch.as_tensor(x) for x in px[1:]],
                                 prompt=torch.as_tensor(pr))
    _assert_same(got, want)
    assert got[0].shape == (1, tcfg.tokens_per_image, 64)
    with pytest.raises(ValueError, match="encode_images_ps3"):
        tvlm.encode_images(weights.from_jax_params(p, device="cpu"), tcfg,
                           torch.as_tensor(px[0]))
    with pytest.raises(NotImplementedError, match="forward_batch_ps3"):  # PS3 training
        tvlm.forward_batch({}, tcfg, {"input_ids": torch.zeros((1, 8), dtype=torch.long)})
    with pytest.raises(AssertionError, match="non-downsampling"):
        dataclasses.replace(tcfg, projector=dataclasses.replace(
            tcfg.projector, projector_type="mlp_downsample")).tokens_per_image


# --------------------------------------------------------------------------
# the generation engine: PS3's two-pass and one-pass serving
# --------------------------------------------------------------------------

NEW_TOKENS = 8
# the pass-1 hidden state through the W4 LLM: bf16 activations into the W4
# products, so the two packages agree to a few bf16 ulps of its largest
# value (one ulp of max|ref| is 2^-8 of it)
W4_RTOL = 2.0 ** -6


@pytest.fixture(scope="module")
def ps3_engines():
    """A tiny VILA-HD: W4 LLM (fused slots, untied W4 lm_head, quantized by
    the JAX package), a PS3 tower (scales 28 / 56 / 112, K = 5, top-down
    head as wide as the LLM), an mlp2x_gelu projector; one numpy draw
    handed to both packages, and one byte-level tokenizer. Returns a
    function of the look-close mode giving (JAX engine, port engine)."""
    import helpers
    from vila_tpu.data.tokenizer_utils import add_media_tokens
    from vila_tpu.inference import generate as jgen
    from vila_tpu.ops import quant as jquant
    from vila_tpu_torch.inference import generate as tgen

    tok = helpers.make_tiny_tokenizer()
    add_media_tokens(tok)
    llm = dict(vocab_size=len(tok), hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
               tie_word_embeddings=False)
    proj = dict(projector_type="mlp2x_gelu", mm_hidden_size=32, hidden_size=256)
    jvis, tvis = _cfgs(prompt_dim=256)
    jcfg = jvlm.VLMConfig(llm=jqwen2.LLMConfig(**llm), vision=jvis,
                          projector=jproj.ProjectorConfig(**proj), vision_tower_type="ps3")
    tcfg = tvlm.VLMConfig(llm=tqwen2.LLMConfig(**llm), vision=tvis,
                          projector=tproj.ProjectorConfig(**proj), vision_tower_type="ps3")
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(11)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if "scale'" in key and "scale_embedding" not in key:
            return 1.0 + 0.1 * x
        # the top-down term outweighs the bottom-up one: the prompt steers
        return (0.3 if "top_down_prompt_head" in key else 0.05) * x

    p = jax.tree_util.tree_map_with_path(draw, shapes)
    p["llm"] = jquant.quantize_llm_params(p["llm"], fuse=True, cfg=jcfg.llm)
    p = jax.tree.map(np.asarray, p)
    jp = jax.tree.map(jnp.asarray, p)
    tp = weights.from_jax_params(p, cfg=tcfg, device="cpu")

    def make(mode):
        jc = dataclasses.replace(jcfg, ps3_look_close_mode=mode)
        tc = dataclasses.replace(tcfg, ps3_look_close_mode=mode)
        return (jgen.GenerationEngine(jp, jc, tok),
                tgen.GenerationEngine(tp, tc, tok, device="cpu"))

    return make


PS3_PROMPT = [np.random.default_rng(12).integers(0, 256, (90, 120, 3), dtype=np.uint8),
              "What is written on the sign?"]


@pytest.mark.parametrize("mode", ["after_prompt", "after_image"])
def test_engine_transcript_equals_jax(ps3_engines, mode):
    """Greedy, token for token. In "after_prompt" mode both engines run the
    cache-free pass-1 forward over the unpadded low-res prompt; its hidden
    state (the top-down prompt) agrees with JAX's, and so does the
    selection it steers."""
    from vila_tpu.inference import generate as jgen
    from vila_tpu_torch.inference import generate as tgen

    jengine, tengine = ps3_engines(mode)
    jin, tin = jengine.prepare_inputs(list(PS3_PROMPT)), tengine.prepare_inputs(list(PS3_PROMPT))
    for key in ("input_ids", "media_pos"):
        np.testing.assert_array_equal(tin[key], jin[key])
    (je,), (te,) = jin["media"], tin["media"]
    assert te["kind"] == je["kind"] == "ps3"
    for a, b in zip([te["tiles"]] + te["tiles_high"], [je["tiles"]] + je["tiles_high"]):
        np.testing.assert_array_equal(a, b)
    assert ("ps3_low" in tin) == ("ps3_low" in jin) == (mode == "after_prompt")
    if mode == "after_prompt":
        for key in ("input_ids", "media_pos"):
            np.testing.assert_array_equal(tin["ps3_low"][key], jin["ps3_low"][key])
        assert len(tin["ps3_low"]["media_pos"]) == 4
        want = np.asarray(jengine._ps3_top_down_prompt(jin))
        got = tengine._ps3_top_down_prompt(tin)
        assert got.shape == want.shape == (1, 256)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=W4_RTOL * np.abs(want).max())
        _, _, jmaps = jvlm.encode_images_ps3(
            jengine.params, jengine.cfg, jnp.asarray(je["tiles"]),
            [jnp.asarray(h) for h in je["tiles_high"]], prompt=jnp.asarray(want))
        _, _, tmaps = tvlm.encode_images_ps3(
            tengine.params, tengine.cfg, torch.as_tensor(te["tiles"]),
            [torch.as_tensor(h) for h in te["tiles_high"]], prompt=got)
        for a, b in zip(tmaps, jmaps):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want = jengine.generate_ids(jin, jgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    assert len(want) == NEW_TOKENS and got == want


def test_top_down_prompt_changes_the_media_and_mixed_media_refused(ps3_engines):
    """The pass-1 prompt steers the selection (the media embeddings move),
    and a PS3 tower takes no other media, as in JAX."""
    _, tengine = ps3_engines("after_prompt")
    tin = tengine.prepare_inputs(list(PS3_PROMPT))
    steered = tengine.encode_media(tin["media"], ps3_prompt=tengine._ps3_top_down_prompt(tin))
    plain = tengine.encode_media(tin["media"])
    assert steered.shape == plain.shape == (tengine.cfg.tokens_per_image, 256)
    assert float((steered - plain).abs().max()) > 0
    with pytest.raises(AssertionError, match="only PS3 media"):
        tengine.encode_media(tin["media"] + [{"kind": "plain", "tiles": tin["media"][0]["tiles"]}])


def test_batcher_encodes_ps3_without_the_top_down_pass(ps3_engines):
    """Pinned reference behaviour: JAX's `ContinuousBatcher` encodes PS3
    media with `encode_media(inputs["media"])`, without the pass-1 prompt,
    even in "after_prompt" mode (vila_tpu/serving/batcher.py:238). So the
    batcher answers as the one-pass ("after_image") serial engine does, and
    may answer otherwise than the two-pass serial engine. The port's
    batcher mirrors it, token for token."""
    from vila_tpu.inference import generate as jgen
    from vila_tpu.serving import batcher as jbatcher
    from vila_tpu_torch.inference import generate as tgen
    from vila_tpu_torch.serving import batcher as tbatcher

    jengine, tengine = ps3_engines("after_prompt")
    _, one_pass = ps3_engines("after_image")
    gc = dict(max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,))
    serial_one = one_pass.generate_ids(one_pass.prepare_inputs(list(PS3_PROMPT)),
                                       tgen.GenerationConfig(**gc))
    tb = tbatcher.ContinuousBatcher(tengine, max_batch=2, max_len=256)
    jb = jbatcher.ContinuousBatcher(jengine, max_batch=2, max_len=256)
    try:
        got = [t for c in tb.stream_ids(list(PS3_PROMPT), tgen.GenerationConfig(**gc))
               for t in c]
        want = [t for c in jb.stream_ids(list(PS3_PROMPT), jgen.GenerationConfig(**gc))
                for t in c]
    finally:
        tb.shutdown()
        jb.shutdown()
    assert len(got) == NEW_TOKENS and got == want == serial_one
