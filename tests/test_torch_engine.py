"""The port's `GenerationEngine` against the JAX package's on a tiny W4
checkpoint, on the CPU: the same image+prompt request, greedy, gives the
same transcript token for token.

Both engines share one tiny byte-level tokenizer (`helpers.
make_tiny_tokenizer`) and one parameter set drawn with numpy from a seed;
the LLM is quantized to W4 by the JAX package (fused slots, GQA-padded o,
untied W4 lm_head) and reaches the port through `from_jax_params`. The
prompt pads to a 128-row bucket, so the prefill runs the W4 GEMM (K2), and
decode runs the fused layer (K3) and the W4 GEMV (K1) on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from vila_tpu.data.tokenizer_utils import add_media_tokens
from vila_tpu.inference import generate as jgen
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.ops import quant as jquant
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.ops import fused_decode as tfused
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

NEW_TOKENS = 16
# Both sides round the W4 lm_head's logits to bf16, and their f32 sums
# differ in order, so a greedy step whose top-2 margin is one bf16 ulp is a
# tie either side may break (seeds 0, 1 and 6 of this draw hit one within
# 16 steps; the logits there agree to one ulp). This seed's transcript has
# no such tie.
SEED = 2


def _same(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


@pytest.fixture(scope="module")
def tiny():
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
    rng = np.random.default_rng(SEED)
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


def test_greedy_transcript_equals_jax_engine(tiny, monkeypatch):
    tok, cfg, p, tcfg = tiny
    image = np.random.default_rng(1).integers(0, 256, (56, 56, 3), dtype=np.uint8)
    prompt = [image, "What is shown here?"]
    jengine = jgen.GenerationEngine(jax.tree.map(jnp.asarray, p), cfg, tok)
    tengine = tgen.GenerationEngine(weights.from_jax_params(p, cfg=tcfg, device="cpu"),
                                    tcfg, tok, device="cpu")
    jin, tin = jengine.prepare_inputs(list(prompt)), tengine.prepare_inputs(list(prompt))
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    np.testing.assert_array_equal(tin["media_pos"], jin["media_pos"])

    calls = []
    real = tfused.fused_layer
    monkeypatch.setattr(tfused, "fused_layer",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    # no stop token: both decode exactly NEW_TOKENS
    want = jengine.generate_ids(jin, jgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    assert len(want) == NEW_TOKENS
    assert got == want
    assert len(calls) == cfg.llm.num_hidden_layers * (NEW_TOKENS - 1)


def test_generate_content_and_sampling_run(tiny):
    """The text API and the sampled path (torch's random stream, so only
    shape and range are checked)."""
    tok, _, p, tcfg = tiny
    engine = tgen.GenerationEngine(weights.from_jax_params(p, device="cpu"), tcfg, tok,
                                   decode_chunk=3, device="cpu")
    text = engine.generate_content(
        ["describe", np.zeros((56, 56, 3), np.uint8)],
        tgen.GenerationConfig(max_new_tokens=4, stop_token_ids=(-1,)))
    assert isinstance(text, str)
    inputs = engine.prepare_inputs("hello")
    ids = engine.generate_ids(inputs, tgen.GenerationConfig(
        max_new_tokens=7, do_sample=True, temperature=0.8, top_p=0.9, top_k=20,
        stop_token_ids=(-1,)))
    assert len(ids) == 7 and all(0 <= t < tcfg.llm.vocab_size for t in ids)
