"""The committed parity goldens (`tests/goldens/*.npz`, made by the HF torch
stack through `tests/gen_goldens.py`) as the port's second bar: the port,
loaded with `entry.load(device="cpu", dtype="float32")` from the checkpoint
that `helpers.save_tiny_checkpoint(seed=0, **FLAVORS[name])` rebuilds, meets
the bar `test_parity_goldens.py` holds the JAX package to
(`scripts/parity_vs_hf.py check --assert-max-abs 5e-4`):

* the prompt suite (built with the port's own media classes) expands to the
  fixture's token ids;
* the logits at the fixture's rows are within max |dlogit| <= 5e-4, with
  top-1 agreement 1.0;
* the greedy continuation of the single-image prompt matches the golden;
* the W4 engine (the port's quantizer) gives a transcript.

`dynamic_s2.npz` (the single image through the dynamic-S2 tiling and
multi-scale encode, two images as 1x1-block S2 entries) and
`video_tsp.npz` (a TSP video entry beside the image prompts) run in the
default set, as on the JAX side (`test_parity_goldens.py`); `gqa8b.npz`
(7:1 GQA, qkv bias, untied head) runs under `slow`, as there.
"""

import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from gen_goldens import FLAVORS, GOLDEN_DIR  # noqa: E402
from vila_tpu_torch import entry  # noqa: E402
from vila_tpu_torch.inference.generate import GenerationConfig  # noqa: E402
from vila_tpu_torch.media import Image, Video  # noqa: E402
from vila_tpu_torch.models import qwen2, vlm  # noqa: E402
from vila_tpu_torch.ops import quant  # noqa: E402

MAX_ABS = 5e-4  # test_parity_goldens.py's --assert-max-abs
MAX_NEW = 4
GREEDY_ENTRY = "single_image"
SUITE = ("text_only", "single_image", "multi_image")


def _synth(shape, seed):
    return np.random.default_rng(seed).integers(0, 255, shape, np.uint8)


def prompt_suite(engine):
    """`parity_vs_hf.build_prompt_suite`: with a dynamic-S2 checkpoint the
    image prompts take the S2 path; with a TSP checkpoint a video prompt
    of seeded frames is added."""
    img, img2 = Image(_synth((336, 448, 3), 0)), Image(_synth((280, 400, 3), 1))
    suite = {
        "text_only": engine.prepare_inputs("What is the capital of France?"),
        "single_image": engine.prepare_inputs([img, "Describe this image in detail."]),
        "multi_image": engine.prepare_inputs(
            [img, "and", img2, "Compare these two images."]),
    }
    if engine.cfg.video_encoder == "tsp":
        frames = [_synth((200, 300, 3), 10 + i) for i in range(engine.cfg.num_video_frames)]
        suite["video"] = engine.prepare_inputs([Video(frames), "Describe the video."])
    return suite


def logits_of(engine, inputs) -> np.ndarray:
    """f32 logits (S, V) of one cache-free forward over the expanded
    prompt, as `parity_vs_hf.vila_logits`."""
    params, cfg = engine.params, engine.cfg
    ids = torch.as_tensor(np.asarray(inputs["input_ids"], np.int64))[None]
    embeds = qwen2.embed_tokens(params["llm"], cfg.llm, ids)
    media = engine.encode_media(inputs["media"])
    if media is not None:
        embeds = vlm.splice_media(embeds, media, torch.as_tensor(inputs["media_pos"]))
    logits, _ = qwen2.forward(params["llm"], cfg.llm, inputs_embeds=embeds)
    return logits[0].float().numpy()


def greedy(engine, inputs):
    return engine.generate_ids(inputs, GenerationConfig(max_new_tokens=MAX_NEW))


def _golden(name, tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("golden") / name)
    helpers.save_tiny_checkpoint(ckpt, seed=0, **FLAVORS[name])
    engine = entry.load(ckpt, device="cpu", dtype="float32")
    fix = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    suite = prompt_suite(engine)
    assert sorted(str(s) for s in fix["suite"]) == sorted(suite)
    return engine, suite, fix


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return _golden("base", tmp_path_factory)


def _check_entry(engine, suite, fix, name):
    inputs = suite[name]
    np.testing.assert_array_equal(np.asarray(inputs["input_ids"], np.int32),
                                  fix[f"{name}__ids"])
    got = logits_of(engine, inputs)[fix[f"{name}__rows"]]
    want = fix[f"{name}__logits"]
    assert np.abs(got - want).max() <= MAX_ABS, name
    assert (got.argmax(-1) == want.argmax(-1)).mean() == 1.0, name


def _check_greedy(engine, suite, fix):
    ids = greedy(engine, suite[GREEDY_ENTRY])
    gold = list(fix["greedy_ids"])
    assert ids and ids[:len(gold)] == gold[:len(ids)]


@pytest.mark.parametrize("name", SUITE)
def test_base_golden_logits(base, name):
    _check_entry(*base, name)


def test_base_golden_greedy(base):
    _check_greedy(*base)


def test_base_golden_w4_transcript(base):
    """The W4A16 engine (fused slots, GQA-padded o, untied W4 lm_head)
    decodes a transcript; its logits stay near the f32 model's."""
    engine, suite, fix = base
    q = copy.copy(engine)
    q.params = dict(engine.params)
    q.params["llm"] = quant.quantize_llm_params(engine.params["llm"], bits=4,
                                                cfg=engine.cfg.llm)
    assert "packed" in q.params["llm"]["layers"]["qkv_proj"]
    ids = greedy(q, suite[GREEDY_ENTRY])
    assert ids and isinstance(engine.tokenizer.decode(ids, skip_special_tokens=True), str)
    rows = fix[f"{GREEDY_ENTRY}__rows"]
    d = np.abs(logits_of(q, suite[GREEDY_ENTRY])[rows]
               - logits_of(engine, suite[GREEDY_ENTRY])[rows])
    assert np.isfinite(d).all()


@pytest.fixture(scope="module")
def dynamic_s2(tmp_path_factory):
    return _golden("dynamic_s2", tmp_path_factory)


@pytest.fixture(scope="module")
def video_tsp(tmp_path_factory):
    return _golden("video_tsp", tmp_path_factory)


@pytest.mark.parametrize("name", SUITE)
def test_dynamic_s2_golden_logits(dynamic_s2, name):
    """single_image through the 1 + 4 + aspect-ratio tiles of scales
    (56, 112) and the merge; multi_image as two 1x1-block S2 entries."""
    engine, suite, _ = dynamic_s2
    assert engine.cfg.image_aspect_ratio == "dynamic_s2"
    kinds = [e["kind"] for e in suite[name]["media"]]
    assert kinds == {"text_only": [], "single_image": ["s2"],
                     "multi_image": ["s2", "s2"]}[name]
    _check_entry(*dynamic_s2, name)


def test_dynamic_s2_golden_greedy(dynamic_s2):
    _check_greedy(*dynamic_s2)


@pytest.mark.parametrize("name", SUITE + ("video",))
def test_video_tsp_golden_logits(video_tsp, name):
    engine, suite, _ = video_tsp
    assert engine.cfg.video_encoder == "tsp"
    if name == "video":
        assert [e["kind"] for e in suite[name]["media"]] == ["tsp"]
    _check_entry(*video_tsp, name)


def test_video_tsp_golden_greedy(video_tsp):
    _check_greedy(*video_tsp)


@pytest.mark.slow
def test_gqa8b_golden(tmp_path_factory):
    """8B structural signature: 7:1 GQA grouping, qkv bias, untied head."""
    engine, suite, fix = _golden("gqa8b", tmp_path_factory)
    for name in SUITE:
        _check_entry(engine, suite, fix, name)
    _check_greedy(engine, suite, fix)
