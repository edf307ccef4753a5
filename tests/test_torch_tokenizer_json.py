"""The port's `tokenizer.json` reader (`vila_tpu_torch/data/tokenizer_json`)
against `transformers.AutoTokenizer` on the forms the repository holds:
the quant probe's byte-level BPE with merges and
`tests/helpers.make_tiny_tokenizer`'s merge-free one, each with the ChatML
template and the media tokens added.

* ids equal for all 200 pope-mini prompts through the chat template
  (`tokenize_conversation`, as `GenerationEngine.prepare_inputs` calls it),
  and for plain texts that reach every branch of GPT-2's split pattern
  (contractions, letters, numbers, other symbols, runs of spaces before a
  word and at the end, non-ASCII letters and numbers);
* `decode` of every id, with and without the special tokens, equal;
* another form raises `NotImplementedError` naming the field.
"""

import copy
import json
import os
import random

import numpy as np
import pytest

import helpers
from vila_tpu_torch import entry
from vila_tpu_torch.data import tokenizer_json
from vila_tpu_torch.data.tokenizer_json import JsonTokenizer
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens, tokenize_conversation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE_LLM = os.path.join(REPO, "vila_tpu", "eval", "fixtures", "quant_probe", "llm")
POPE = os.path.join(REPO, "vila_tpu", "eval", "fixtures", "mini", "pope.jsonl")

TEXTS = [
    "Is there a yellow circle in the image?", "Hello world!  It's   a test's\n\n  x",
    "  leading", "trailing  ", "a\tb\r\nc", "1234 5,678.9", "café naïve 東京 ²³ ½ Ⅻ",
    "don't I'LL we've they'd", "<|im_start|>user\nhi<|im_end|>\n", "mixed<image>tok",
    "emoji 😀 ok", "x  \n y", "   ", "", "a b c", "__init__ -> x+=1;",
]


@pytest.fixture(scope="module", params=["probe", "tiny"])
def pair(request, tmp_path_factory):
    from transformers import AutoTokenizer

    path = PROBE_LLM
    if request.param == "tiny":
        path = str(tmp_path_factory.mktemp("tiny_tok"))
        helpers.make_tiny_tokenizer().save_pretrained(path)
    hf, ours = AutoTokenizer.from_pretrained(path), JsonTokenizer.from_pretrained(path)
    assert add_media_tokens(hf) == add_media_tokens(ours)
    return hf, ours


def test_pope_prompts_through_the_chat_template(pair):
    hf, ours = pair
    with open(POPE) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    assert len(rows) == 200
    for r in rows:
        conv = [{"from": "human",
                 "value": "<image>\n" + r["question"] + "\nAnswer the question with yes or no."}]
        want = tokenize_conversation(conv, hf, add_generation_prompt=True)
        got = tokenize_conversation(conv, ours, add_generation_prompt=True)
        np.testing.assert_array_equal(got, want)
    assert ours.apply_chat_template([{"role": "user", "content": "hi"}], tokenize=False,
                                    add_generation_prompt=True) == hf.apply_chat_template(
        [{"role": "user", "content": "hi"}], tokenize=False, add_generation_prompt=True)


def test_texts_and_random_strings(pair):
    hf, ours = pair
    rng = random.Random(0)
    alphabet = " \t\n'abcAZ09.,!é東😀<|>²"
    texts = TEXTS + ["".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
                     for _ in range(300)]
    for t in texts:
        assert ours(t).input_ids == hf(t, add_special_tokens=False).input_ids, repr(t)


def test_decode_every_id(pair):
    hf, ours = pair
    assert len(ours) == len(hf)
    for i in range(len(hf)):
        assert ours.decode([i]) == hf.decode([i]), i
        assert ours.convert_ids_to_tokens(i) == hf.convert_ids_to_tokens(i)
    ids = hf("<|im_start|>user\nhé 😀 x<|im_end|>\n", add_special_tokens=False).input_ids
    for skip in (False, True):
        assert ours.decode(ids, skip_special_tokens=skip) == hf.decode(
            ids, skip_special_tokens=skip)
    assert (ours.eos_token, ours.pad_token_id, ours.eos_token_id) == (
        hf.eos_token, hf.pad_token_id, hf.eos_token_id)
    assert ours.convert_tokens_to_ids("<image>") == hf.convert_tokens_to_ids("<image>")
    assert ours.convert_tokens_to_ids("no-such-token") is None


def test_split_pattern_branches():
    split = tokenizer_json.split_gpt2
    assert split("it's  a  b") == ["it", "'s", " ", " a", " ", " b"]
    assert split("x  \n y") == ["x", "  \n", " y"]
    assert split("end  ") == ["end", "  "]
    assert split("A1b2 ,.!?") == ["A", "1", "b", "2", " ,.!?"]


def test_load_tokenizer_and_save_round_trip(tmp_path):
    """`entry.load_tokenizer` reads the checkpoint's `llm/` with the port's
    reader; `save_pretrained` writes a directory that reads back the same."""
    ckpt = tmp_path / "ckpt"
    (ckpt / "llm").mkdir(parents=True)
    helpers.make_tiny_tokenizer().save_pretrained(str(ckpt / "llm"))
    tok = entry.load_tokenizer(str(ckpt))
    assert isinstance(tok, JsonTokenizer) and tok.media_token_ids["image"] == 259
    tok.save_pretrained(str(tmp_path / "again"))
    back = JsonTokenizer.from_pretrained(str(tmp_path / "again"))
    assert len(back) == len(tok)
    assert [back.convert_tokens_to_ids(t) for t in ("<image>", "<vila/video>", "<|im_end|>")] == [
        tok.convert_tokens_to_ids(t) for t in ("<image>", "<vila/video>", "<|im_end|>")]
    assert back("a <image> b").input_ids == tok("a <image> b").input_ids


def _spec():
    with open(os.path.join(PROBE_LLM, "tokenizer.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("field,value", [
    ("normalizer", {"type": "NFC"}),
    ("pre_tokenizer", {"type": "Split", "pattern": {"Regex": "\\s+"},
                       "behavior": "Isolated", "invert": False}),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": True, "use_regex": True}),
    ("decoder", {"type": "WordPiece"}),
    ("post_processor", {"type": "TemplateProcessing"}),
    ("model.type", "WordPiece"),
    ("model.byte_fallback", True),
    ("added_tokens.lstrip", True),
])
def test_other_forms_raise(field, value):
    spec = copy.deepcopy(_spec())
    if field.startswith("model."):
        spec["model"][field.split(".")[1]] = value
    elif field == "added_tokens.lstrip":
        spec["added_tokens"][0]["lstrip"] = True
    else:
        spec[field] = value
    with pytest.raises(NotImplementedError, match=field.split(".")[-1]):
        JsonTokenizer(spec)


def test_another_chat_template_raises():
    with pytest.raises(NotImplementedError, match="chat_template"):
        JsonTokenizer(_spec(), {"chat_template": "{{ messages[0]['content'] }}"})
