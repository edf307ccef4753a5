"""The port's JSON-constrained decoding (`vila_tpu_torch/inference/
constrained.py`, `GenerationEngine._constrained_loop`, the batcher's serial
fallback and the server) against `vila_tpu/inference/constrained.py` on the
CPU.

Each of the JAX package's cases runs through both modules and the results
are equal: the prefix validator, the incremental automaton (and the fuzz
that holds it to the validator, JAX's draw), the partial-key reader, the
grammar's per-state token masks bit for bit (JAX over the `transformers`
tokenizer, the port over its own `JsonTokenizer` of the same
`tokenizer.json`), the sampler's picks under adversarial logits, and the
engines' constrained streams on one tiny f32 checkpoint (ids equal). A
`response_format` request over HTTP, streamed and not, goes through the
batcher's serial fallback while a batched request runs, and answers the
JAX engine's text. Everything compared is an id, a bool or a string: no
tolerance.
"""

import json
import os
import sys
import threading
import urllib.request

sys.path.insert(0, os.path.dirname(__file__))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import helpers  # noqa: E402
from vila_tpu.inference import constrained as jc  # noqa: E402
from vila_tpu_torch.inference import constrained as tc  # noqa: E402

VALID_PREFIXES = [
    "", "{", '{"', '{"a', '{"a"', '{"a":', '{"a": 1', '{"a": 1,',
    '{"a": 1, "b"', '{"a": [1, 2', '{"a": {"b": tru', '{"a": "x\\"y',
    "[", "[1", "[1,", '["a", nul', "123", "-1.5e", '"hello', "{}",
    '{"a": 1}', "[1, 2, 3]", "true", '  {"a": 1}  ',
]

INVALID_PREFIXES = [
    "}", "]", '{"a" 1', '{"a"::', "{,", "[,", '{"a": 1,,', "{]",
    '{"a": 1}{', "trux", '{"a": }', "[1 2]", '{1: 2}',
]

SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "answer": {"enum": ["yes", "no"]}},
          "required": ["name", "answer"]}


@pytest.mark.parametrize("s", VALID_PREFIXES)
def test_valid_prefixes(s):
    assert tc.JsonPrefixValidator().is_valid_prefix(s)
    assert jc.JsonPrefixValidator().is_valid_prefix(s)


@pytest.mark.parametrize("s", INVALID_PREFIXES)
def test_invalid_prefixes(s):
    assert not tc.JsonPrefixValidator().is_valid_prefix(s)
    assert not jc.JsonPrefixValidator().is_valid_prefix(s)


@pytest.mark.parametrize("s", ['{"a": 1}', "[1, 2]", '{"a": 1', "", '"open string', "12",
                               '{"a": [1, {"b": null}]}'])
def test_completeness(s):
    assert tc.JsonPrefixValidator().is_complete(s) == jc.JsonPrefixValidator().is_complete(s)
    assert tc.JsonPrefixValidator().is_complete(s) == (
        s in ('{"a": 1}', "[1, 2]", "12", '{"a": [1, {"b": null}]}'))


@pytest.mark.parametrize("s", ["-", "1.", "2e", "-1e+", "t", "fal", "nu"])
def test_scalar_prefix_counts_as_complete_in_both(s):
    """A fault of the reference, mirrored: the validator's scan returns
    (valid, depth 0) for text ending inside a top-level number or literal,
    so `is_complete` holds for a prefix `json.loads` rejects, and the
    sampler stops there (the JAX engine answers "-" or "f")."""
    assert tc.JsonPrefixValidator().is_complete(s) and jc.JsonPrefixValidator().is_complete(s)
    with pytest.raises(ValueError):
        json.loads(s)


@pytest.mark.parametrize("s,want", [('{"na', "na"), ('{"name": "x", "a', "a"),
                                    ('{"name": "val', None), ('{"name"', None),
                                    ('{"a": {"b', None), ('[{"k', None)])
def test_partial_key_extraction(s, want):
    assert tc._current_partial_key(s) == jc._current_partial_key(s) == want


@pytest.mark.parametrize("s", VALID_PREFIXES)
def test_automaton_accepts_valid_prefixes(s):
    a, b = tc.JsonAutomaton(), jc.JsonAutomaton()
    assert a.run(s) == b.run(s) == "ok"
    assert a.state_key() == b.state_key()
    assert a.is_complete_state() == b.is_complete_state()


@pytest.mark.parametrize("s", INVALID_PREFIXES)
def test_automaton_rejects_invalid_prefixes(s):
    assert tc.JsonAutomaton().run(s) == jc.JsonAutomaton().run(s) == "reject"


def test_automaton_agrees_with_validator_fuzz():
    """JAX's fuzz (500 strings of up to 11 characters from its alphabet,
    numpy seed 0): the port's automaton == its validator == JAX's
    automaton, state for state."""
    rng = np.random.default_rng(0)
    alphabet = list('{}[]",:.\\ 019-aetrunlfsx"')
    v = tc.JsonPrefixValidator()
    for _ in range(500):
        n = int(rng.integers(0, 12))
        s = "".join(rng.choice(alphabet) for _ in range(n))
        a, b = tc.JsonAutomaton(), jc.JsonAutomaton()
        ra, rb = a.run(s), b.run(s)
        assert ra == rb, s
        assert (ra == "ok") == v.is_valid_prefix(s), s
        if ra == "ok":
            assert a.state_key() == b.state_key(), s


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    """(HF tokenizer, the port's JsonTokenizer) of one tokenizer.json, the
    media tokens added to each."""
    from transformers import AutoTokenizer

    from vila_tpu.data.tokenizer_utils import add_media_tokens as jadd
    from vila_tpu_torch.data.tokenizer_json import JsonTokenizer
    from vila_tpu_torch.data.tokenizer_utils import add_media_tokens as tadd

    path = str(tmp_path_factory.mktemp("tok"))
    helpers.make_tiny_tokenizer().save_pretrained(path)
    hf, ours = AutoTokenizer.from_pretrained(path), JsonTokenizer.from_pretrained(path)
    jadd(hf)
    tadd(ours)
    return hf, ours


def test_batch_decode_and_vocab_size_match_transformers(tokenizers):
    """What the grammar's vocab table reads: `vocab_size` (the model's
    vocabulary, added tokens not counted), `len()` and `batch_decode` of
    every single id, special tokens included, with and without skipping."""
    hf, ours = tokenizers
    assert ours.vocab_size == hf.vocab_size and len(ours) == len(hf)
    ids = [[i] for i in range(len(hf))] + [[72, 105, 300], [len(hf) - 1, 65]]
    for skip in (True, False):
        assert ours.batch_decode(ids, skip_special_tokens=skip) == hf.batch_decode(
            ids, skip_special_tokens=skip)


def test_grammar_token_mask_equals_jax_and_is_sound(tokenizers):
    """The per-state token masks bit for bit, for every state the valid
    prefixes reach; and sound: no token the exact validator accepts is
    masked out."""
    hf, ours = tokenizers
    v = tc.JsonPrefixValidator()
    pieces = tc._token_texts(ours)
    assert pieces == jc._token_texts(hf)
    for text in VALID_PREFIXES:
        a = tc.JsonAutomaton()
        assert a.run(text) == "ok"
        mask = tc.grammar_token_mask(ours, a)
        b = jc.JsonAutomaton()
        b.run(text)
        np.testing.assert_array_equal(mask, jc.grammar_token_mask(hf, b))
        for tid, piece in enumerate(pieces):
            if piece and v.is_valid_prefix(text + piece):
                assert mask[tid], (text, tid, repr(piece))


def test_schema_token_outside_topk_still_emitted(tokenizers):
    """JAX's adversarial case: every token that could advance the sampler
    ranks below the 32 highest (illegal) ones, and both samplers still walk
    to the schema's exact object, pick for pick."""
    hf, ours = tokenizers
    schema = {"type": "object", "properties": {"zq": {"type": "integer"}},
              "required": ["zq"]}
    ts, js = tc.JsonConstrainedSampler(ours, schema, top_k=32), jc.JsonConstrainedSampler(
        hf, schema, top_k=32)
    vsz = len(ours)
    rng = np.random.default_rng(1)
    target = '{"zq": 0}'
    out = []
    val = tc.JsonPrefixValidator()
    while not ts.done() and len(out) < 64:
        logits = np.asarray(rng.normal(0, 1, (vsz,)), np.float32)
        for tid in range(vsz):
            piece = ours.decode(ts._ids + [tid], skip_special_tokens=True)
            if (piece.startswith(ts.text) and len(piece) > len(ts.text)
                    and val.is_valid_prefix(piece)):
                logits[tid] = (-100.0 if target.startswith(piece) else -200.0) - rng.random()
        if vsz - int((logits < -50).sum()) >= 32:
            assert np.sort(logits)[-32:].min() > -50  # every legal token is outside
        tid = ts.pick(logits)
        assert tid is not None and tid == js.pick(logits), (ts.text, len(out))
        out.append(tid)
    assert ts.done() and js.done() and ts.text == js.text
    assert set(json.loads(ts.text)) == {"zq"}
    assert ours.decode(out, skip_special_tokens=True) == ts.text


@pytest.mark.parametrize("target", ["6", '"no"', "[true]", "{}", '{"answer": "maybe"}',
                                    '{"answer": 3}'])
def test_schema_guide_leaves_the_value_free_in_both(tokenizers, target):
    """A fault of the reference, mirrored: the schema guide narrows only
    the object keys at depth 1. It holds neither a top-level object, nor
    the required keys, nor an enum's values, so a schema that asks for
    {"answer": "yes" | "no"} lets both samplers finish, pick for pick, on
    each of these texts (the JAX engine answers 6 on the quant probe)."""
    hf, ours = tokenizers
    schema = {"type": "object", "properties": {"answer": {"enum": ["yes", "no"]}},
              "required": ["answer"]}
    ts, js = tc.JsonConstrainedSampler(ours, schema), jc.JsonConstrainedSampler(hf, schema)
    while not ts.done() and len(ts._ids) < 32:
        logits = np.zeros(len(ours), np.float32)
        for tid in range(len(ours)):  # the longest step toward the target ranks first
            piece = ours.decode(ts._ids + [tid], skip_special_tokens=True)
            if len(piece) > len(ts.text) and target.startswith(piece):
                logits[tid] = len(piece)
        tid = ts.pick(logits)
        assert tid is not None and tid == js.pick(logits), (ts.text, target)
    assert ts.done() and js.done() and ts.text == js.text == target
    value = json.loads(target)
    assert not isinstance(value, dict) or value.get("answer") not in ("yes", "no")


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX and the port engine over one tiny f32 checkpoint."""
    import vila_tpu
    from gen_goldens import FLAVORS
    from vila_tpu_torch import entry

    d = str(tmp_path_factory.mktemp("constrained") / "base")
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    return vila_tpu.load(d), entry.load(d, device="cpu")


FORMATS = {"json_object": {"type": "json_object"},
           "json_schema": {"type": "json_schema", "json_schema": SCHEMA}}


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_stream_ids_equals_jax(engines, fmt):
    """`stream_ids` with `response_format` (the first token from the
    prefill's logits through the sampler, then one step at a time): equal
    ids, a valid JSON prefix, complete and in the schema's key order where
    the sampler finished."""
    from vila_tpu.inference.generate import GenerationConfig as JGC
    from vila_tpu_torch.inference.generate import GenerationConfig as TGC

    jengine, tengine = engines
    prompt = "give me json"
    jin, tin = jengine.prepare_inputs(prompt), tengine.prepare_inputs(prompt)
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    # lookup_gamma is ignored: response_format comes first, as in JAX
    kw = dict(max_new_tokens=48, response_format=FORMATS[fmt], lookup_gamma=3)
    got = tengine.generate_ids(tin, TGC(**kw))
    assert got == jengine.generate_ids(jin, JGC(**kw))
    text = tengine.tokenizer.decode(got, skip_special_tokens=True)
    assert text and tc.JsonPrefixValidator().is_valid_prefix(text), text
    if tc.JsonPrefixValidator().is_complete(text):
        value = json.loads(text)
        # the guide narrows object keys (a bare value is JSON too, as in JAX)
        if fmt == "json_schema" and isinstance(value, dict):
            assert list(value) == ["name", "answer"][:len(value)]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def test_server_serves_response_format_through_the_batcher(engines):
    """Over HTTP, behind a `ContinuousBatcher`: a `response_format`
    request, blocking and streamed, takes the serial engine while a plain
    request is batched; each answers as its engine does serially, the
    constrained one the JAX engine's text."""
    from vila_tpu.inference.generate import GenerationConfig as JGC
    from vila_tpu_torch.inference.generate import GenerationConfig as TGC
    from vila_tpu_torch.serving.batcher import ContinuousBatcher
    from vila_tpu_torch.serving.server import make_server

    jengine, tengine = engines
    rf = FORMATS["json_schema"]
    want = jengine.generate_content(["name a yes or no"],
                                    JGC(max_new_tokens=24, response_format=rf))
    plain = tengine.generate_content(["hello there"], TGC(max_new_tokens=6))
    batcher = ContinuousBatcher(tengine, max_batch=2, max_len=256)
    httpd = make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions"
    try:
        side = []
        batched = threading.Thread(target=lambda: side.append(json.loads(_post(url, {
            "messages": [{"role": "user", "content": "hello there"}], "max_tokens": 6,
            "temperature": 0}).read())))
        batched.start()
        body = {"messages": [{"role": "user", "content": "name a yes or no"}],
                "max_tokens": 24, "response_format": rf}
        with _post(url, body) as r:
            blocking = json.loads(r.read())["choices"][0]["message"]["content"]
        with _post(url, dict(body, stream=True)) as r:
            raw = r.read().decode()
        batched.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.shutdown()
        thread.join(timeout=30)
    lines = [ln[len("data: "):] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    streamed = "".join(json.loads(ln)["choices"][0]["delta"].get("content", "")
                       for ln in lines[:-1])
    assert blocking == streamed.strip() == want
    assert side and side[0]["choices"][0]["message"]["content"] == plain
    assert batcher.steps > 0  # the plain request was batched
