"""The port's spans (`vila_tpu_torch.utils.profiling`): the shared no-op
while recording is off; nesting, parents and threads while it is on; the
spans' clock against a CPU profiler's exported trace; and the spans a tiny
train step and a tiny `ContinuousBatcher` run leave, on the CPU."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import record_function

import helpers
from vila_tpu_torch.data.collate import PackingCollator
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.serving import batcher as tbatcher
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train.step import batch_to_device, make_train_step
from vila_tpu_torch.utils import profiling


def _new(mark):
    """The spans that ended since `mark` (the largest id seen before)."""
    return [s for s in profiling.recorded() if s.id > mark]


def _mark():
    return max((s.id for s in profiling.recorded()), default=0)


def _run_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_off_hands_out_the_shared_noop_and_records_nothing():
    assert not profiling._profiler._is_profiler_enabled
    mark, before = _mark(), len(profiling.recorded())
    with profiling.annotate("off.a", request=3, x=1) as a:
        assert a is profiling.OFF and not a and a.id is None
        a.set(y=2)
    b = profiling.annotate("off.b")
    assert b is profiling.OFF
    b.end(z=3)
    with pytest.raises(ValueError, match="inside"):  # the no-op swallows nothing
        with profiling.annotate("off.c"):
            raise ValueError("inside")
    assert len(profiling.recorded()) == before and not _new(mark)


def test_nesting_parents_and_threads_while_recording():
    mark = _mark()
    seen = {}
    with profiling.recording():
        with profiling.annotate("rec.outer", request=7) as outer:
            with profiling.annotate("rec.inner", k=1) as inner:
                inner.set(k=2)
            wait = profiling.annotate("rec.wait", request=7, parent=outer.id)

            def other():
                seen["thread"] = threading.get_native_id()
                with profiling.annotate("rec.t_outer") as t_outer:
                    with profiling.annotate("rec.t_inner"):
                        pass
                    with profiling.annotate("rec.t_explicit", parent=outer.id):
                        pass
                    seen["t_outer"] = t_outer.id
                wait.end(n=5)

            _run_thread(other)
    spans = {s.name: s for s in _new(mark)}
    assert set(spans) == {"rec.outer", "rec.inner", "rec.wait", "rec.t_outer", "rec.t_inner",
                          "rec.t_explicit"}
    main = threading.get_native_id()
    o = spans["rec.outer"]
    assert (o.parent, o.request, o.thread) == (None, 7, main)
    assert spans["rec.inner"].parent == o.id and spans["rec.inner"].attrs == {"k": 2}
    assert spans["rec.inner"].thread == main
    assert o.start <= spans["rec.inner"].start <= spans["rec.inner"].end <= o.end
    w = spans["rec.wait"]
    assert (w.parent, w.request, w.thread, w.attrs) == (o.id, 7, main, {"n": 5})
    assert spans["rec.t_outer"].parent is None and spans["rec.t_outer"].id == seen["t_outer"]
    assert spans["rec.t_inner"].parent == seen["t_outer"]
    assert spans["rec.t_explicit"].parent == o.id
    assert {spans[n].thread for n in ("rec.t_outer", "rec.t_inner", "rec.t_explicit")} == {
        seen["thread"]}
    assert seen["thread"] != main
    assert profiling.annotate("rec.after") is profiling.OFF  # off again


@pytest.mark.parametrize("where", ["main", "other"])
def test_spans_land_on_the_exported_trace_clock(tmp_path, where):
    """A span opened around a `record_function` region lies within 1 ms of
    that region in the exported Chrome trace (ts in us since its base)."""
    mark = _mark()

    def body():
        with profiling.annotate("clock.span"):
            with record_function("clock.region"):
                time.sleep(0.005)

    with profiling.trace(str(tmp_path)):
        body() if where == "main" else _run_thread(body)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    region = [e for e in events if e.get("name") == "clock.region"]
    mirror = [e for e in events if e.get("name") == "clock.span"]
    (span,) = [s for s in _new(mark) if s.name == "clock.span"]
    assert len(region) == 1 and len(mirror) == 1  # the span shows in the trace too
    r0 = region[0]["ts"] * 1e-6
    r1 = r0 + region[0]["dur"] * 1e-6
    assert abs(span.start - r0) < 1e-3 and abs(span.end - r1) < 1e-3, (span, r0, r1)
    assert span.thread == region[0]["tid"]


def _tiny_vlm_cfg(vocab_size=96):
    llm = tqwen2.LLMConfig(vocab_size=vocab_size, hidden_size=64, intermediate_size=96,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dtype="float32")
    vis = tsiglip.SigLIPConfig(hidden_size=32, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=2, image_size=56, patch_size=14)
    proj = tproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=32,
                                 hidden_size=64)
    return tvlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def _examples(cfg, rng):
    tpi = cfg.tokens_per_image
    out = []
    for i in range(4):
        n = int(rng.integers(8, 15))
        ids = rng.integers(3, 90, n).astype(np.int32)
        ex = {"input_ids": ids, "labels": ids.copy(),
              "tiles": np.zeros((0, 56, 56, 3), np.uint8),
              "media_positions": np.zeros((0,), np.int32)}
        if i % 2:
            ids[1:1 + tpi] = 95
            ex["tiles"] = rng.integers(0, 256, (1, 56, 56, 3), dtype=np.uint8)
            ex["media_positions"] = np.arange(1, 1 + tpi, dtype=np.int32)
        out.append(ex)
    return out


def test_train_step_spans_inside_a_trace(tmp_path):
    cfg = _tiny_vlm_cfg()
    params = tvlm.init_params(torch.Generator().manual_seed(0), cfg)
    opt = topt.make_optimizer(topt.OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0))
    step_fn, params, state = make_train_step(cfg, params, opt)
    collator = PackingCollator(seq_len=64, rows=1, tile_size=56)
    examples = _examples(cfg, np.random.default_rng(0))
    mark = _mark()
    with profiling.trace(str(tmp_path)):
        batch = collator(examples)
        _, _, metrics = step_fn(params, state, batch_to_device(batch, torch.device("cpu")))
    spans = _new(mark)
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert {n: len(v) for n, v in by.items()} == {
        "data.collate": 1, "train.to_device": 1, "train.step": 1, "train.forward": 1,
        "train.backward": 1, "train.update": 1, "model.vision": 1, "train.lm_head": 1}
    (col,), (dev,), (step,) = by["data.collate"], by["train.to_device"], by["train.step"]
    assert col.end <= dev.start and dev.end <= step.start
    seg = batch["segment_ids"]
    assert col.attrs == {"samples": 4, "tokens": int((seg > 0).sum()), "capacity": 64,
                         "tiles": 2}
    assert dev.attrs["bytes"] == sum(v.nbytes for v in batch.values())
    assert step.attrs == {"tokens": int(metrics["n_tokens"])}
    phases = [by[n][0] for n in ("train.forward", "train.backward", "train.update")]
    assert all(p.parent == step.id for p in phases)
    assert step.start <= phases[0].start and phases[-1].end <= step.end
    assert all(a.end <= b.start for a, b in zip(phases, phases[1:]))
    assert by["model.vision"][0].parent == phases[0].id
    assert by["model.vision"][0].attrs == {"tiles": 2, "frames": 2}
    (head,) = by["train.lm_head"]  # the CPU's logits route: its forward alone
    assert head.parent == phases[0].id and by["model.vision"][0].end <= head.start
    assert head.attrs == {"route": "logits", "tokens": 63, "chunks": 1}
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"data.collate", "train.step", "train.forward", "train.backward"} <= names


@pytest.fixture(scope="module")
def engine():
    """A tiny f32 VLM behind the byte-level test tokenizer."""
    tok = helpers.make_tiny_tokenizer()
    add_media_tokens(tok)
    cfg = _tiny_vlm_cfg(vocab_size=len(tok))
    params = tvlm.init_params(torch.Generator().manual_seed(1), cfg)
    return tgen.GenerationEngine(params, cfg, tok, device="cpu")


def test_batcher_spans_of_two_requests(engine):
    gc = tgen.GenerationConfig(max_new_tokens=4, do_sample=False, stop_token_ids=[-1])
    batcher = tbatcher.ContinuousBatcher(engine, max_batch=2, max_len=256)
    mark = _mark()
    try:
        with profiling.recording():
            outs = [batcher.submit(p, gc) for p in ("hello world", "the quick brown fox")]
            tokens = []
            for out in outs:
                n = 0
                while (item := out.get(timeout=120)) is not None:
                    n += len(item)
                tokens.append(n)
    finally:
        batcher.shutdown()
    spans = _new(mark)
    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == 2 and tokens == [4, 4]
    order = ["serve.queue_wait", "serve.prefill", "serve.ready_wait", "serve.insert"]
    for req, n in zip(sorted(requests, key=lambda s: s.start), tokens):
        assert req.attrs["emitted"] == n and req.attrs["prompt_tokens"] > 0
        mine = sorted((s for s in spans if s.request == req.request and s is not req),
                      key=lambda s: s.start)
        assert [s.name for s in mine] == ["serve.prepare_inputs"] + order
        assert all(s.parent == req.id for s in mine if s.name != "serve.insert")
        assert all(a.end <= b.start for a, b in zip(mine, mine[1:]))
        assert req.start <= mine[0].start and mine[-1].end <= req.end
        prefill = mine[2]
        assert prefill.attrs["prompt"] == req.attrs["prompt_tokens"]
        assert prefill.attrs["chunks"] == 1 and prefill.attrs["padded"] >= prefill.attrs["prompt"]
    steps = [s for s in spans if s.name == "serve.decode_step"]
    assert [s.attrs["step"] for s in steps] == list(range(len(steps)))
    assert all(len(s.attrs["rows"]) == s.attrs["active"] for s in steps)
    # each request's first token comes from its prefill, the rest one per
    # active slot a step
    assert sum(s.attrs["active"] for s in steps) == sum(tokens) - len(requests)
