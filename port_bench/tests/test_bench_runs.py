"""Whole runs of each driver on the CPU at tiny widths, the look for a card
skipped: the plain versions stand in for the kernels. A sound run's check
holds; a run with the timed path broken underneath reads `correct` false,
once for each fault the cell can have (a token altered where it is
produced; a step that leaves the state unchanged; half the batch left out,
the mean taken over the rest)."""

import copy
import time

import pytest
import torch

from port_bench import harness

SEED = 2**32 + 77


def tiny(name):
    cell = copy.deepcopy(harness.cell(name))
    cell["config"]["llm"].update(vocab_size=2048, hidden_size=256, intermediate_size=512,
                                 num_hidden_layers=2, num_attention_heads=2,
                                 num_key_value_heads=1)
    cell["config"]["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                    num_attention_heads=4)
    mix = cell["traffic"]
    if mix["loop"] == "train":
        cell["config"]["vision"]["image_size"] = 112
        cell["config"]["training"]["seq_len"] = 512
        mix.update(tile_size=112, first_text_id=300, pool=200, max_steps=5000)
        mix["image_text_tokens"].update(median=48, min=8, max=200)
        mix["text_tokens"].update(median=64, min=16, max=200)
    else:
        mix.update(lead_in_s=1, tail_limit_s=20, image_pool=3, sample_tokens=40,
                   sample_requests=3)
        mix["question_tokens"].update(max=48)
        mix["output_tokens"].update(max=10, median=5, min=2)
        cell["workload"]["rate_per_s"] = 2.0
    return cell


def run(name, seconds=3.0):
    cell = tiny(name)
    ctx = {"cell": cell, "seed": SEED, "seconds": seconds, "trace": False,
           "device": torch.device("cpu"), "t_start": time.perf_counter(), "trace_path": None}
    return harness.driver(cell["workload"]["driver"]).run(ctx)


@pytest.mark.parametrize("name", ["nvila8b-chat"])
def test_serving_run_holds(name):
    rec = run(name)
    assert rec["failed"] == 0 and rec["attempted"] > 0
    assert rec["correct"], rec["compared"]
    assert rec["metrics"]["out_tok_s"] > 0
    w0, w1 = rec["window"]
    assert all(c.finished for c in rec["clients"] if w0 <= c.due < w1)


def test_tokens_are_stamped_as_they_are_put():
    import queue
    import threading

    from port_bench.drivers import serve

    out = queue.Queue()
    out.put([7])  # handed over before the stream was taken
    c = serve.Client({"new_tokens": 3}, 0.0)
    c.attach(out)
    th = threading.Thread(target=lambda: [out.put([8]), out.put([9]), out.put(None)])
    th.start()
    th.join()
    assert c.tokens == [7, 8, 9] and c.finished and c.late == 1
    assert c.times == sorted(c.times) and out.empty()


def test_serving_token_altered_reads_incorrect(monkeypatch):
    from vila_tpu_torch.serving import batcher

    def altered(logits, *a, **kw):  # every token the worst the logits allow
        return logits.argmin(-1)

    monkeypatch.setattr(batcher, "sample_token", altered)
    rec = run("nvila8b-chat")
    assert not rec["correct"]
    assert rec["compared"]["logit_gap"]["value"] > rec["compared"]["logit_gap"]["limit"]


def test_training_run_reads_small_gaps():
    rec = run("nvila-lite-2b-sft2k")
    c = rec["compared"]
    assert rec["failed"] == 0 and rec["metrics"]["train_tok_s"] > 0
    assert c["loss_gap"]["value"] <= c["loss_gap"]["limit"]
    assert c["grad_gap"]["value"] <= c["grad_gap"]["limit"]
    assert c["change_gap"]["value"] < 0.25


def test_training_state_unchanged_reads_incorrect(monkeypatch):
    from vila_tpu_torch.train import optimizer

    def unchanged(self, opt_state, params, norm=None):
        for t in optimizer.leaves(params):
            t.grad = None
        opt_state.count += 1
        return opt_state

    monkeypatch.setattr(optimizer.Optimizer, "update", unchanged)
    rec = run("nvila-lite-2b-sft2k")
    assert not rec["correct"]
    assert rec["compared"]["change_gap"]["value"] == pytest.approx(1.0)


def test_training_half_batch_reads_incorrect(monkeypatch):
    from vila_tpu_torch.train import step

    inner = step.loss_fn

    def half(params, cfg, batch, *a, **kw):
        labels = batch["labels"].clone()
        keep = (labels != -100).nonzero()
        labels[tuple(keep[len(keep) // 2:].t())] = -100
        return inner(params, cfg, dict(batch, labels=labels), *a, **kw)

    monkeypatch.setattr(step, "loss_fn", half)
    rec = run("nvila-lite-2b-sft2k")
    assert not rec["correct"]
    assert any(c["value"] > c["limit"] for c in rec["compared"].values())
