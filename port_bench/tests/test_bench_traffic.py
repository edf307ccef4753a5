"""The traffic generator is deterministic by seed, and every seed gets the
same work in another order."""

import numpy as np

from port_bench import harness, traffic
from port_bench.tokenizer import ByteTokenizer, chat_prompt_ids

SEEDS = (7, 2**31 + 11, 2**33 + 5)


def chat():
    return harness.cell("nvila8b-chat")["traffic"]


def test_open_loop_same_seed_same_requests():
    a = traffic.open_loop(chat(), 3.0, 20, SEEDS[1])
    b = traffic.open_loop(chat(), 3.0, 20, SEEDS[1])
    assert a == b


def test_open_loop_seeds_permute_the_same_work():
    runs = [traffic.open_loop(chat(), 3.0, 20, s) for s in SEEDS]
    for phase in ("lead_in", "window", "tail"):
        sizes = [sorted((r["question_tokens"], r["new_tokens"]) for r in run
                        if r["phase"] == phase) for run in runs]
        assert sizes[0] == sizes[1] == sizes[2]
        gaps = [sorted(np.round(np.diff([0.0] + [r["due"] for r in run if r["phase"] == phase]), 9))
                for run in runs]
        assert len(gaps[0]) == len(gaps[1])
    assert [r["question"] for r in runs[0]] != [r["question"] for r in runs[1]]


def test_open_loop_counts_and_spans():
    mix = chat()
    reqs = traffic.open_loop(mix, 2.5, 40, SEEDS[0])
    win = [r for r in reqs if r["phase"] == "window"]
    assert len(win) == 100
    lead = mix["lead_in_s"]
    assert all(lead <= r["due"] < lead + 40 for r in win)
    assert [r["due"] for r in reqs] == sorted(r["due"] for r in reqs)


def test_lengths_respect_the_mix():
    mix = chat()
    reqs = traffic.open_loop(mix, 3.0, 40, SEEDS[2])
    q, o = mix["question_tokens"], mix["output_tokens"]
    assert all(q["min"] <= r["question_tokens"] <= q["max"] for r in reqs)
    assert all(o["min"] <= r["new_tokens"] <= o["max"] for r in reqs)
    assert all(len(r["question"]) == r["question_tokens"] for r in reqs)
    assert all(r["question"] == r["question"].strip() for r in reqs)


def test_question_text_is_one_token_a_byte():
    tok = ByteTokenizer()
    text = traffic.question_text(traffic.rng(3, "t"), 77)
    ids = chat_prompt_ids(tok, text, 256)
    # <|im_start|>user\n, 256 placeholders and a newline, the question,
    # <|im_end|>\n<|im_start|>assistant\n
    assert len(ids) == 1 + 5 + 256 + 1 + 77 + 1 + 1 + 1 + 10


def test_images_follow_the_seed():
    mix = chat()
    a, b = traffic.pool_images(mix, SEEDS[0]), traffic.pool_images(mix, SEEDS[0])
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = traffic.pool_images(mix, SEEDS[1])
    assert sorted(x.shape for x in a) == sorted(x.shape for x in c)
    lo, hi = mix["image_side"]
    assert all(lo <= max(x.shape[:2]) <= hi and x.shape[2] == 3 for x in a)


def test_serve_requests_permute_the_same_sizes():
    mix = chat()
    a = traffic.serve_requests(mix, 512, SEEDS[0], "window")
    b = traffic.serve_requests(mix, 512, SEEDS[1], "window")
    assert sorted((r["question_tokens"], r["new_tokens"]) for r in a) == sorted(
        (r["question_tokens"], r["new_tokens"]) for r in b)
    q, o = mix["question_tokens"], mix["output_tokens"]
    assert all(q["min"] <= r["question_tokens"] <= q["max"] for r in a)
    assert all(o["min"] <= r["new_tokens"] <= o["max"] for r in a)


def test_image_aspect_stays_in_the_mix():
    mix = chat()
    a_lo, a_hi = mix["aspect"]
    for x in traffic.pool_images(mix, SEEDS[0]):
        h, w = x.shape[:2]
        assert a_lo - 0.01 <= w / h <= a_hi + 0.01


def test_training_samples_and_rows():
    cell = harness.cell("nvila-lite-2b-sft2k")
    mix, cfg = cell["traffic"], cell["config"]
    tok = ByteTokenizer()
    image_id = tok.media_token_ids["image"]
    runs = [traffic.train_samples(mix, cfg["llm"]["vocab_size"], image_id, 256, s) for s in SEEDS[:2]]
    assert sorted(len(s["input_ids"]) for s in runs[0]) == sorted(len(s["input_ids"]) for s in runs[1])
    again = traffic.train_samples(mix, cfg["llm"]["vocab_size"], image_id, 256, SEEDS[0])
    assert all(np.array_equal(x["input_ids"], y["input_ids"]) for x, y in zip(runs[0], again))
    for s in runs[0][:50]:
        n_img = len(s["tiles"])
        assert len(s["media_positions"]) == 256 * n_img
        assert (s["input_ids"][s["media_positions"]] == image_id).all()
        text = np.delete(s["input_ids"], s["media_positions"])
        assert (text[n_img:] >= mix["first_text_id"]).all()
        assert (s["labels"][:len(s["media_positions"]) + n_img + 1] == traffic.IGNORE).all()
    rows = traffic.rows(runs[0], 2048, 60)
    assert all(sum(len(s["input_ids"]) for s in r) <= 2048 for r in rows)
    assert [id(s) for r in rows for s in r] == [id(s) for s in (runs[0] * 2)[:sum(map(len, rows))]]
