"""The one traffic generator: it reads a mix's parameters
(`traffic/<name>.json`) and the cell's rate, and makes the requests of a
run from its seed.

Every seed gets the same work in another order: the sizes (question and
answer lengths, image sides, training samples) and the gaps between
arrivals are drawn from the mix's `base_seed`, and the run's seed only
permutes them and draws the content (pixels, question text, token ids).
So runs with different seeds differ in order, not in how much there is
to do, and a spread across seeds is the system's and not the draw's.

Open loop: arrivals in each phase (lead-in, window, tail) are a Poisson
process conditioned on its count: sorted uniform times whose spacings
the seed permutes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from port_bench.harness import derive_seed

LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)


def rng(seed: int, *names) -> np.random.Generator:
    return np.random.default_rng(derive_seed(seed, "traffic", *names))


def lengths(r: np.random.Generator, n: int, spec: Dict[str, Any]) -> np.ndarray:
    """n lengths: log-normal around `median` with `sigma`, clipped to
    [min, max]; or uniform over `uniform` = [lo, hi] inclusive."""
    if "uniform" in spec:
        lo, hi = spec["uniform"]
        return r.integers(lo, hi + 1, size=n)
    x = np.exp(r.normal(math.log(spec["median"]), spec["sigma"], size=n))
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def arrivals(base: np.random.Generator, perm: np.random.Generator, n: int,
             span: float) -> np.ndarray:
    """n arrival times in [0, span): the spacings of n sorted uniforms
    (and the end gap) drawn from `base`, permuted by `perm`."""
    if n == 0:
        return np.zeros(0)
    u = np.sort(base.uniform(0.0, span, size=n))
    gaps = np.diff(np.concatenate([[0.0], u, [span]]))
    return np.cumsum(perm.permutation(gaps))[:n]


def question_text(r: np.random.Generator, n: int) -> str:
    """n bytes of lowercase words: n tokens under the byte tokenizer, no
    leading or trailing space (the chat template strips them)."""
    chars = LETTERS[r.integers(0, len(LETTERS), size=n)].copy()
    if n > 2:
        spaces = r.random(n) < 0.17
        spaces[0] = spaces[-1] = False
        chars[spaces] = ord(" ")
    return chars.tobytes().decode()


def image_sizes(base: np.random.Generator, traffic: Dict[str, Any], n: int) -> List[tuple]:
    """(height, width) of n images: the long side uniform over
    `image_side`, the aspect (width / height) log-uniform over `aspect`."""
    lo, hi = traffic["image_side"]
    a_lo, a_hi = traffic["aspect"]
    out = []
    for _ in range(n):
        side = int(base.integers(lo, hi + 1))
        aspect = math.exp(base.uniform(math.log(a_lo), math.log(a_hi)))
        w, h = (side, max(1, int(side / aspect))) if aspect >= 1 else (
            max(1, int(side * aspect)), side)
        out.append((h, w))
    return out


def images(sizes: List[tuple], seed: int) -> List[np.ndarray]:
    """uint8 (h, w, 3) pixels for each size, from the run's seed."""
    r = rng(seed, "pixels")
    return [r.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for h, w in sizes]


def serve_requests(traffic: Dict[str, Any], n: int, seed: int, phase: str) -> List[Dict]:
    """n requests of one phase: question, answer length and image index.
    The sizes come from the mix's base seed in blocks of `block` requests
    (the same block repeated); the run's seed orders each block and draws
    the text, so any stretch of a block's length holds the same mix."""
    block = min(n, traffic.get("block", n)) or 1
    base = rng(traffic["base_seed"], "sizes", phase)
    q = lengths(base, block, traffic["question_tokens"])
    out = lengths(base, block, traffic["output_tokens"])
    order = rng(seed, "order", phase)
    text = rng(seed, "text", phase)
    reqs = []
    for start in range(0, n, block):
        for i in order.permutation(block)[:n - start]:
            reqs.append({"question": question_text(text, int(q[i])),
                         "question_tokens": int(q[i]), "new_tokens": int(out[i]),
                         "image": int((start + i) % traffic["image_pool"])})
    return reqs


def open_loop(traffic: Dict[str, Any], rate: float, seconds: float, seed: int) -> List[Dict]:
    """Every request of an open-loop run, sorted by due time (seconds from
    the start of the lead-in): the lead-in, then the window [lead_in,
    lead_in + seconds), then a tail that keeps the load on while the
    window's requests finish. Each carries its `phase`."""
    spans = (("lead_in", 0.0, traffic["lead_in_s"]),
             ("window", traffic["lead_in_s"], seconds),
             ("tail", traffic["lead_in_s"] + seconds, traffic["tail_limit_s"]))
    out = []
    for phase, start, span in spans:
        n = int(round(rate * span))
        due = arrivals(rng(traffic["base_seed"], "arrivals", phase), rng(seed, "gaps", phase),
                       n, span)
        for t, req in zip(due, serve_requests(traffic, n, seed, phase)):
            out.append(dict(req, due=start + float(t), phase=phase))
    out.sort(key=lambda r: r["due"])
    return out


def pool_images(traffic: Dict[str, Any], seed: int) -> List[np.ndarray]:
    base = rng(traffic["base_seed"], "image_sizes")
    sizes = image_sizes(base, traffic, traffic["image_pool"])
    order = rng(seed, "image_order").permutation(len(sizes))
    return images([sizes[i] for i in order], seed)


IGNORE = -100  # a label the loss leaves out


def train_samples(mix: Dict[str, Any], vocab: int, image_id: int, image_tokens: int,
                  seed: int) -> List[Dict[str, Any]]:
    """The run's training samples in the dataset's example layout
    ({"input_ids", "labels", "tiles", "media_positions"}): a share with one
    image (its placeholder run and a newline first), the rest text only;
    a prompt part masked from the loss, then the answer. Sizes from the
    mix's base seed, order, token ids and tiles from the run's. Text ids
    are drawn from [first_text_id, vocab), clear of the special tokens."""
    n = mix["pool"]
    base = rng(mix["base_seed"], "samples")
    has_image = base.random(n) < mix["image_share"]
    img_len = lengths(base, n, mix["image_text_tokens"])
    txt_len = lengths(base, n, mix["text_tokens"])
    order = rng(seed, "sample_order").permutation(n)
    ids_rng = rng(seed, "token_ids")
    tiles = tile_pool(mix, seed)
    out = []
    for i in order:
        t = int(img_len[i] if has_image[i] else txt_len[i])
        p = max(1, int(round(mix["prompt_share"] * t)))
        text = ids_rng.integers(mix["first_text_id"], vocab, size=t, dtype=np.int64)
        head = [image_id] * image_tokens + [10] if has_image[i] else []
        ids = np.concatenate([np.asarray(head, np.int64), text]).astype(np.int32)
        labels = ids.copy()
        labels[:len(head) + p] = IGNORE
        k = int(ids_rng.integers(0, len(tiles)))
        out.append({"input_ids": ids, "labels": labels,
                    "tiles": tiles[k:k + 1] if has_image[i] else tiles[:0],
                    "media_positions": np.arange(image_tokens if has_image[i] else 0,
                                                 dtype=np.int32)})
    return out


def tile_pool(mix: Dict[str, Any], seed: int) -> np.ndarray:
    """(n, s, s, 3) uint8 tiles, the samples' images as the dataset
    hands them over (already resized to the tower's size)."""
    s = mix["tile_size"]
    return rng(seed, "tiles").integers(0, 256, size=(mix["tile_pool"], s, s, 3),
                                       dtype=np.uint8)


def rows(samples: List[Dict[str, Any]], seq_len: int, count: int) -> List[List[Dict]]:
    """`count` rows' samples: each takes the next samples in order while
    they fit in `seq_len` tokens (cycling over the list), so no sample is
    cut."""
    out, i = [], 0
    for _ in range(count):
        row, used = [], 0
        while used + len(samples[i % len(samples)]["input_ids"]) <= seq_len:
            used += len(samples[i % len(samples)]["input_ids"])
            row.append(samples[i % len(samples)])
            i += 1
        out.append(row)
    return out
