"""Long-video training samples for the sequence-parallel cells: a mix's
parameters (`traffic/<name>.json`, loop "train_sp") made into samples in
the dataset's example layout, as `traffic.train_samples` makes image
samples.

A sample is one video: its frames' media tokens (a run of
`tokens_per_frame` placeholders a frame), a newline, then the text, whose
first `question_share` is the question (masked from the loss) and the rest
the answer (labelled); media tokens are never labelled. Frame counts are
uniform over `frames["uniform"]` x `frames["step"]`, text lengths
log-uniform over [min, max]. Sizes come from the mix's `base_seed`; the
run's seed orders the samples and draws the token ids and each frame's
tile from a pool of `tile_pool` tiles. A sample holds its frames as
indices into the pool (`frame_ids`); `with_tiles` gives it its pixels,
one row at a time, so that a run never holds every sample's frames.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

import numpy as np

from port_bench import traffic

IGNORE = traffic.IGNORE


def sizes(mix: Dict[str, Any]):
    """(frames, text tokens) of each of the pool's samples."""
    base = traffic.rng(mix["base_seed"], "video_samples")
    n = mix["pool"]
    lo, hi = mix["frames"]["uniform"]
    frames = base.integers(lo, hi + 1, size=n) * mix["frames"]["step"]
    t_lo, t_hi = mix["text_tokens"]["min"], mix["text_tokens"]["max"]
    text = np.exp(base.uniform(math.log(t_lo), math.log(t_hi), size=n))
    return frames, np.clip(np.rint(text), t_lo, t_hi).astype(np.int64)


def samples(mix: Dict[str, Any], vocab: int, image_id: int, tokens_per_frame: int,
            seed: int) -> List[Dict[str, Any]]:
    """The run's samples ({"input_ids", "labels", "frame_ids",
    "media_positions"}), in the run's order."""
    frames, text = sizes(mix)
    order = traffic.rng(seed, "video_order").permutation(len(frames))
    ids_rng = traffic.rng(seed, "video_token_ids")
    out = []
    for i in order:
        f, t = int(frames[i]), int(text[i])
        media = f * tokens_per_frame
        body = ids_rng.integers(mix["first_text_id"], vocab, size=t, dtype=np.int64)
        ids = np.concatenate([np.full(media, image_id, np.int64), [10], body]).astype(np.int32)
        labels = ids.copy()
        labels[:media + 1 + max(1, int(round(mix["question_share"] * t)))] = IGNORE
        out.append({"input_ids": ids, "labels": labels,
                    "frame_ids": ids_rng.integers(0, mix["tile_pool"], size=f),
                    "media_positions": np.arange(media, dtype=np.int32)})
    return out


def with_tiles(row: List[Dict[str, Any]], pool: np.ndarray) -> List[Dict[str, Any]]:
    """A row's samples with their frames' pixels (`tiles`, (frames, s, s,
    3) uint8) from the tile pool."""
    return [dict(s, tiles=pool[s["frame_ids"]]) for s in row]
