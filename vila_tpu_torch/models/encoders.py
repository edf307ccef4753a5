"""Media encoders: token assembly for videos, as
`vila_tpu/models/encoders.py` (capability parity: `TSPVideoEncoder`,
llava/model/encoders/video/tsp.py:15): temporal-spatial mean pooling of
per-frame projector features over (t, h, w) sizes, one block per pool
size, concatenated.

The encoders' start, end and separator tokens are real text token ids
that the host inserts during media expansion (`inference/generate.py`);
only the pooling runs here.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from vila_tpu_torch.models import vlm


def tsp_pool(feats: torch.Tensor, pool_size: Tuple[int, int, int]) -> torch.Tensor:
    """(T, S, D) per-frame features, S = nl*nl, mean-pooled over (t, h, w)
    (video/tsp.py:11-13) -> (T//t, (nl//h)*(nl//w), D)."""
    t, s, d = feats.shape
    nl = int(round(s ** 0.5))
    assert nl * nl == s, f"non-square token grid: {s}"
    pt, ph, pw = pool_size
    assert t % pt == 0 and nl % ph == 0 and nl % pw == 0, (
        f"pool {pool_size} does not divide ({t},{nl},{nl})")
    x = feats.reshape(t // pt, pt, nl // ph, ph, nl // pw, pw, d)
    x = x.mean(dim=(1, 3, 5))
    return x.reshape(t // pt, (nl // ph) * (nl // pw), d)


def tsp_encode_video(params: Dict[str, Any], cfg: vlm.VLMConfig, frames: torch.Tensor,
                     pool_sizes: Sequence[Tuple[int, int, int]]) -> torch.Tensor:
    """(T, H, W, 3) uint8 frames -> (M, D) flat tokens, M the sum over the
    pool sizes of (T/t)*(nl/h)*(nl/w) (video/tsp.py:28-52)."""
    feats = vlm.encode_images(params, cfg, frames)  # (T, S, D)
    blocks = [tsp_pool(feats, ps) for ps in pool_sizes]
    return torch.cat([b.reshape(-1, b.shape[-1]) for b in blocks], dim=0)


def tsp_tokens_per_video(cfg: vlm.VLMConfig, num_frames: int,
                         pool_sizes: Sequence[Tuple[int, int, int]]) -> int:
    """Host-side token count of one video, for marker expansion."""
    nl = int(round(cfg.tokens_per_image ** 0.5))
    return sum((num_frames // pt) * (nl // ph) * (nl // pw) for pt, ph, pw in pool_sizes)
