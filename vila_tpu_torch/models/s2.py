"""Dynamic-S2 multi-scale feature merging, NVILA's high-resolution path, as
`vila_tpu/models/s2.py` (capability parity: `merge_chessboard`,
`split_chessboard`, `merge_features_for_dynamic_s2` and `encode_images`,
llava/model/llava_arch.py:256-394, and `VisionTowerDynamicS2`,
multimodal_encoder/vision_encoder.py:251).

The chessboard merge and split are reshapes and transposes. The
reference's `F.interpolate(mode="area")` (adaptive average pooling) is two
small row-stochastic matrices, one for the rows and one for the columns,
applied in f32 as in the JAX module. The block sizes come from the host's
tiling.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from vila_tpu_torch.models import projector as projector_lib
from vila_tpu_torch.models import siglip
from vila_tpu_torch.utils.device import host_to_device

Params = Dict[str, Any]


def merge_grid(tiles: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(gh*gw, T, C) row-major tiles -> (gh*side, gw*side, C) feature map
    (`merge_chessboard`, llava_arch.py:256-280)."""
    n, t, c = tiles.shape
    side = int(round(math.sqrt(t)))
    x = tiles.reshape(gh, gw, side, side, c).permute(0, 2, 1, 3, 4)
    return x.reshape(gh * side, gw * side, c)


def split_grid(fmap: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(H, W, C) -> (gh*gw, (H/gh)*(W/gw), C) row-major tiles
    (`split_chessboard`, llava_arch.py:283-296)."""
    h, w, c = fmap.shape
    th, tw = h // gh, w // gw
    x = fmap.reshape(gh, th, gw, tw, c).permute(0, 2, 1, 3, 4)
    return x.reshape(gh * gw, th * tw, c)


def _adaptive_avg_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic matrix of torch's adaptive_avg_pool1d
    (= F.interpolate mode='area')."""
    m = np.zeros((n_out, n_in), np.float32)
    for i in range(n_out):
        start = (i * n_in) // n_out
        end = -(-((i + 1) * n_in) // n_out)  # ceil
        m[i, start:end] = 1.0 / (end - start)
    return m


def area_resize(fmap: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C) adaptive average pooling, in f32."""
    h, w, c = fmap.shape
    if h == out_h and w == out_w:
        return fmap
    x = fmap.float()
    if h != out_h:
        ah = host_to_device(_adaptive_avg_matrix(h, out_h), x.device)
        x = torch.einsum("oh,hwc->owc", ah, x)
    if w != out_w:
        aw = host_to_device(_adaptive_avg_matrix(w, out_w), x.device)
        x = torch.einsum("ow,hwc->hoc", aw, x)
    return x.to(fmap.dtype)


def _scale_grids(cfg) -> Tuple[int, ...]:
    s0 = cfg.s2_scales[0]
    return tuple(s // s0 for s in cfg.s2_scales)


def output_block_size(cfg, block_size: Tuple[int, int]) -> Tuple[int, int]:
    """Block grid after merging (llava_arch.py:349-358 new_block_sizes): the
    last scale's aspect-ratio grid for `s2_resize_output_to_scale_idx` -1
    (or the last index), else that scale's square grid."""
    idx = cfg.s2_resize_output_to_scale_idx
    if idx in (len(cfg.s2_scales) - 1, -1):
        return tuple(block_size)
    n = _scale_grids(cfg)[idx]
    return (n, n)


def tokens_for_block_size(cfg, block_size: Tuple[int, int]) -> int:
    """LLM tokens contributed by one dynamic-S2 image."""
    bh, bw = output_block_size(cfg, block_size)
    return bh * bw * cfg.tokens_per_image


def encode_image_s2(params: Params, cfg, tiles: torch.Tensor,
                    block_size: Tuple[int, int]) -> torch.Tensor:
    """Dynamic-S2 encode of one image's tiles (N, S, S, 3), in the order of
    `dynamic_s2_preprocess` (mm_utils.py:341-405: the square grids of
    scales[:-1], then the last scale's aspect-ratio grid `block_size` =
    (rows, cols)) -> (tokens, llm_hidden)."""
    feats = siglip.forward(
        params["vision_tower"], cfg.vision, tiles,
        feature_layer=cfg.vision_feature_layer, select=cfg.vision_select,
    )  # (N, T, C)

    grids = _scale_grids(cfg)
    maps = []
    idx = 0
    for n in grids[:-1]:
        maps.append(merge_grid(feats[idx:idx + n * n], n, n))
        idx += n * n
    bh, bw = block_size
    maps.append(merge_grid(feats[idx:idx + bh * bw], bh, bw))

    out_idx = cfg.s2_resize_output_to_scale_idx
    th, tw = maps[out_idx].shape[0], maps[out_idx].shape[1]
    merged = torch.cat([area_resize(m, th, tw) for m in maps], dim=-1)  # (th, tw, C * scales)

    obh, obw = output_block_size(cfg, block_size)
    proj = projector_lib.forward(params["mm_projector"], cfg.projector,
                                 split_grid(merged, obh, obw))  # (obh*obw, T/r^2, H)
    # one token stream in spatial order (llava_arch.py:379-384)
    out_map = merge_grid(proj, obh, obw)
    return out_map.reshape(-1, out_map.shape[-1])
