"""Collators: padded batching and segment-ids sample packing.

Capability parity: `DataCollator` (llava/data/collate.py:14-159 — padding,
media-count validation, truncation) and the packing performed by
`repack_multimodal_data`'s no-SP path (llava_arch.py:744-768). Varlen
unpadding is replaced by **segment-ids packing**: multiple samples share one
row, RoPE positions restart per sample, and the attention kernels mask
cross-segment pairs.

All outputs are static-shape numpy arrays matching
`vila_tpu_torch.models.vlm.forward_batch`'s batch layout. A copy of
`vila_tpu/data/collate.py`, PS3's high-res tiles and selection maps
(`_collate_ps3_extras`) included: as there, only `Collator` carries them,
and as one array, so one high-res scale.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vila_tpu_torch.constants import IGNORE_INDEX

OOB = 1 << 30  # sentinel media position: dropped by the scatter


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _truncate_example(e: Dict[str, Any], n: int) -> Dict[str, Any]:
    """Truncate a sample to n tokens; drop tiles whose media tokens are
    entirely cut so the vision tower doesn't run on unused tiles."""
    if len(e["input_ids"]) <= n:
        return e
    out = dict(e)
    out["input_ids"] = e["input_ids"][:n]
    out["labels"] = e["labels"][:n]
    tiles = e["tiles"]
    if tiles.shape[0]:
        toks_per_tile = len(e["media_positions"]) // tiles.shape[0]
        mp = np.asarray(e["media_positions"]).reshape(
            tiles.shape[0], toks_per_tile
        )
        keep = (mp < n).any(axis=1)  # tile contributes ≥1 surviving token
        mp = mp[keep].reshape(-1)
        out["tiles"] = tiles[keep]
        # keep tile alignment: feature k scatters to media_positions[k], so
        # truncated positions become OOB sentinels instead of being removed
        out["media_positions"] = np.where(mp < n, mp, OOB)
    return out


@dataclasses.dataclass
class Collator:
    """Pad examples to a (B, S) batch; per-sample tiles padded to a common
    tile count."""

    seq_len: int
    pad_token_id: int = 0
    seq_multiple: int = 1  # pad S to a multiple (SP wants sp or 2*sp)
    tile_size: int = 448  # dummy-tile size when a batch mixes media/no-media

    def __call__(self, examples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        b = len(examples)
        s = _round_up(self.seq_len, self.seq_multiple)
        any_tiles = any(e["tiles"].shape[0] for e in examples)
        max_tiles = max(max((e["tiles"].shape[0] for e in examples), default=1), 1)
        tile_shape = None
        for e in examples:
            if e["tiles"].shape[0]:
                tile_shape = e["tiles"].shape[1:]
                break
        if tile_shape is None:
            tile_shape = (self.tile_size, self.tile_size, 3)

        # tokens contributed per tile (uniform within a batch)
        toks_per_tile = None
        for e in examples:
            if e["tiles"].shape[0]:
                toks_per_tile = len(e["media_positions"]) // e["tiles"].shape[0]
                break
        m = max_tiles * (toks_per_tile or 1)

        out = {
            "input_ids": np.full((b, s), self.pad_token_id, np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "positions": np.zeros((b, s), np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
            "pixel_values": np.zeros((b, max_tiles) + tile_shape, np.uint8),
            "media_positions": np.full((b, m), OOB, np.int32),
        }
        for i, e in enumerate(examples):
            ids = e["input_ids"][:s]
            n = len(ids)
            out["input_ids"][i, :n] = ids
            out["labels"][i, :n] = e["labels"][:n]
            out["positions"][i, :n] = np.arange(n)
            out["segment_ids"][i, :n] = 1
            t = e["tiles"].shape[0]
            if t:
                out["pixel_values"][i, :t] = e["tiles"]
                mp = e["media_positions"]
                mp = mp[mp < s]  # truncated media tokens are dropped
                out["media_positions"][i, : len(mp)] = mp
        _collate_ps3_extras(out, examples, max_tiles)
        if not any_tiles:
            # media-free batch: skip the vision forward entirely
            del out["pixel_values"], out["media_positions"]
        return out


def _collate_ps3_extras(out, examples, max_tiles) -> None:
    """PS3 batch keys: high-res tiles and gt selection maps, per tile
    (reference: `gt_selection_maps` stacking in llava/data/collate.py:138-158).
    Samples carry optional "tiles_high" (T, s1, s1, 3) and
    "gt_selection_map" (T, gh, gw)."""
    if not any(e.get("tiles_high") is not None and len(e["tiles_high"])
               for e in examples):
        return
    b = len(examples)
    hi_shape = next(
        e["tiles_high"].shape[1:]
        for e in examples
        if e.get("tiles_high") is not None and len(e["tiles_high"])
    )
    out["pixel_values_high"] = np.zeros((b, max_tiles) + hi_shape, np.uint8)
    gt_shape = None
    for e in examples:
        if e.get("gt_selection_map") is not None:
            gt_shape = e["gt_selection_map"].shape[1:]
            break
    if gt_shape is not None:
        out["gt_selection_maps"] = np.zeros(
            (b, max_tiles) + gt_shape, np.float32
        )
    for i, e in enumerate(examples):
        th = e.get("tiles_high")
        if th is not None and len(th):
            out["pixel_values_high"][i, : th.shape[0]] = th
        gm = e.get("gt_selection_map")
        if gt_shape is not None and gm is not None:
            out["gt_selection_maps"][i, : gm.shape[0]] = gm


@dataclasses.dataclass
class PackingCollator:
    """Pack many samples into few rows with segment ids (greedy first-fit).

    The media scatter stays row-local: each packed sample's media positions
    shift by its offset within the row.
    """

    seq_len: int
    rows: int = 1
    pad_token_id: int = 0
    seq_multiple: int = 1
    tile_size: int = 448

    def __call__(self, examples: Sequence[Dict[str, Any]]) -> Dict[str, np.ndarray]:
        s = _round_up(self.seq_len, self.seq_multiple)
        rows: List[List[Dict[str, Any]]] = [[] for _ in range(self.rows)]
        used = [0] * self.rows
        for e in examples:
            n = min(len(e["input_ids"]), s)
            # first-fit; when nothing fits, truncate into the emptiest row
            # (the reference truncates rather than dropping samples,
            # llava/data/collate.py:100-118 / __truncate_sequence).
            r = next(
                (i for i in range(self.rows) if used[i] + n <= s), None
            )
            if r is None:
                r = min(range(self.rows), key=lambda i: used[i])
                n = s - used[r]
                if n <= 1:
                    continue  # row completely full; nothing sensible to keep
            rows[r].append(_truncate_example(e, n))
            used[r] += n

        b = self.rows
        tile_counts = [
            sum(e["tiles"].shape[0] for e in row) for row in rows
        ]
        max_tiles = max(max(tile_counts), 1)
        tile_shape = (self.tile_size, self.tile_size, 3)
        toks_per_tile = 1
        for row in rows:
            for e in row:
                if e["tiles"].shape[0]:
                    tile_shape = e["tiles"].shape[1:]
                    toks_per_tile = (
                        len(e["media_positions"]) // e["tiles"].shape[0]
                    )
                    break

        m = max_tiles * toks_per_tile
        out = {
            "input_ids": np.full((b, s), self.pad_token_id, np.int32),
            "labels": np.full((b, s), IGNORE_INDEX, np.int32),
            "positions": np.zeros((b, s), np.int32),
            "segment_ids": np.zeros((b, s), np.int32),
            "pixel_values": np.zeros((b, max_tiles) + tile_shape, np.uint8),
            "media_positions": np.full((b, m), OOB, np.int32),
        }
        for r, row in enumerate(rows):
            off = 0
            tile_off = 0
            mp_off = 0
            for seg, e in enumerate(row, start=1):
                n = len(e["input_ids"])
                out["input_ids"][r, off : off + n] = e["input_ids"]
                out["labels"][r, off : off + n] = e["labels"]
                # Mask the first token of each packed sample to avoid
                # cross-sample label contamination (llava_arch.py:761-763).
                out["labels"][r, off] = IGNORE_INDEX
                out["positions"][r, off : off + n] = np.arange(n)
                out["segment_ids"][r, off : off + n] = seg
                t = e["tiles"].shape[0]
                if t:
                    out["pixel_values"][r, tile_off : tile_off + t] = e["tiles"]
                    mp = e["media_positions"] + off
                    out["media_positions"][r, mp_off : mp_off + len(mp)] = mp
                    tile_off += t
                    mp_off += len(mp)
                off += n
        if not any(tile_counts):
            del out["pixel_values"], out["media_positions"]
        return out
