"""Interleaved image-text and caption-pair pretraining datasets, as
`vila_tpu/data/interleaved.py`.

Capability parity:
  * `LazyMMC4Dataset` (llava/data/dataset.py:553): interleaved image-text
    documents; images are spliced BEFORE their matched sentences
    (:676-690), at most `max_images` images per sample (:668-674, ref 6),
    and labels are autoregressive over ALL text (:739).
  * `LazyCoyoDataset` (llava/data/dataset.py:770): (image, caption) pairs
    packed `n_samples_per_idx` (ref 4) per item to token-balance against
    MMC4 (:784,836-844).
  * `LazyWDSDataset` / `VILAWebDataset` shard reading via the native
    indexed-tar layer (`data/tario.py`).

Output format matches BaseDataset: {"input_ids", "labels", "tiles",
"media_positions"} with media markers pre-expanded.
"""

from __future__ import annotations

import io
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.data import preprocess
from vila_tpu_torch.data.dataset import expand_media_with_labels


def _tile(img, cfg) -> np.ndarray:
    tiles, _ = preprocess.process_image(
        img, image_size=cfg.vision.image_size, image_aspect_ratio="resize"
    )
    return tiles


class InterleavedDataset:
    """MMC4-style interleaved documents.

    Instances: {"texts": [str, ...], "images": [path|PIL|bytes, ...],
                "matched_idx": [sentence index per image]}.
    """

    def __init__(
        self,
        tokenizer,
        cfg,
        instances: Optional[List[Dict[str, Any]]] = None,
        data_path: Optional[str] = None,
        max_images: int = 6,
        max_length: int = 4096,
    ) -> None:
        from vila_tpu_torch.utils.io import load as io_load

        self.tokenizer = tokenizer
        self.cfg = cfg
        self.max_images = max_images
        self.max_length = max_length
        self.instances = (
            instances if instances is not None else io_load(data_path)
        )
        self._image_id = tokenizer.media_token_ids["image"]
        self._newline_ids = tuple(
            tokenizer("\n", add_special_tokens=False).input_ids
        )

    def __len__(self) -> int:
        return len(self.instances)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        inst = self.instances[index]
        texts: List[str] = list(inst["texts"])
        images = list(inst.get("images", []))[: self.max_images]
        matched = list(inst.get("matched_idx", []))[: self.max_images]

        # splice image markers before their matched sentences (dataset.py:676)
        parts: List[str] = []
        for i, sent in enumerate(texts):
            for img_i, m in enumerate(matched):
                if m == i:
                    parts.append(MEDIA_TOKENS["image"])
            parts.append(sent)
        text = " ".join(parts)

        ids = np.asarray(
            self.tokenizer(text, add_special_tokens=True).input_ids, np.int32
        )[: self.max_length]
        # autoregressive labels on all text (dataset.py:739)
        labels = ids.copy()

        tiles_list = [
            _tile(preprocess.load_image(img), self.cfg) for img in images
        ]
        n_markers = int((ids == self._image_id).sum())
        tiles_list = tiles_list[:n_markers]  # truncation may drop images
        tokens_per_marker = [self.cfg.tokens_per_image] * len(tiles_list)
        # drop any marker beyond the loaded images
        if n_markers > len(tiles_list):
            keep = 0
            out = []
            for t in ids.tolist():
                if t == self._image_id:
                    if keep >= len(tiles_list):
                        continue
                    keep += 1
                out.append(t)
            ids = np.asarray(out, np.int32)
            labels = ids.copy()

        ids, labels, media_pos = expand_media_with_labels(
            ids, labels, self._image_id, tokens_per_marker, self._newline_ids
        )
        tiles = (
            np.concatenate(tiles_list)
            if tiles_list
            else np.zeros(
                (0, self.cfg.vision.image_size, self.cfg.vision.image_size, 3),
                np.uint8,
            )
        )
        return {
            "input_ids": ids,
            "labels": labels,
            "tiles": tiles,
            "media_positions": media_pos,
        }


class CaptionPairDataset:
    """COYO-style (image, caption) pairs, `n_samples_per_idx` packed per
    item for token balance (dataset.py:784)."""

    def __init__(
        self,
        tokenizer,
        cfg,
        instances: Optional[List[Dict[str, Any]]] = None,
        data_path: Optional[str] = None,
        n_samples_per_idx: int = 4,
    ) -> None:
        from vila_tpu_torch.utils.io import load as io_load

        self.tokenizer = tokenizer
        self.cfg = cfg
        self.n = n_samples_per_idx
        self.pairs = instances if instances is not None else io_load(data_path)
        self._image_id = tokenizer.media_token_ids["image"]
        self._newline_ids = tuple(
            tokenizer("\n", add_special_tokens=False).input_ids
        )

    def __len__(self) -> int:
        return len(self.pairs) // self.n

    def __getitem__(self, index: int) -> Dict[str, Any]:
        group = self.pairs[index * self.n : (index + 1) * self.n]
        text = "".join(
            MEDIA_TOKENS["image"] + p["caption"] + self.tokenizer.eos_token
            for p in group
        )
        ids = np.asarray(
            self.tokenizer(text, add_special_tokens=False).input_ids, np.int32
        )
        labels = ids.copy()
        tiles_list = [
            _tile(preprocess.load_image(p["image"]), self.cfg) for p in group
        ]
        tokens_per_marker = [self.cfg.tokens_per_image] * len(group)
        ids, labels, media_pos = expand_media_with_labels(
            ids, labels, self._image_id, tokens_per_marker, self._newline_ids
        )
        return {
            "input_ids": ids,
            "labels": labels,
            "tiles": np.concatenate(tiles_list),
            "media_positions": media_pos,
        }


class WebDatasetSupervised:
    """Supervised samples out of webdataset tar shards via the native
    indexed reader (LazyWDSDataset / VILAWebDataset parity).

    Each shard sample: {jpg|png: image bytes, json|txt: caption or
    conversation json}."""

    def __init__(self, tokenizer, cfg, shard_paths: Sequence[str]) -> None:
        from vila_tpu_torch.data.tario import ShardedTarDataset

        self.inner = ShardedTarDataset(list(shard_paths))
        self.tokenizer = tokenizer
        self.cfg = cfg
        self._image_id = tokenizer.media_token_ids["image"]
        self._newline_ids = tuple(
            tokenizer("\n", add_special_tokens=False).input_ids
        )

    def __len__(self) -> int:
        return len(self.inner)

    def __getitem__(self, index: int) -> Dict[str, Any]:
        from PIL import Image as PILImage

        raw = self.inner[index]
        img_bytes = raw.get("jpg") or raw.get("png") or raw.get("jpeg")
        caption = None
        if "json" in raw:
            meta = json.loads(raw["json"])
            caption = meta.get("caption") or meta.get("text")
        elif "txt" in raw:
            caption = raw["txt"].decode()
        assert img_bytes is not None and caption is not None, raw.keys()

        img = PILImage.open(io.BytesIO(img_bytes)).convert("RGB")
        text = MEDIA_TOKENS["image"] + caption + self.tokenizer.eos_token
        ids = np.asarray(
            self.tokenizer(text, add_special_tokens=False).input_ids, np.int32
        )
        labels = ids.copy()
        ids, labels, media_pos = expand_media_with_labels(
            ids, labels, self._image_id,
            [self.cfg.tokens_per_image], self._newline_ids,
        )
        return {
            "input_ids": ids,
            "labels": labels,
            "tiles": _tile(img, self.cfg),
            "media_positions": media_pos,
        }
