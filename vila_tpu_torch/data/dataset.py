"""Datasets: conversation -> tokenized, media-expanded training examples, as
`vila_tpu/data/dataset.py` (images with the resize and pad aspect modes;
video samples and the dynamic tilings in training are not ported yet).

Examples are host-side dicts with **media markers already expanded** into
fixed placeholder runs so the device path is shape-static:
  {"input_ids": (S,) int32, "labels": (S,) int32,
   "tiles": (T, s, s, 3) uint8, "media_positions": (M,) int32}
"""

from __future__ import annotations

import copy
import json
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vila_tpu_torch.constants import IGNORE_INDEX, MEDIA_TOKENS
from vila_tpu_torch.data import preprocess
from vila_tpu_torch.data.tokenizer_utils import preprocess_conversation


def load_records(path: str) -> List[Dict[str, Any]]:
    """A .json list or .jsonl file of records."""
    with open(path) as f:
        if path.lower().endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def expand_media_with_labels(
    input_ids: np.ndarray,
    labels: np.ndarray,
    marker_id: int,
    tokens_per_marker: List[int],
    end_ids: Sequence[int],
):
    """expand_media_tokens + parallel label expansion (placeholders and
    encoder end-tokens get IGNORE_INDEX)."""
    out_ids: List[int] = []
    out_labels: List[int] = []
    positions: List[int] = []
    m = 0
    for tok, lab in zip(input_ids.tolist(), labels.tolist()):
        if tok == marker_id:
            n = tokens_per_marker[m]
            m += 1
            positions.extend(range(len(out_ids), len(out_ids) + n))
            out_ids.extend([marker_id] * n)
            out_labels.extend([IGNORE_INDEX] * n)
            out_ids.extend(end_ids)
            out_labels.extend([IGNORE_INDEX] * len(end_ids))
        else:
            out_ids.append(tok)
            out_labels.append(lab)
    if m != len(tokens_per_marker):
        raise ValueError(
            f"media count mismatch: {len(tokens_per_marker)} vs {m} markers"
        )
    return (
        np.asarray(out_ids, np.int32),
        np.asarray(out_labels, np.int32),
        np.asarray(positions, np.int32),
    )


class BaseDataset:
    """Conversation-json dataset with media processing.

    Subclasses (or instances) provide `self.instances`: a list of dicts with
    'conversations' ([{'from', 'value'}]) and optional 'image' paths (or
    in-memory images: uint8 arrays, PIL images).
    """

    def __init__(
        self,
        tokenizer,
        cfg,  # vlm.VLMConfig
        data_path: Optional[str] = None,
        media_dir: Optional[str] = None,
        instances: Optional[List[Dict[str, Any]]] = None,
        resample_on_failure: bool = True,
    ) -> None:
        self.tokenizer = tokenizer
        self.cfg = cfg
        self.media_dir = media_dir
        self.resample_on_failure = resample_on_failure
        if instances is not None:
            self.instances = instances
        elif data_path is not None:
            self.instances = load_records(data_path)
        else:
            self.instances = []
        self._newline_ids = tuple(
            tokenizer("\n", add_special_tokens=False).input_ids
        )
        self._image_token_id = tokenizer.media_token_ids["image"]

    def __len__(self) -> int:
        return len(self.instances)

    def _media_path(self, name):
        if (
            isinstance(name, str)
            and self.media_dir
            and not os.path.isabs(name)
        ):
            return os.path.join(self.media_dir, name)
        return name  # in-memory images pass through

    def process(self, instance: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.cfg
        conversations = copy.deepcopy(instance["conversations"])
        if instance.get("video"):
            raise NotImplementedError("video samples in training are not ported yet")

        images: List[Any] = []
        names = instance.get("image")
        if isinstance(names, np.ndarray) or names:  # an array image, or paths
            if not isinstance(names, list):
                names = [names]
            images = [
                preprocess.load_image(self._media_path(n)) for n in names
            ]

        # Ensure the image markers exist in the text (reference prepends
        # them to the first human turn when missing).
        n_markers = sum(
            msg["value"].count(MEDIA_TOKENS["image"]) for msg in conversations
        )
        if images and n_markers == 0:
            conversations[0]["value"] = (
                MEDIA_TOKENS["image"] * len(images) + "\n"
                + conversations[0]["value"]
            )
            n_markers = len(images)
        if n_markers != len(images):
            raise ValueError(
                f"media tokens ({n_markers}) != media objects ({len(images)})"
            )

        aspect = cfg.image_aspect_ratio
        if aspect not in ("resize", "pad", None):
            raise NotImplementedError(
                f"image_aspect_ratio={aspect!r} in training is not ported yet")
        tiles_list: List[np.ndarray] = []
        for img in images:
            tiles, _ = preprocess.process_image(
                img, image_size=cfg.vision.image_size, image_aspect_ratio=aspect)
            tiles_list.append(tiles)
        tokens_per_marker = [cfg.tokens_per_image] * len(images)

        data = preprocess_conversation(conversations, self.tokenizer)
        ids, labels, media_pos = expand_media_with_labels(
            data["input_ids"], data["labels"],
            self._image_token_id, tokens_per_marker, self._newline_ids,
        )
        return {
            "input_ids": ids,
            "labels": labels,
            "media_positions": media_pos,
            "tiles": np.concatenate(tiles_list)
            if tiles_list
            else np.zeros(
                (0, cfg.vision.image_size, cfg.vision.image_size, 3), np.uint8
            ),
        }

    def __getitem__(self, index: int) -> Dict[str, Any]:
        try:
            return self.process(self.instances[index])
        except Exception:
            if not self.resample_on_failure:
                raise
            # resample-on-failure (reference: data/base.py:181-186)
            return self[random.randint(0, len(self) - 1)]


class RepeatedDataset:
    """Repeat a dataset N times (reference: data/builder.py RepeatedDataset)."""

    def __init__(self, dataset, times: int) -> None:
        self.dataset = dataset
        self.times = times

    def __len__(self) -> int:
        return len(self.dataset) * self.times

    def __getitem__(self, index: int):
        return self.dataset[index % len(self.dataset)]


class SubsetDataset:
    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, index: int):
        return self.dataset[self.indices[index]]


class ConcatDataset:
    def __init__(self, datasets: Sequence) -> None:
        self.datasets = list(datasets)
        self.offsets = []
        total = 0
        for d in self.datasets:
            self.offsets.append(total)
            total += len(d)
        self.total = total

    def __len__(self) -> int:
        return self.total

    def __getitem__(self, index: int):
        for ds, off in zip(reversed(self.datasets), reversed(self.offsets)):
            if index >= off:
                return ds[index - off]
        raise IndexError(index)
