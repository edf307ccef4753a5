"""Datasets: conversation -> tokenized, media-expanded training examples, as
`vila_tpu/data/dataset.py` (`BaseDataset.__getitem__`, llava/data/base.py:
99-188, and the video branch of `LazySupervisedDataset`, llava/data/
dataset.py:266-337): images (resize, pad, and for a single image the
`dynamic` and `dynamic_s2` tilings; several images are resized) and videos
(each `<video>` marker becomes one image marker per frame).

Examples are host-side dicts with **media markers already expanded** into
fixed placeholder runs so the device path is shape-static:
  {"input_ids": (S,) int32, "labels": (S,) int32,
   "tiles": (T, s, s, 3) uint8, "media_positions": (M,) int32}
and, for a dynamic-S2 image, "block_sizes": [(rows, cols)]. As in the JAX
package, the collators and `vlm.forward_batch` treat every tile as one
plain image, which a dynamic-S2 sample's tokens do not fit (`ROADMAP.md`
§3, faults of the reference).
"""

from __future__ import annotations

import copy
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from vila_tpu_torch.constants import IGNORE_INDEX, MEDIA_TOKENS
from vila_tpu_torch.data import preprocess
from vila_tpu_torch.data.tokenizer_utils import preprocess_conversation
from vila_tpu_torch.utils.io import load as io_load


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
    in-memory images: uint8 arrays, PIL images) and 'video' (a file, a
    directory of frames, or a `media.Video` of frames).
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
            self.instances = io_load(data_path)
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

        images: List[Any] = []
        names = instance.get("image")
        if isinstance(names, np.ndarray) or names:  # an array image, or paths
            if not isinstance(names, list):
                names = [names]
            images = [
                preprocess.load_image(self._media_path(n)) for n in names
            ]
        if instance.get("video"):
            from vila_tpu_torch.utils.media_loader import load_video_frames

            names = instance["video"]
            if not isinstance(names, list):
                names = [names]
            for n in names:
                frames = load_video_frames(
                    self._media_path(n), cfg.num_video_frames, cfg.fps
                )
                images.extend(frames)
                # Video markers become per-frame image markers
                # (reference: dataset.py:266-337).
                for msg in conversations:
                    if MEDIA_TOKENS["video"] in msg["value"]:
                        msg["value"] = msg["value"].replace(
                            MEDIA_TOKENS["video"],
                            MEDIA_TOKENS["image"] * len(frames),
                            1,
                        )

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

        # Tile images: the reference tiles dynamically only a single image.
        tiles_list: List[np.ndarray] = []
        tokens_per_marker: List[int] = []
        block_sizes: List[Any] = []
        aspect = cfg.image_aspect_ratio
        use_dynamic = aspect in ("dynamic", "dynamic_s2") and len(images) == 1
        for img in images:
            if use_dynamic and aspect == "dynamic":
                tiles, _ = preprocess.process_image(
                    img, image_size=cfg.vision.image_size,
                    image_aspect_ratio="dynamic",
                    min_tiles=cfg.min_tiles, max_tiles=cfg.max_tiles,
                )
                # a marker (and a "\n") per tile
                for msg in conversations:
                    if MEDIA_TOKENS["image"] in msg["value"]:
                        msg["value"] = msg["value"].replace(
                            MEDIA_TOKENS["image"],
                            f"{MEDIA_TOKENS['image']}\n" * tiles.shape[0],
                            1,
                        )
                        break
                tokens_per_marker.extend([cfg.tokens_per_image] * tiles.shape[0])
            elif use_dynamic and aspect == "dynamic_s2":
                from vila_tpu_torch.models import s2

                tiles, block = preprocess.process_image(
                    img, image_size=cfg.vision.image_size,
                    image_aspect_ratio="dynamic_s2",
                    max_tiles=cfg.max_tiles, s2_scales=cfg.s2_scales,
                )
                block_sizes.append(block)
                tokens_per_marker.append(s2.tokens_for_block_size(cfg, block))
            else:
                tiles, _ = preprocess.process_image(
                    img, image_size=cfg.vision.image_size,
                    image_aspect_ratio=(
                        "resize" if aspect in ("dynamic", "dynamic_s2") else aspect
                    ),
                )
                tokens_per_marker.append(cfg.tokens_per_image)
            tiles_list.append(tiles)

        data = preprocess_conversation(conversations, self.tokenizer)
        ids, labels, media_pos = expand_media_with_labels(
            data["input_ids"], data["labels"],
            self._image_token_id, tokens_per_marker, self._newline_ids,
        )
        out = {
            "input_ids": ids,
            "labels": labels,
            "media_positions": media_pos,
            "tiles": np.concatenate(tiles_list)
            if tiles_list
            else np.zeros(
                (0, cfg.vision.image_size, cfg.vision.image_size, 3), np.uint8
            ),
        }
        if block_sizes:
            out["block_sizes"] = block_sizes
        return out

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
