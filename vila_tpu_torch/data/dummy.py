"""Synthetic dataset for smoke tests, as `vila_tpu/data/dummy.py`:
deterministic fake conversations, optionally each with one random image.

The image is handed to `process` as the uint8 array itself (the JAX
package wraps it in a PIL image first); the port's preprocessing takes an
array of the tower's size without PIL, and the example is the same bit for
bit.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.data.dataset import BaseDataset


class DummyDataset(BaseDataset):
    def __init__(
        self,
        tokenizer,
        cfg,
        num_instances: int = 64,
        with_images: bool = False,
        seq_len: int = 64,
        **kw: Any,
    ) -> None:
        rng = np.random.default_rng(0)
        instances = []
        for i in range(num_instances):
            q = f"question {i}: " + " ".join(
                str(x) for x in rng.integers(0, 100, 6)
            )
            a = f"answer {i}: " + " ".join(
                str(x) for x in rng.integers(0, 100, 8)
            )
            inst: Dict[str, Any] = {
                "conversations": [
                    {"from": "human", "value": (MEDIA_TOKENS["image"] + "\n" + q) if with_images else q},
                    {"from": "gpt", "value": a},
                ]
            }
            if with_images:
                inst["_dummy_image"] = True
            instances.append(inst)
        super().__init__(tokenizer, cfg, instances=instances, **kw)
        self._with_images = with_images
        self._rng = np.random.default_rng(1)

    def process(self, instance):
        if instance.get("_dummy_image"):
            size = self.cfg.vision.image_size
            inst = dict(instance)
            inst.pop("_dummy_image")
            inst["image"] = self._rng.integers(0, 255, (size, size, 3), np.uint8)
            return super().process(inst)
        return super().process(instance)
