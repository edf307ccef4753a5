"""Uniform load / save by extension, as `vila_tpu/utils/io.py` (reference:
llava/utils/io.py:11-28). YAML goes through the port's own reader and
writer (`utils/yaml_lite.py`): the card's host has no PyYAML."""

from __future__ import annotations

import json
import os
from typing import Any


def load(path: str, **kwargs) -> Any:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path) as f:
            return json.load(f, **kwargs)
    if ext == ".jsonl":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    if ext in (".yaml", ".yml"):
        from vila_tpu_torch.utils import yaml_lite

        return yaml_lite.load_file(path)
    if ext == ".npy":
        import numpy as np

        return np.load(path, allow_pickle=True)
    raise ValueError(f"unsupported extension: {ext}")


def save(path: str, obj: Any, **kwargs) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        with open(path, "w") as f:
            json.dump(obj, f, **kwargs)
        return
    if ext == ".jsonl":
        with open(path, "w") as f:
            for item in obj:
                f.write(json.dumps(item) + "\n")
        return
    if ext in (".yaml", ".yml"):
        from vila_tpu_torch.utils import yaml_lite

        with open(path, "w") as f:
            f.write(yaml_lite.dump(obj))
        return
    if ext == ".npy":
        import numpy as np

        np.save(path, obj)
        return
    raise ValueError(f"unsupported extension: {ext}")
