"""Dataset registry and mixture parsing, as `vila_tpu/data/builder.py`:
`+` concatenates, mixture names expand recursively, `*N` repeats and
`@subset` drops the indices listed in `<VILA_SLICE_FOLDER>/<subset>/
<name>.json`.

The registry holds the JAX package's synthetic entries (`dummy`,
`dummy-image`, mixture `dummy_mix`), written here rather than read from
its YAML; entries of the other dataset types come with their modules
(`register_dataset_type` adds a constructor).
"""

from __future__ import annotations

import json
import os
from itertools import chain
from typing import Any, Callable, Dict, List, Optional

from vila_tpu_torch.data.dataset import (
    BaseDataset,
    ConcatDataset,
    RepeatedDataset,
    SubsetDataset,
)


def _dummy_ctor(**kw):
    from vila_tpu_torch.data.dummy import DummyDataset

    return DummyDataset(**kw)


DATASET_TYPES: Dict[str, Callable] = {
    "supervised": BaseDataset,
    "dummy": _dummy_ctor,
}

DATASETS: Dict[str, Dict[str, Any]] = {
    "dummy": {"type": "dummy", "num_instances": 64},
    "dummy-image": {"type": "dummy", "num_instances": 64, "with_images": True},
}
MIXTURES: Dict[str, List[str]] = {
    "dummy_mix": ["dummy", "dummy-image"],
}


def register_dataset_type(name: str, ctor: Callable) -> None:
    DATASET_TYPES[name] = ctor


def parse_mixture(mixture: str) -> List[str]:
    """Expand mixture names recursively; `+` concatenates
    (llava/data/builder.py:58-63)."""
    names = mixture.split("+") if "+" in mixture else [mixture]
    while any(name.split("*")[0].split("@")[0] in MIXTURES for name in names):
        names = list(
            chain(
                *[
                    MIXTURES.get(name.split("*")[0].split("@")[0], [name])
                    for name in names
                ]
            )
        )
    return sorted(names)


def build_dataset(
    mixture: str,
    tokenizer,
    cfg,  # vlm.VLMConfig
    subset_dir: Optional[str] = None,
):
    """Build a (possibly concatenated/repeated/sliced) dataset from a
    mixture string (llava/data/builder.py:85-151)."""
    datasets = []
    for name in parse_mixture(mixture):
        subset_choice = None
        if "@" in name:
            name, subset_choice = name.split("@")
        times = 1
        if "*" in name:
            name, t = name.split("*")
            times = int(t)

        if name not in DATASETS:
            raise ValueError(f"Dataset '{name}' not found in the registry.")
        meta = {
            k: os.path.expandvars(v) if isinstance(v, str) else v
            for k, v in DATASETS[name].items()
        }
        dtype = meta.pop("type", "supervised")
        if dtype not in DATASET_TYPES:
            raise NotImplementedError(f"dataset type {dtype!r} is not ported yet")
        dataset = DATASET_TYPES[dtype](tokenizer=tokenizer, cfg=cfg, **meta)

        if subset_choice is not None:
            folder = subset_dir or os.environ.get("VILA_SLICE_FOLDER", "")
            with open(os.path.join(folder, subset_choice, f"{name}.json")) as f:
                ignore = set(json.load(f))
            indices = sorted(set(range(len(dataset))) - ignore)
            dataset = SubsetDataset(dataset, indices)
        if times > 1:
            dataset = RepeatedDataset(dataset, times)
        datasets.append(dataset)
    return ConcatDataset(datasets)
