"""Dataset registry and mixture parsing, as `vila_tpu/data/builder.py`.

Capability parity: llava/data/builder.py — YAML dataset registry
(`register_datasets` :36, env `VILA_DATASETS`), mixture expansion
(`parse_mixture` :58 — `+` concat, recursive mixture names), `*N` repeat and
`@subset` slicing (:85-151).

Registry entries are YAML dicts read from the port's copies of the JAX
package's files (`registry/datasets/<name>.yaml`, `registry/mixtures.yaml`)
with the port's own YAML reader (`utils/yaml_lite.py`); the entry's `type`
names a constructor in DATASET_TYPES (extensible via
`register_dataset_type`).

Two faults of the reference's registry are kept as they are: every
dataset_impl entry of `default.yaml` names its file under `records:`, which
`_impl`'s constructor does not take (it reads `data_path` or `shards`), and
`cc3m_wds` gives `shard_glob:`, which `WebDatasetSupervised` does not take
(it takes `shard_paths`). Both raise `TypeError`, as in the JAX package.
"""

from __future__ import annotations

import os
from itertools import chain
from typing import Any, Callable, Dict, List, Optional

from vila_tpu_torch.data.dataset import (
    BaseDataset,
    ConcatDataset,
    RepeatedDataset,
    SubsetDataset,
)
from vila_tpu_torch.utils import io

_REGISTRY_DIR = os.path.join(os.path.dirname(__file__), "registry")


def _lazy(name: str) -> Callable:
    def ctor(**kw):
        from vila_tpu_torch.data import interleaved

        return getattr(interleaved, name)(**kw)

    return ctor


def _dummy_ctor(**kw):
    from vila_tpu_torch.data.dummy import DummyDataset

    return DummyDataset(**kw)


def _impl(name: str) -> Callable:
    """Constructor from the dataset_impl zoo; `data_path` loads the record
    list, `shards` wires a webdataset adapter instead."""

    def ctor(tokenizer=None, cfg=None, data_path=None, shards=None, **kw):
        from vila_tpu_torch.data import dataset_impl as zoo

        cls = getattr(zoo, name)
        if shards is not None:
            records: Any = zoo.WDSRecordAdapter(shards)
        else:
            records = zoo.load_records(data_path)
        return cls(tokenizer, cfg, records, **kw)

    return ctor


DATASET_TYPES: Dict[str, Callable] = {
    "supervised": BaseDataset,
    # pretraining corpus styles (llava/data/dataset.py:553,770,929)
    "interleaved": _lazy("InterleavedDataset"),
    "caption_pairs": _lazy("CaptionPairDataset"),
    "webdataset": _lazy("WebDatasetSupervised"),
    # synthetic smoke/debug data (llava/data/dataset_impl/dummy.py)
    "dummy": _dummy_ctor,
    # dataset_impl zoo (llava/data/dataset_impl/*.py)
    "coyo_qa": _impl("CoyoQADataset"),
    "coyo_recap": _impl("CoyoRecapDataset"),
    "general_img_text": _impl("GeneralImageTextDataset"),
    "sam": _impl("SAMCaptionDataset"),
    "textocr": _impl("TextOCRDataset"),
    "hiertext": _impl("HierTextDataset"),
    "panda70m": _impl("Panda70MDataset"),
    "lita": _impl("LITADataset"),
    "llava_cot": _impl("LLaVACoTDataset"),
}

DATASETS: Dict[str, Any] = {}
MIXTURES: Dict[str, List[str]] = {}


def register_dataset_type(name: str, ctor: Callable) -> None:
    DATASET_TYPES[name] = ctor


def register_datasets(name: Optional[str] = None) -> Dict[str, Any]:
    """Load dataset registry YAMLs (env VILA_DATASETS, comma-separated)."""
    if name is None:
        name = os.environ.get("VILA_DATASETS", "default")
    for one in name.split(","):
        path = os.path.join(_REGISTRY_DIR, "datasets", f"{one}.yaml")
        if os.path.exists(path):
            DATASETS.update(io.load(path) or {})
    return DATASETS


def register_mixtures() -> Dict[str, List[str]]:
    path = os.path.join(_REGISTRY_DIR, "mixtures.yaml")
    if os.path.exists(path):
        MIXTURES.update(io.load(path) or {})
    return MIXTURES


register_datasets()
register_mixtures()


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
        ctor = DATASET_TYPES[dtype]
        dataset = ctor(tokenizer=tokenizer, cfg=cfg, **meta)

        if subset_choice is not None:
            folder = subset_dir or os.environ.get("VILA_SLICE_FOLDER", "")
            ignore = set(
                io.load(os.path.join(folder, subset_choice, f"{name}.json"))
            )
            indices = sorted(set(range(len(dataset))) - ignore)
            dataset = SubsetDataset(dataset, indices)
        if times > 1:
            dataset = RepeatedDataset(dataset, times)
        datasets.append(dataset)
    return ConcatDataset(datasets)
