"""Offline data preparation: shard writing + dataset converters, as
`vila_tpu/data/prep.py` (the same tar bytes for the same samples).

Capability parity with the reference's `data_prepare/` tree
(data_prepare/sft/preprocess_flan.py, preprocess_metamathqa.py,
preprocess_m3it.py, merge_llava_onevision.py, mmc4/mmc4_filter_and_counter.py,
coyo/coyo_splitter.py) — but emitting this framework's preferred on-disk
layout: indexed webdataset tar shards served by the native reader
(`data/tario.py` over `native/tario.cpp`), which gives O(1) random
access with mmap reads.

Everything here is host-side, stdlib only.
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Any, Callable, Dict, Iterable, Iterator, List, Optional, Sequence

__all__ = [
    "TarShardWriter",
    "write_shards",
    "linspace_subsample",
    "flan_record",
    "metamathqa_record",
    "m3it_record",
    "ocr_kv_record",
    "caption_sample",
    "conversation_sample",
    "filter_interleaved",
    "merge_jsonl_datasets",
    "split_jsonl_shards",
    "sft_json_to_shards",
]


# ---------------------------------------------------------------------------
# Indexed tar shard writing
# ---------------------------------------------------------------------------


class TarShardWriter:
    """Write webdataset-style tar shards compatible with `IndexedTar`.

    Samples are dicts ``{ext: bytes}`` stored as ``{key}.{ext}`` members so
    `tario.group_samples` regroups them on read. Shards roll over at
    ``samples_per_shard`` samples or ``max_shard_bytes`` payload bytes,
    whichever comes first; each closed shard gets a ``.count`` sidecar (the
    reference writes the same sidecar in mmc4_filter_and_counter.py:58) so
    index passes can skip opening the tar.

    USTAR format with deterministic zeroed metadata: byte-identical output
    for identical input, which makes shard-level dedup/caching trivial.
    """

    def __init__(
        self,
        out_dir: str,
        prefix: str = "shard",
        samples_per_shard: int = 2048,
        max_shard_bytes: int = 1 << 30,
    ) -> None:
        self.out_dir = out_dir
        self.prefix = prefix
        self.samples_per_shard = samples_per_shard
        self.max_shard_bytes = max_shard_bytes
        self.shard_paths: List[str] = []
        self._tar: Optional[tarfile.TarFile] = None
        self._count = 0
        self._bytes = 0
        self._total = 0
        os.makedirs(out_dir, exist_ok=True)

    # -- lifecycle -------------------------------------------------------
    def __enter__(self) -> "TarShardWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _open_shard(self) -> None:
        path = os.path.join(
            self.out_dir, f"{self.prefix}-{len(self.shard_paths):06d}.tar"
        )
        self.shard_paths.append(path)
        self._tar = tarfile.open(path, "w", format=tarfile.USTAR_FORMAT)
        self._count = 0
        self._bytes = 0

    def _close_shard(self) -> None:
        if self._tar is None:
            return
        self._tar.close()
        self._tar = None
        path = self.shard_paths[-1]
        with open(path.replace(".tar", ".count"), "w") as f:
            f.write(str(self._count))

    # -- api -------------------------------------------------------------
    def add(self, key: str, sample: Dict[str, bytes]) -> None:
        if "/" in key or key.startswith("."):
            raise ValueError(f"bad sample key: {key!r}")
        if self._tar is None:
            self._open_shard()
        for ext in sorted(sample):
            data = sample[ext]
            if isinstance(data, str):
                data = data.encode("utf-8")
            info = tarfile.TarInfo(name=f"{key}.{ext}")
            info.size = len(data)
            info.mtime = 0
            info.uid = info.gid = 0
            info.uname = info.gname = ""
            self._tar.addfile(info, io.BytesIO(data))
            self._bytes += len(data)
        self._count += 1
        self._total += 1
        if (
            self._count >= self.samples_per_shard
            or self._bytes >= self.max_shard_bytes
        ):
            self._close_shard()

    def close(self) -> None:
        self._close_shard()
        meta = {
            "total_samples": self._total,
            "shards": [os.path.basename(p) for p in self.shard_paths],
        }
        with open(os.path.join(self.out_dir, f"{self.prefix}-meta.json"), "w") as f:
            json.dump(meta, f, indent=1)

    @property
    def total(self) -> int:
        return self._total


def write_shards(
    samples: Iterable[Dict[str, bytes]],
    out_dir: str,
    prefix: str = "shard",
    samples_per_shard: int = 2048,
    max_shard_bytes: int = 1 << 30,
    key_fn: Optional[Callable[[int, Dict[str, bytes]], str]] = None,
) -> List[str]:
    """Stream samples into shards; returns the shard paths."""
    with TarShardWriter(
        out_dir, prefix, samples_per_shard, max_shard_bytes
    ) as w:
        for i, s in enumerate(samples):
            key = key_fn(i, s) if key_fn else f"{prefix}-{i:09d}"
            w.add(key, s)
        paths = list(w.shard_paths)
    return paths


# ---------------------------------------------------------------------------
# Record converters (reference: data_prepare/sft/*)
# ---------------------------------------------------------------------------


def linspace_subsample(n: int, target: int) -> List[int]:
    """Deterministic evenly spaced subsample indices — the reference's
    `torch.linspace(0, n-1, target).int()` (preprocess_flan.py:60)."""
    if target >= n:
        return list(range(n))
    if target <= 0:
        return []
    step = (n - 1) / (target - 1) if target > 1 else 0.0
    return [int(i * step) for i in range(target)]


def flan_record(inputs: str, targets: str, idx: int) -> Dict[str, Any]:
    """FLAN text-instruction record → vflan sample
    (preprocess_flan.py:64-72 layout)."""
    return {
        "question": inputs,
        "answer": targets,
        "id": "text_flan_%08d" % idx,
        "image": [],
    }


def metamathqa_record(rec: Dict[str, Any], idx: int) -> Dict[str, Any]:
    """MetaMathQA query/response → conversations json
    (preprocess_metamathqa.py:10-21)."""
    return {
        "id": idx,
        "dataset_name": "metamathqa",
        "question_type": rec.get("type", ""),
        "conversations": [
            {"from": "human", "value": rec["query"]},
            {"from": "gpt", "value": rec["response"]},
        ],
    }


def m3it_record(rec: Dict[str, Any], idx: int, dataset_name: str = "m3it") -> Dict[str, Any]:
    """M3IT instruction/inputs/outputs (+base64 images) → vflan sample
    (preprocess_m3it.py:66-80: question = instruction + inputs)."""
    return {
        "question": rec.get("instruction", "") + rec.get("inputs", ""),
        "answer": rec.get("outputs", ""),
        "id": f"{dataset_name}_%08d" % idx,
        "image": rec.get("image_base64_str", []) or [],
    }


def ocr_kv_record(
    image_path: str, fields: Dict[str, str], idx: int, dataset_name: str = "ocr_kv"
) -> Dict[str, Any]:
    """Key-value OCR extraction record (SROIE/POIE/ReCTS family:
    data_prepare/sft/SROIE.py, POIE.py) → conversation asking for each
    annotated field in a stable order."""
    keys = sorted(fields)
    question = (
        "<image>\nExtract the following fields from the document as JSON: "
        + ", ".join(keys)
    )
    answer = json.dumps({k: fields[k] for k in keys}, ensure_ascii=False)
    return {
        "id": f"{dataset_name}_%08d" % idx,
        "image": image_path,
        "conversations": [
            {"from": "human", "value": question},
            {"from": "gpt", "value": answer},
        ],
    }


def caption_sample(image_bytes: bytes, caption: str, ext: str = "jpg") -> Dict[str, bytes]:
    """COYO-style image/text pair → wds sample ({ext: bytes})."""
    return {ext: image_bytes, "txt": caption.encode("utf-8")}


def conversation_sample(record: Dict[str, Any], image_bytes: Optional[bytes] = None,
                        ext: str = "jpg") -> Dict[str, bytes]:
    """SFT conversation record (+ optional image) → wds sample."""
    out: Dict[str, bytes] = {"json": json.dumps(record, ensure_ascii=False).encode()}
    if image_bytes is not None:
        out[ext] = image_bytes
    return out


# ---------------------------------------------------------------------------
# Interleaved (MMC4) filtering and jsonl utilities
# ---------------------------------------------------------------------------


def filter_interleaved(
    annotations: Sequence[Dict[str, Any]],
    images_present: Dict[int, Any],
) -> List[Dict[str, Any]]:
    """Keep records whose images were all fetched; stamp `org_idx`
    (mmc4_filter_and_counter.py:44-50 semantics, including the
    image-count consistency check)."""
    out = []
    for i, anno in enumerate(annotations):
        if i not in images_present:
            continue
        got = images_present[i]
        n = len(got) if hasattr(got, "__len__") else got
        if n != len(anno.get("image_info", [])):
            raise ValueError(
                f"record {i}: fetched {n} images but annotation lists "
                f"{len(anno.get('image_info', []))}"
            )
        rec = dict(anno)
        rec["org_idx"] = i
        out.append(rec)
    return out


def merge_jsonl_datasets(
    paths: Sequence[str],
    include: Optional[Sequence[str]] = None,
    valid_fn: Optional[Callable[[Dict[str, Any]], bool]] = None,
) -> List[Dict[str, Any]]:
    """Concatenate jsonl datasets with id re-offsetting
    (merge_llava_onevision.py:16-37: filter templates, shift ids so the
    merged list has unique, contiguous ids)."""
    all_data: List[Dict[str, Any]] = []
    for p in paths:
        name = os.path.basename(p)
        if include is not None and not any(s in name for s in include):
            continue
        with open(p) as f:
            loaded = [json.loads(line) for line in f if line.strip()]
        if valid_fn is not None:
            loaded = [r for r in loaded if valid_fn(r)]
        offset = len(all_data)
        for j, item in enumerate(loaded):
            item["id"] = offset + j
        all_data.extend(loaded)
    return all_data


def split_jsonl_shards(
    path: str, out_dir: str, shard_size: int = 10000, prefix: Optional[str] = None
) -> List[str]:
    """Split one big jsonl into fixed-size jsonl shards
    (coyo/coyo_splitter.py semantics)."""
    os.makedirs(out_dir, exist_ok=True)
    prefix = prefix or os.path.basename(path).rsplit(".", 1)[0]
    out_paths: List[str] = []
    buf: List[str] = []

    def flush():
        if not buf:
            return
        p = os.path.join(out_dir, f"{prefix}-{len(out_paths):05d}.jsonl")
        with open(p, "w") as f:
            f.writelines(buf)
        out_paths.append(p)
        buf.clear()

    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            buf.append(line if line.endswith("\n") else line + "\n")
            if len(buf) >= shard_size:
                flush()
    flush()
    return out_paths


def sft_json_to_shards(
    json_path: str,
    media_dir: Optional[str],
    out_dir: str,
    prefix: str = "sft",
    samples_per_shard: int = 2048,
    strict: bool = False,
) -> List[str]:
    """Convert an SFT conversation json/jsonl (+ media dir) into indexed tar
    shards — the native ingest path for `ShardedTarDataset` /
    `dataset_impl.WDSRecordAdapter`. Missing media files are skipped
    (or raise when strict)."""
    if json_path.endswith(".jsonl"):
        with open(json_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
    else:
        with open(json_path) as f:
            records = json.load(f)

    def gen() -> Iterator[Dict[str, bytes]]:
        for rec in records:
            img = rec.get("image")
            blob = None
            ext = "jpg"
            if img:
                p = img if os.path.isabs(img) else os.path.join(media_dir or "", img)
                if not os.path.exists(p):
                    if strict:
                        raise FileNotFoundError(p)
                    continue
                with open(p, "rb") as f:
                    blob = f.read()
                ext = (os.path.splitext(p)[1][1:] or "jpg").lower()
            yield conversation_sample(rec, blob, ext)

    return write_shards(
        gen(), out_dir, prefix=prefix, samples_per_shard=samples_per_shard
    )
