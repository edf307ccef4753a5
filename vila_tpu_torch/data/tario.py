"""Indexed random access into webdataset tar shards, as
`vila_tpu/data/tario.py`: a ctypes binding for the port's copy of the C++
reader (`native/tario.cpp`), which mmaps each shard once, parses its tar
index in C++ and serves reads from the mapping.

Capability parity: the reference's vendored `wids` (llava/wids/wids.py:226
`IndexedTarSamples` + mmap tar `wids_mmtar.py`, and `VILAWebDataset`
grouping, llava/data/simple_vila_webdataset.py:195): random access to
samples in .tar shards, samples grouped by basename stem, with an LRU shard
cache.

The library is built with `g++ -O2 -shared -fPIC` at first use into
`vila_tpu_torch/_build/` (git-ignored; the name carries the source's hash).
A failed build raises: the JAX package quietly falls back to Python's
`tarfile` there. `IndexedTar(path, force_python=True)` is the explicit
Python index, which the tests hold the native one against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "tario.cpp"
BUILD_DIR = _PKG / "_build"
COMPILER = "g++"
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libtario_{digest}.so"


def load_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if the build fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = _target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    [COMPILER, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(
                    f"cannot build {SOURCE.name}: {COMPILER} not found ({e})") from e
            if proc.returncode != 0:
                raise RuntimeError(f"{COMPILER} failed on {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.tario_open.restype = ctypes.c_void_p
        lib.tario_open.argtypes = [ctypes.c_char_p]
        lib.tario_close.argtypes = [ctypes.c_void_p]
        lib.tario_count.restype = ctypes.c_int64
        lib.tario_count.argtypes = [ctypes.c_void_p]
        lib.tario_name.restype = ctypes.c_char_p
        lib.tario_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_size.restype = ctypes.c_int64
        lib.tario_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tario_read.restype = ctypes.c_int64
        lib.tario_read.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        _LIB = lib
        return lib


class IndexedTar:
    """Random access to one tar shard: names, sizes, bytes by index. The
    native index unless `force_python`; a shard the native reader cannot
    open (missing, under one 512-byte block, not mappable) raises."""

    def __init__(self, path: str, force_python: bool = False) -> None:
        self.path = path
        self._handle = None
        self._py_index: Optional[List[Tuple[str, int, int]]] = None
        if force_python:
            self._build_py_index()
            return
        self._lib = load_lib()
        handle = self._lib.tario_open(os.fsencode(path))
        if not handle:
            raise OSError(f"cannot open tar shard {path}")
        self._handle = ctypes.c_void_p(handle)

    def _build_py_index(self) -> None:
        import tarfile

        index = []
        with tarfile.open(self.path, "r:") as tf:
            for m in tf:
                if m.isreg():
                    index.append((m.name, m.offset_data, m.size))
        self._py_index = index

    def __len__(self) -> int:
        if self._handle is not None:
            return int(self._lib.tario_count(self._handle))
        return len(self._py_index)

    def name(self, i: int) -> str:
        if self._handle is not None:
            return self._lib.tario_name(self._handle, i).decode()
        return self._py_index[i][0]

    def read(self, i: int) -> bytes:
        if self._handle is not None:
            n = int(self._lib.tario_size(self._handle, i))
            buf = (ctypes.c_uint8 * n)()
            got = self._lib.tario_read(self._handle, i, buf, n)
            return bytes(buf[:got])
        _, off, size = self._py_index[i]
        with open(self.path, "rb") as f:
            f.seek(off)
            return f.read(size)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.tario_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    @property
    def is_native(self) -> bool:
        return self._handle is not None


def group_samples(names: List[str]) -> "OrderedDict[str, Dict[str, int]]":
    """Group member indices by sample key (basename up to first dot) —
    webdataset convention (wids.py sample grouping)."""
    groups: "OrderedDict[str, Dict[str, int]]" = OrderedDict()
    for i, n in enumerate(names):
        base = os.path.basename(n)
        if not base or base.startswith("."):
            continue
        stem, _, ext = base.partition(".")
        groups.setdefault(stem, {})[ext] = i
    return groups


class ShardedTarDataset:
    """Multi-shard indexed dataset with an LRU shard cache.

    Samples are dicts {ext: bytes}. Mirrors `VILAWebDataset`'s flat indexing
    over shards (simple_vila_webdataset.py:195) with wids' LRU shard cache.
    """

    def __init__(self, shard_paths: List[str], cache_size: int = 8) -> None:
        self.shard_paths = list(shard_paths)
        self.cache_size = cache_size
        self._cache: "OrderedDict[str, Tuple[IndexedTar, OrderedDict]]" = OrderedDict()
        # the per-shard sample counts, once (an index pass)
        self._spans: List[Tuple[int, int]] = []  # (start, count) per shard
        total = 0
        self._keys: List[List[str]] = []
        for p in self.shard_paths:
            _, groups = self._open(p)
            keys = list(groups.keys())
            self._keys.append(keys)
            self._spans.append((total, len(keys)))
            total += len(keys)
        self._total = total

    def _open(self, path: str) -> Tuple[IndexedTar, "OrderedDict"]:
        if path in self._cache:
            self._cache.move_to_end(path)
            return self._cache[path]
        tar = IndexedTar(path)
        groups = group_samples([tar.name(i) for i in range(len(tar))])
        self._cache[path] = (tar, groups)
        while len(self._cache) > self.cache_size:
            _, (old, _g) = self._cache.popitem(last=False)
            old.close()
        return self._cache[path]

    def __len__(self) -> int:
        return self._total

    def __getitem__(self, idx: int) -> Dict[str, bytes]:
        if idx < 0:
            idx += self._total
        for shard_i, (start, count) in enumerate(self._spans):
            if start <= idx < start + count:
                tar, groups = self._open(self.shard_paths[shard_i])
                key = self._keys[shard_i][idx - start]
                out = {"__key__": key.encode()}
                for ext, i in groups[key].items():
                    out[ext] = tar.read(i)
                return out
        raise IndexError(idx)
