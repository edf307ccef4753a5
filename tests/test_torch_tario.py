"""The port's indexed tar reader (`vila_tpu_torch/data/tario.py` over its
own copy of `native/tario.cpp`) against the JAX package's
(`vila_tpu/data/tario.py`), on the shards of `tests/test_tario.py`:

* the native index equals the Python (`tarfile`) index and the JAX
  package's reader, name for name and byte for byte, a > 100-character
  member name (GNU / pax long-name headers) among them;
* `group_samples` and `ShardedTarDataset` (its LRU shard cache of 2 over 3
  shards) give the JAX package's samples;
* the library builds from the port's copy into `vila_tpu_torch/_build/`;
  a failed build raises where the JAX package quietly falls back to
  Python's `tarfile`, and a shard the native reader cannot open raises.
"""

import io
import os
import tarfile

import numpy as np
import pytest

from vila_tpu.data import tario as J
from vila_tpu_torch.data import tario as T


def make_shard(path, samples):
    with tarfile.open(path, "w") as tf:
        for name, data in samples:
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


@pytest.fixture()
def shard(tmp_path):
    rng = np.random.default_rng(0)
    samples = []
    for i in range(5):
        samples.append((f"{i:06d}.jpg", rng.bytes(100 + 37 * i)))
        samples.append((f"{i:06d}.json", b'{"caption": "s%d"}' % i))
    samples.append(("x" * 120 + ".jpg", b"LONG"))
    p = str(tmp_path / "shard-000000.tar")
    make_shard(p, samples)
    return p, samples


def _members(tar):
    return [(tar.name(i), tar.read(i)) for i in range(len(tar))]


def test_native_matches_python_and_jax(shard):
    path, samples = shard
    nat = T.IndexedTar(path)
    py = T.IndexedTar(path, force_python=True)
    assert nat.is_native and not py.is_native
    assert _members(nat) == _members(py) == _members(J.IndexedTar(path)) == samples
    nat.close()


def test_group_samples_matches_jax():
    names = ["000000.jpg", "000000.json", "000001.jpg", "000001.json", "dir/.hidden",
             "a.b.c", "dir/"]
    assert T.group_samples(names) == J.group_samples(names)
    assert list(T.group_samples(names)) == ["000000", "000001", "a"]


def test_sharded_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    paths = []
    for s in range(3):
        samples = []
        for i in range(4):
            samples.append((f"{s}_{i}.jpg", rng.bytes(64)))
            samples.append((f"{s}_{i}.txt", f"caption {s}/{i}".encode()))
        p = str(tmp_path / f"shard-{s:06d}.tar")
        make_shard(p, samples)
        paths.append(p)
    got, want = T.ShardedTarDataset(paths, cache_size=2), J.ShardedTarDataset(paths, cache_size=2)
    assert len(got) == len(want) == 12
    assert got[5]["txt"] == b"caption 1/1" and got[-1]["txt"] == b"caption 2/3"
    for i in list(range(12)) + [0, 11, 4]:  # the LRU evicts and reopens shards
        assert got[i] == want[i]
    with pytest.raises(IndexError):
        got[12]


def test_library_builds_from_the_ports_copy():
    assert T.SOURCE.is_file() and T.SOURCE.parent.name == "native"
    assert T.SOURCE.parent.parent.name == "vila_tpu_torch"
    lib = T.load_lib()
    assert lib is T.load_lib()
    assert T._target().parent == T.BUILD_DIR and T._target().exists()


def test_failed_build_raises_where_jax_falls_back(shard, tmp_path, monkeypatch):
    """No compiler: the port raises; the JAX package reads through tarfile."""
    path, samples = shard
    monkeypatch.setattr(T, "COMPILER", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(T, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(T, "_LIB", None)
    with pytest.raises(RuntimeError, match="cannot build tario.cpp"):
        T.IndexedTar(path)
    assert T.IndexedTar(path, force_python=True).read(0) == samples[0][1]

    native = tmp_path / "jax_native"
    native.mkdir()
    (native / "tario.cpp").write_bytes(T.SOURCE.read_bytes())

    def no_compiler(*a, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(J, "_NATIVE_DIR", str(native))
    monkeypatch.setattr(J, "_LIB", None)
    monkeypatch.setattr(J, "_LIB_FAILED", False)
    monkeypatch.setattr(J.subprocess, "run", no_compiler)
    fallback = J.IndexedTar(path)
    assert not fallback.is_native and _members(fallback) == samples


def test_unreadable_shard_raises(tmp_path):
    tiny = tmp_path / "tiny.tar"
    tiny.write_bytes(b"\0" * 100)
    for p in (str(tiny), str(tmp_path / "missing.tar")):
        with pytest.raises(OSError, match="cannot open tar shard"):
            T.IndexedTar(p)
