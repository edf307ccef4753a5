"""The port's data preparation library (`vila_tpu_torch/data/prep.py`)
against the JAX package's (`vila_tpu/data/prep.py`) on the inputs of
`tests/test_prep.py`: shard files byte for byte (the writer zeroes every
member's metadata, `prep.py:113`), their `.count` and meta sidecars, the
record converters, the MMC4 filter and the jsonl merge and split; the
shards read back through the port's native reader.
"""

import json
import os

import pytest

from vila_tpu.data import prep as J
from vila_tpu_torch.data import prep as T
from vila_tpu_torch.data.tario import IndexedTar, ShardedTarDataset


def _tree(root):
    """{relative path: bytes} of every file under `root`."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, fn, *args, **kw):
    """`fn` of each package writing under its own directory: (port paths,
    JAX paths, port files, JAX files)."""
    got = getattr(T, fn)(*args, str(tmp_path / "port"), **kw)
    want = getattr(J, fn)(*args, str(tmp_path / "jax"), **kw)
    return got, want, _tree(tmp_path / "port"), _tree(tmp_path / "jax")


def test_shard_writer_roundtrip(tmp_path):
    samples = [{"txt": f"caption {i}".encode(), "jpg": bytes([i] * (10 + i))} for i in range(7)]
    got, want, tfiles, jfiles = _both(tmp_path, "write_shards", samples,
                                      prefix="pairs", samples_per_shard=3)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 3 and tfiles == jfiles
    assert [int(open(p.replace(".tar", ".count")).read()) for p in got] == [3, 3, 1]
    assert json.load(open(tmp_path / "port" / "pairs-meta.json"))["total_samples"] == 7
    ds = ShardedTarDataset(got)
    assert len(ds) == 7
    for i in range(7):
        assert ds[i]["txt"] == f"caption {i}".encode() and ds[i]["jpg"] == bytes([i] * (10 + i))


def test_shard_writer_native_readable(tmp_path):
    paths = T.write_shards([{"json": b"{}", "jpg": b"x" * 600}], str(tmp_path), prefix="s")
    tar = IndexedTar(paths[0])
    assert tar.is_native
    assert {tar.name(i) for i in range(len(tar))} == {"s-000000000.jpg", "s-000000000.json"}
    tar.close()


def test_shard_writer_deterministic_and_equal_to_jax(tmp_path):
    for pkg, d in ((T, "a"), (T, "b"), (J, "c")):
        pkg.write_shards([{"txt": b"hello", "jpg": b"img"}], str(tmp_path / d), prefix="x")
    a, b, c = ((tmp_path / d / "x-000000.tar").read_bytes() for d in "abc")
    assert a == b == c


def test_shard_writer_rejects_bad_key(tmp_path):
    for pkg in (T, J):
        with pkg.TarShardWriter(str(tmp_path / pkg.__name__)) as w:
            for key in ("a/b", ".hidden"):
                with pytest.raises(ValueError, match="bad sample key"):
                    w.add(key, {"txt": b"x"})


@pytest.mark.parametrize("n,target", [(100, 10), (5, 10), (5, 1), (7, 0), (1000, 333)])
def test_linspace_subsample(n, target):
    assert T.linspace_subsample(n, target) == J.linspace_subsample(n, target)


def test_converters():
    cases = [
        ("flan_record", ("2+2?", "4", 3)),
        ("metamathqa_record", ({"type": "GSM", "query": "q", "response": "a"}, 1)),
        ("m3it_record", ({"instruction": "Look. ", "inputs": "What?", "outputs": "Cat",
                          "image_base64_str": ["abc"]}, 0, "textcap")),
        ("m3it_record", ({"outputs": "x"}, 2)),
        ("ocr_kv_record", ("img.png", {"total": "5.00", "date": "1/1", "é": "ü"}, 0)),
        ("caption_sample", (b"\x01\x02", "a caption", "png")),
        ("conversation_sample", ({"id": 1, "conversations": []}, b"jpg bytes")),
        ("conversation_sample", ({"id": 2, "q": "é"},)),
    ]
    for name, args in cases:
        assert getattr(T, name)(*args) == getattr(J, name)(*args), name
    r = T.ocr_kv_record("img.png", {"total": "5.00", "date": "1/1"}, 0)
    assert json.loads(r["conversations"][1]["value"]) == {"date": "1/1", "total": "5.00"}


def test_filter_interleaved():
    annos = [
        {"image_info": [1, 2], "text_list": ["a"]},
        {"image_info": [1], "text_list": ["b"]},
        {"image_info": [], "text_list": ["c"]},
    ]
    present = {0: [b"x", b"y"], 2: 0}
    assert T.filter_interleaved(annos, present) == J.filter_interleaved(annos, present)
    assert [r["org_idx"] for r in T.filter_interleaved(annos, present)] == [0, 2]
    for pkg in (T, J):
        with pytest.raises(ValueError, match="fetched 2 images"):
            pkg.filter_interleaved(annos, {1: [b"x", b"y"]})


def test_merge_jsonl_datasets(tmp_path):
    for name, rows in [("a_train.jsonl", 2), ("b_train.jsonl", 3)]:
        with open(tmp_path / name, "w") as f:
            for i in range(rows):
                f.write(json.dumps({"id": i, "ok": i != 1, "conversations": []}) + "\n")
    paths = [str(tmp_path / "a_train.jsonl"), str(tmp_path / "b_train.jsonl")]
    for kw in ({}, {"include": ["b_"]}, {"valid_fn": lambda r: r["ok"]}):
        assert T.merge_jsonl_datasets(paths, **kw) == J.merge_jsonl_datasets(paths, **kw)
    assert [r["id"] for r in T.merge_jsonl_datasets(paths)] == [0, 1, 2, 3, 4]


def test_split_jsonl_shards(tmp_path):
    src = tmp_path / "big.jsonl"
    with open(src, "w") as f:
        for i in range(25):
            f.write(json.dumps({"i": i}) + ("\n" if i != 24 else ""))
    got, want, tfiles, jfiles = _both(tmp_path, "split_jsonl_shards", str(src), shard_size=10)
    assert len(got) == 3 and tfiles == jfiles
    assert sum(1 for p in got for _ in open(p)) == 25


def test_sft_json_to_shards(tmp_path):
    img = tmp_path / "media" / "x.jpg"
    os.makedirs(img.parent)
    img.write_bytes(b"\xff\xd8fakejpg")
    (tmp_path / "media" / "y.PNG").write_bytes(b"\x89PNGfake")
    records = [
        {"id": 0, "image": "x.jpg",
         "conversations": [{"from": "human", "value": "<image>\nhi"},
                           {"from": "gpt", "value": "hello"}]},
        {"id": 1, "image": "missing.jpg", "conversations": []},  # skipped
        {"id": 2, "conversations": [{"from": "human", "value": "text only"},
                                    {"from": "gpt", "value": "ok"}]},
        {"id": 3, "image": "y.PNG", "conversations": []},
    ]
    jp = tmp_path / "chat.json"
    jp.write_text(json.dumps(records))
    got, want, tfiles, jfiles = _both(tmp_path, "sft_json_to_shards", str(jp),
                                      str(tmp_path / "media"), samples_per_shard=2)
    assert len(got) == 2 and tfiles == jfiles
    ds = ShardedTarDataset(got)
    assert len(ds) == 3  # the missing-media record dropped
    assert ds[0]["jpg"] == b"\xff\xd8fakejpg" and json.loads(ds[0]["json"])["id"] == 0
    assert "jpg" not in ds[1] and ds[2]["png"] == b"\x89PNGfake"
    for pkg in (T, J):
        with pytest.raises(FileNotFoundError):
            pkg.sft_json_to_shards(str(jp), str(tmp_path / "media"),
                                   str(tmp_path / "strict" / pkg.__name__), strict=True)
