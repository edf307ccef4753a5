"""The port's pretraining dataset types (`vila_tpu_torch/data/
interleaved.py`) against the JAX package's (`vila_tpu/data/interleaved.py`)
on the inputs of `tests/test_interleaved.py`, through one tokenizer object
and a tiny config: MMC4-style interleaved documents (images spliced before
their sentences, `max_images`, markers past a `max_length` cut dropped),
caption pairs packed `n_samples_per_idx` an item, and supervised samples
out of webdataset tar shards (json and txt captions), every sample equal
bit for bit; the registry types of both packages.
"""

import json
import tarfile

import numpy as np
import pytest

from torch_data_helpers import assert_same_sample, data_env, image_file, jpeg_bytes
from vila_tpu.data import builder as jbuilder
from vila_tpu.data import interleaved as J
from vila_tpu_torch.constants import IGNORE_INDEX
from vila_tpu_torch.data import builder as tbuilder
from vila_tpu_torch.data import interleaved as T


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return data_env(str(tmp_path_factory.mktemp("tok")))


def _both(env, cls, *args, port_tok=False, **kw):
    tok, cfg, tcfg, jtok = env
    return (getattr(T, cls)(jtok if port_tok else tok, tcfg, *args, **kw),
            getattr(J, cls)(tok, cfg, *args, **kw))


@pytest.mark.parametrize("kw", [{}, {"max_images": 1}, {"max_length": 20}])
def test_interleaved_dataset(env, tmp_path, kw):
    imgs = [image_file(i, tmp_path / f"{i}.png") for i in range(3)]
    inst = {"texts": ["first sentence.", "second sentence.", "third one."],
            "images": imgs, "matched_idx": [0, 2, 2]}
    got, want = _both(env, "InterleavedDataset", instances=[inst], **kw)
    ex = got[0]
    assert_same_sample(ex, want[0])
    tpi = env[2].tokens_per_image
    n = ex["tiles"].shape[0]
    assert n == {"max_images": 1, "max_length": 1}.get(next(iter(kw), None), 3)
    assert len(ex["media_positions"]) == n * tpi
    ph = np.zeros(len(ex["input_ids"]), bool)
    ph[ex["media_positions"]] = True
    assert (ex["labels"][ph] == IGNORE_INDEX).all()
    assert (ex["labels"][~ph] != IGNORE_INDEX).sum() > 0


def test_interleaved_from_data_path_and_port_tokenizer(env, tmp_path):
    imgs = [image_file(10 + i, tmp_path / f"{i}.png") for i in range(2)]
    docs = [{"texts": ["one.", "two."], "images": imgs, "matched_idx": [1, 0]},
            {"texts": ["text only."]}]
    p = tmp_path / "mmc4.json"
    p.write_text(json.dumps(docs))
    got, want = _both(env, "InterleavedDataset", data_path=str(p), port_tok=True)
    for i in range(2):
        assert_same_sample(got[i], want[i])


def test_caption_pairs_packing(env, tmp_path):
    pairs = [{"image": image_file(20 + i, tmp_path / f"c{i}.png"),
              "caption": f"caption number {i}"} for i in range(9)]
    got, want = _both(env, "CaptionPairDataset", instances=pairs, n_samples_per_idx=4)
    assert len(got) == len(want) == 2
    for i in range(2):
        assert_same_sample(got[i], want[i])
    assert got[1]["tiles"].shape[0] == 4
    assert len(got[1]["media_positions"]) == 4 * env[2].tokens_per_image


def test_webdataset_supervised(env, tmp_path):
    import io

    shard = str(tmp_path / "shard-000000.tar")
    with tarfile.open(shard, "w") as tf:
        for i in range(4):
            members = [(f"{i:05d}.jpg" if i % 2 else f"{i:05d}.png", jpeg_bytes(i))]
            if i < 2:
                members.append((f"{i:05d}.json", json.dumps({"caption": f"photo {i}"}).encode()))
            elif i == 2:
                members.append((f"{i:05d}.json", json.dumps({"text": "text key"}).encode()))
            else:
                members.append((f"{i:05d}.txt", b"a txt caption"))
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    got, want = _both(env, "WebDatasetSupervised", [shard])
    assert len(got) == len(want) == 4
    for i in range(4):
        assert_same_sample(got[i], want[i])
    assert got[2]["tiles"].shape[0] == 1
    assert len(got[2]["media_positions"]) == env[2].tokens_per_image


def test_registry_types():
    for t in ("supervised", "interleaved", "caption_pairs", "webdataset"):
        assert t in tbuilder.DATASET_TYPES and t in jbuilder.DATASET_TYPES
