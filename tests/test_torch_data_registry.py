"""The port's dataset registry (`vila_tpu_torch/data/builder.py` over its
copies of `registry/datasets/default.yaml` and `mixtures.yaml`) and its
YAML reader (`utils/yaml_lite.py`) against the JAX package
(`vila_tpu/data/builder.py`, PyYAML) on the CPU:

* the YAML reader gives `yaml.safe_load`'s value for every YAML file the
  port ships (the two lmms-eval task files carry `!function` tags, which
  both refuse), for the constructs of its subset, and for what its writer
  (`utils/io.save`) writes; a construct outside the subset raises
  `ValueError` naming the line;
* registry and mixture names and entries, `DATASET_TYPES` and
  `parse_mixture` equal the JAX package's;
* `build_dataset` of a supervised entry, and of the training mixture of
  `chip_smoke.py`'s `train_data` phase (a seeded corpus written by the
  port's `prep`: interleaved + caption pairs + webdataset*2 + textocr +
  lita, registered from its YAML file) gives JAX's samples bit for bit;
* the two faults of the reference registry are mirrored: a dataset_impl
  entry under `records:` and `cc3m_wds`'s `shard_glob:` raise the same
  `TypeError` in both packages, so `sft_mixture`, `video_sft_mixture` and
  `longvideo_sft` do not build;
* the short-video filter (`data/filters.py`) keeps what JAX's keeps.
"""

import glob
import json
import math
import os
import sys

import numpy as np
import pytest
import yaml

from torch_data_helpers import assert_same_sample, data_env
from vila_tpu.data import builder as jbuilder
from vila_tpu.data import filters as jfilters
from vila_tpu_torch.data import builder as tbuilder
from vila_tpu_torch.data import filters as tfilters
from vila_tpu_torch.utils import io as tio
from vila_tpu_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_YAML = sorted(glob.glob(os.path.join(REPO, "vila_tpu_torch", "**", "*.yaml"),
                             recursive=True))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return data_env(str(tmp_path_factory.mktemp("tok")))


def test_port_ships_its_registries():
    names = {os.path.relpath(p, os.path.join(REPO, "vila_tpu_torch")) for p in PORT_YAML}
    assert names == {"data/registry/datasets/default.yaml", "data/registry/mixtures.yaml",
                     "eval/registry.yaml", "eval/lmms_yaml/videomme.yaml",
                     "eval/lmms_yaml/videomme_w_subtitle.yaml"}


@pytest.mark.parametrize("path", PORT_YAML, ids=lambda p: os.path.relpath(p, REPO))
def test_yaml_reader_equals_safe_load_on_every_shipped_file(path):
    with open(path) as f:
        text = f.read()
    if "!function" in text:  # lmms-eval's own loader reads these
        with pytest.raises(yaml.constructor.ConstructorError):
            yaml.safe_load(text)
        with pytest.raises(ValueError, match=r"line \d+: the value '!function"):
            yaml_lite.loads(text)
        return
    assert yaml_lite.load_file(path) == yaml.safe_load(text)


SUBSET = [
    "a: 1\nb: 1.5\nc: yes\nd: ~\ne:\nf: 'it''s'\ng: \"x\\ny\"\nh: [a, 'b c', 3]\n",
    "i: -1\nj: .inf\nk: 1_000\nl: +3\nm: 0\nn: Off\no: 0o7\np: 1e3\nq: .5\nr: -.INF\n",
    "k:\n- a\n- b\nz: 2\n", "k: >-\n  one two\n  three\n\n  four\nq: x\n",
    "k: >\n  a\n  b\n", "k: >-\n\n  a # kept\n\n\n  b\nz: 1\n", "- 1\n- two\n",
    "x: ${A}/b.c # c\n#x\n", "[]\n", "", "a:\n  b:\n    c: [ ]\n  d: [1, yes, '#']\n",
    "t: a#b\nu: -x\nv: http://x.y/z\nw: 'a: b'\n'q k': 1\n",
    "top:\n  list:\n    - x\n    - 'y'\n  after: 3\n",
]


@pytest.mark.parametrize("text", SUBSET, ids=range(len(SUBSET)))
def test_yaml_reader_equals_safe_load_on_its_subset(text):
    got, want = yaml_lite.loads(text), yaml.safe_load(text)
    assert got == want or (isinstance(want, float) and math.isnan(want))


OUTSIDE = {
    "anchor": ("a: &x 1\n", 1), "alias": ("a: 1\nb: *x\n", 2), "tag": ("a: !t 1\n", 1),
    "flow mapping": ("a: {b: 1}\n", 1), "literal block": ("a: |\n  x\n", 1),
    "list of mappings": ("k:\n  - a: 1\n", 2), "documents": ("---\na: 1\n", 1),
    "octal": ("a: 017\n", 1), "hex": ("a: 0x1f\n", 1), "sexagesimal": ("a: 1:30\n", 1),
    "date": ("a: 2001-01-01\n", 1), "tab": ("a:\n\tb: 1\n", 2), "nested colon": ("a: b: c\n", 1),
    "open quote": ("a: 'x\n", 1), "multi-line plain": ("a:\n  b\n  c\n", 2),
    "complex key": ("? a\n", 1), "flow in flow": ("a: [1, {b}]\n", 1),
    "more-indented fold": ("k: >-\n  a\n    b\n", 3), "merge key": ("a:\n  <<: 1\n", 2),
}


@pytest.mark.parametrize("name", sorted(OUTSIDE))
def test_yaml_reader_raises_outside_its_subset(name):
    text, line = OUTSIDE[name]
    with pytest.raises(ValueError, match=rf"^line {line}: .* outside the YAML subset"):
        yaml_lite.loads(text)


def test_io_yaml_round_trips_and_reads_as_safe_load(tmp_path):
    obj = {"a": [1, 2, "x y"], "b": {"c": None, "d": True, "e": 1.5e-7, "f": "yes",
                                     "g": "a: b", "h": "multi\nline", "i": "it's", "j": "#x",
                                     "k": "", "l": [], "m": "${X}/y", "n": 3.0, "o": "1:30",
                                     "p": "-", "q": "0017", "r": float("inf")}}
    path = str(tmp_path / "o.yaml")
    tio.save(path, obj)
    assert tio.load(path) == obj == yaml.safe_load(open(path))
    for path, value in ((tmp_path / "x.json", {"a": [1]}), (tmp_path / "x.jsonl", [{"a": 1}, {}]),
                        (tmp_path / "x.npy", np.arange(3))):
        tio.save(str(path), value)
        assert np.all(tio.load(str(path)) == value)
    for bad in ({"a": {}}, {"a": [{"b": 1}]}, {"a": object()}):
        with pytest.raises(ValueError):
            yaml_lite.dump(bad)


def test_registry_and_mixture_names_equal_jax():
    assert tbuilder.DATASETS == jbuilder.DATASETS
    assert tbuilder.MIXTURES == jbuilder.MIXTURES
    assert sorted(tbuilder.DATASET_TYPES) == sorted(jbuilder.DATASET_TYPES)
    assert len(tbuilder.DATASETS) == 21 and len(tbuilder.MIXTURES) == 6


def test_mixture_parsing(monkeypatch):
    for b in (tbuilder, jbuilder):
        monkeypatch.setitem(b.MIXTURES, "mix_a", ["ds1", "ds2*2"])
        monkeypatch.setitem(b.MIXTURES, "mix_b", ["mix_a", "ds3@s1"])
    for mixture in ("mix_b+ds4", "longvideo_sft", "pretrain_mixture+mix_a*3", "dummy"):
        assert tbuilder.parse_mixture(mixture) == jbuilder.parse_mixture(mixture)
    assert tbuilder.parse_mixture("mix_b+ds4") == sorted(["ds1", "ds2*2", "ds3@s1", "ds4"])


def test_build_dataset_from_registry(env, tmp_path, monkeypatch):
    tok, cfg, tcfg, _ = env
    data = [{"conversations": [{"from": "human", "value": f"hi {i}"},
                               {"from": "gpt", "value": "hello"}]} for i in range(3)]
    p = tmp_path / "data.json"
    p.write_text(json.dumps(data))
    (tmp_path / "s1").mkdir()
    (tmp_path / "s1" / "tiny_text.json").write_text("[1]")
    monkeypatch.setenv("TINY_ROOT", str(tmp_path))
    for b in (tbuilder, jbuilder):
        monkeypatch.setitem(b.DATASETS, "tiny_text", {"type": "supervised",
                                                      "data_path": "${TINY_ROOT}/data.json"})
    for mixture in ("tiny_text*2", "tiny_text@s1+dummy"):
        got = tbuilder.build_dataset(mixture, tok, tcfg, subset_dir=str(tmp_path))
        want = jbuilder.build_dataset(mixture, tok, cfg, subset_dir=str(tmp_path))
        assert len(got) == len(want)
        for i in (0, len(want) - 1):
            assert_same_sample(got[i], want[i])
    with pytest.raises(ValueError, match="not found in the registry"):
        tbuilder.build_dataset("no_such_set", tok, tcfg)


def test_chip_smoke_mixture_equals_jax(env, tmp_path, monkeypatch):
    """`chip_smoke.write_corpus` (the `train_data` phase's corpus, small):
    its registry file read by each package's loader, the mixture built by
    each package, every sample equal."""
    sys.path.insert(0, REPO)
    from chip_smoke import CORPUS_MIXTURE, write_corpus

    tok, cfg, tcfg, _ = env
    sizes = dict(pairs=4, sft=2, docs=2, caption_pairs=4, textocr=2, lita=1, frames=3)
    reg, shards = write_corpus(str(tmp_path), 0, sizes, image_shape=(24, 32, 3))
    assert len(shards) == 3  # 4 pairs, 2 SFT records and 2 TextOCR records a shard
    entries = tio.load(reg)
    assert entries == yaml.safe_load(open(reg))
    monkeypatch.setenv("VILA_DATA_ROOT", str(tmp_path))
    for b in (tbuilder, jbuilder):
        for k, v in entries.items():
            monkeypatch.setitem(b.DATASETS, k, v)
    import dataclasses

    tcfg2 = dataclasses.replace(tcfg, num_video_frames=2)
    cfg2 = dataclasses.replace(cfg, num_video_frames=2)
    got = tbuilder.build_dataset(CORPUS_MIXTURE, tok, tcfg2)
    want = jbuilder.build_dataset(CORPUS_MIXTURE, tok, cfg2)
    assert [len(d) for d in got.datasets] == [len(d) for d in want.datasets] == [2, 1, 2, 2, 12]
    for i in range(len(want)):
        assert_same_sample(got[i], want[i])


@pytest.mark.parametrize("name", ["coyo_qa", "textocr", "lita_timed", "vflan", "cc3m_wds"])
def test_reference_registry_faults_are_mirrored(env, name, monkeypatch):
    """Every dataset_impl entry names its file under `records:`, which the
    `_impl` constructor does not take (`load_records(None)`); `cc3m_wds`
    gives `shard_glob:`, which `WebDatasetSupervised` does not take."""
    tok, cfg, tcfg, _ = env
    monkeypatch.setenv("VILA_DATA_ROOT", "/nonexistent")
    with pytest.raises(TypeError) as want:
        jbuilder.build_dataset(name, tok, cfg)
    with pytest.raises(TypeError) as got:
        tbuilder.build_dataset(name, tok, tcfg)
    assert str(got.value) == str(want.value)
    key = "shard_glob" if name == "cc3m_wds" else "records"
    assert key in tbuilder.DATASETS[name]
    if name == "cc3m_wds":
        assert "unexpected keyword argument 'shard_glob'" in str(got.value)


@pytest.mark.parametrize("mixture", ["sft_mixture", "video_sft_mixture", "longvideo_sft"])
def test_mixtures_with_records_entries_do_not_build(env, mixture, monkeypatch):
    tok, cfg, tcfg, _ = env
    monkeypatch.setenv("VILA_DATA_ROOT", "/nonexistent")
    for b, c in ((tbuilder, tcfg), (jbuilder, cfg)):
        with pytest.raises((TypeError, FileNotFoundError)):
            b.build_dataset(mixture, tok, c)


def test_short_video_filter(tmp_path, capsys):
    vdir = tmp_path / "videos"
    vdir.mkdir()
    (vdir / "good.mp4").write_bytes(b"x" * 200_000)
    (vdir / "small.mp4").write_bytes(b"x" * 10)
    records = [{"video": "good.mp4", "q": 1}, {"video": "small.mp4", "q": 2},
               {"video": "missing.mp4", "q": 3}, {"id": "good", "q": 4}]
    for kw in ({}, {"min_bytes": 5}, {"min_bytes": 5, "min_frames": 2}):
        got = tfilters.filter_videos(records, str(vdir), **kw)
        assert got == jfilters.filter_videos(records, str(vdir), **kw)
    assert [r["q"] for r in tfilters.filter_videos(records, str(vdir))] == [1, 4]
    assert tfilters.video_path_for({"id": 7}, "d") == jfilters.video_path_for({"id": 7}, "d")
    inp = tmp_path / "in.json"
    inp.write_text(json.dumps(records))
    outs = []
    for pkg in (tfilters, jfilters):
        out = tmp_path / f"{pkg.__name__}.json"
        assert pkg.main(["--input", str(inp), "--output", str(out),
                         "--video-dir", str(vdir)]) == 0
        outs.append(json.loads(out.read_text()))
    assert outs[0] == outs[1] and len(outs[0]) == 2
    assert capsys.readouterr().out == "kept 2/4 records\nkept 2/4 records\n"
