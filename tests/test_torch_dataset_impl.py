"""The port's dataset zoo (`vila_tpu_torch/data/dataset_impl.py`) against
the JAX package's (`vila_tpu/data/dataset_impl.py`) on the records of
`tests/test_dataset_impl.py`, through one tokenizer object
(`helpers.make_tiny_tokenizer`) and a tiny config:

* each record type's conversation (`to_instance`) and processed sample
  (token ids, labels, media positions, uint8 tiles) equal bit for bit,
  also after resample-on-failure (both draw the same record);
* `WDSRecordAdapter` over a tar shard, and the registry's `_impl`
  constructors with `shards` / `data_path`, give the same records and
  samples; a shard-backed entry built through each package's
  `build_dataset` from records written by the port's `prep`;
* the port's own `tokenizer.json` reader gives the same samples as the
  JAX side's `transformers` tokenizer.
"""

import io
import json
import tarfile

import numpy as np
import pytest

from torch_data_helpers import assert_same_sample, data_env, image, jpeg_bytes
from vila_tpu.data import builder as jbuilder
from vila_tpu.data import dataset_impl as J
from vila_tpu_torch.data import builder as tbuilder
from vila_tpu_torch.data import dataset_impl as T
from vila_tpu_torch.data import prep


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    return data_env(str(tmp_path_factory.mktemp("tok")))


def _pair(env, cls, records, port_tok=False, **kw):
    tok, cfg, tcfg, jtok = env
    return (getattr(T, cls)(jtok if port_tok else tok, tcfg, records, **kw),
            getattr(J, cls)(tok, cfg, records, **kw))


def _same(env, cls, records, idx=(0,), port_tok=False, **kw):
    got, want = _pair(env, cls, records, port_tok, **kw)
    for i in idx:
        assert got.to_instance(records[i]) == want.to_instance(records[i])
    got, want = _pair(env, cls, records, port_tok, **kw)  # fresh draws
    for i in idx:
        assert_same_sample(got[i], want[i])
    return got


RECORDS = {
    "CoyoQADataset": [{"image": image(0), "qa": {"spatial": "left of the cat", "ocr": "STOP",
                                                 "unknown": "x"}}],
    "CoyoRecapDataset": [{"image": image(1), "recap": "long", "caption": "short"},
                         {"image": image(2), "text": "alt text"}],
    "GeneralImageTextDataset": [{"image": image(3), "text": "a photo"},
                                {"image": image(4), "caption": "a caption"}],
    "SAMCaptionDataset": [{"image": image(5), "caption": "a dense caption"}],
    "TextOCRDataset": [{"image": image(6), "width": 100, "height": 100, "anns": [
        {"utf8_string": "STOP", "points": [10, 10, 30, 10, 30, 20, 10, 20]},
        {"utf8_string": ".", "bbox": [0, 0, 1, 1]},
        {"utf8_string": "GO", "bbox": [5, 6, 10, 20]}]}],
    "HierTextDataset": [{"image": image(7), "paragraphs": [
        {"lines": [{"words": [{"text": "hello"}, {"text": "world"}]}]},
        {"lines": [{"words": [{"text": "second"}, {"text": ""}]}, {"words": []}]}]}],
    "LLaVACoTDataset": [{"image": image(8), "question": "why?", "summary": "s",
                         "reasoning": "r", "conclusion": "c"},
                        {"image": image(9), "conversations": [
                            {"from": "human", "value": "<image>\nwhat?"},
                            {"from": "gpt", "value": "<SUMMARY> x </SUMMARY>"}]}],
}


@pytest.mark.parametrize("cls", sorted(RECORDS))
def test_record_types_match_jax(env, cls):
    _same(env, cls, RECORDS[cls], idx=range(len(RECORDS[cls])))


def test_general_img_text_qa_mode_and_textocr_without_boxes(env):
    _same(env, "GeneralImageTextDataset", RECORDS["GeneralImageTextDataset"], idx=(0, 1),
          mode="qa")
    got = _same(env, "TextOCRDataset", RECORDS["TextOCRDataset"], with_bbox=False)
    assert got.to_instance(RECORDS["TextOCRDataset"][0])["conversations"][1]["value"] == \
        "STOP, GO"


def test_textocr_bbox_serialization(env):
    got, _ = _pair(env, "TextOCRDataset", RECORDS["TextOCRDataset"])
    ans = got.to_instance(RECORDS["TextOCRDataset"][0])["conversations"][1]["value"]
    assert ans == "STOP [0.10,0.10,0.30,0.20], GO [0.05,0.06,0.15,0.26]"


def test_hiertext_paragraph_order(env):
    got, _ = _pair(env, "HierTextDataset", RECORDS["HierTextDataset"])
    inst = got.to_instance(RECORDS["HierTextDataset"][0])
    assert inst["conversations"][1]["value"] == "hello world\nsecond"


@pytest.mark.parametrize("kw", [{"num_time_tokens": 11}, {}])
def test_video_records_match_jax(env, kw):
    lita = {"video": "v.mp4", "duration": 10.0, "events": [
        {"start": 0.0, "end": 5.0, "caption": "a"}, {"start": 5.0, "end": 10.0, "caption": "b"}]}
    undated = {"video": "w.mp4", "events": [{"start": 1.0, "end": 2.5, "caption": "c"}]}
    got, want = _pair(env, "LITADataset", [lita, undated], **kw)
    for r in (lita, undated):
        assert got.to_instance(r) == want.to_instance(r)
    if kw:
        ans = got.to_instance(lita)["conversations"][1]["value"]
        assert ans == "<t0> <t5> a <t5> <t10> b"
    panda = {"video": "p.mp4", "caption": "a clip"}
    got, want = _pair(env, "Panda70MDataset", [panda])
    assert got.to_instance(panda) == want.to_instance(panda)


def test_resample_on_failure_draws_as_jax(env):
    records = [{"image": image(10), "qa": {}}]  # no usable formats -> error
    records += [{"image": image(11 + i), "qa": {"ocr": f"text {i}"}} for i in range(4)]
    got, want = _pair(env, "CoyoQADataset", records, seed=3)
    assert_same_sample(got[0], want[0])
    strict, _ = _pair(env, "CoyoQADataset", records, resample_on_failure=False)
    with pytest.raises(ValueError, match="without usable qa formats"):
        strict[0]


def test_llava_dataset_binds_paths(env, tmp_path):
    tok, cfg, tcfg, _ = env
    image(12).save(tmp_path / "a.png")
    data = [{"image": "a.png", "conversations": [
        {"from": "human", "value": "<image>\nhi"}, {"from": "gpt", "value": "hello"}]}]
    p = tmp_path / "llava.json"
    p.write_text(json.dumps(data))
    got = T.LLaVADataset(tok, tcfg, str(p), media_dir=str(tmp_path))
    want = J.LLaVADataset(tok, cfg, str(p), media_dir=str(tmp_path))
    assert_same_sample(got[0], want[0])


def _shard(path, n=3):
    with tarfile.open(path, "w") as tf:
        for i in range(n):
            for name, data in ((f"{i:05d}.jpg", jpeg_bytes(i)),
                               (f"{i:05d}.json", json.dumps(
                                   {"qa": {"spatial": f"answer {i}"}}).encode()),
                               (f"{i:05d}.txt", f"caption {i}".encode())):
                ti = tarfile.TarInfo(name)
                ti.size = len(data)
                tf.addfile(ti, io.BytesIO(data))


def test_wds_adapter_and_registry_ctors(env, tmp_path):
    tok, cfg, tcfg, _ = env
    shard = str(tmp_path / "shard-000.tar")
    _shard(shard)
    got, want = T.WDSRecordAdapter([shard]), J.WDSRecordAdapter([shard])
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert np.array_equal(np.asarray(a.pop("image")), np.asarray(b.pop("image")))
        assert a == b == {"qa": {"spatial": f"answer {i}"}, "caption": f"caption {i}"}
    assert sorted(tbuilder.DATASET_TYPES) == sorted(jbuilder.DATASET_TYPES)
    for name in ("coyo_qa", "coyo_recap", "general_img_text", "sam"):
        t = tbuilder.DATASET_TYPES[name](tokenizer=tok, cfg=tcfg, shards=[shard])
        j = jbuilder.DATASET_TYPES[name](tokenizer=tok, cfg=cfg, shards=[shard])
        assert len(t) == len(j) == 3
        assert_same_sample(t[2], j[2])
    records = tmp_path / "records.jsonl"
    records.write_text("\n".join(json.dumps({"image": str(tmp_path / f"{i}.png"),
                                             "caption": f"c{i}"}) for i in range(2)))
    for i in range(2):
        image(20 + i).save(tmp_path / f"{i}.png")
    t = tbuilder.DATASET_TYPES["sam"](tokenizer=tok, cfg=tcfg, data_path=str(records))
    j = jbuilder.DATASET_TYPES["sam"](tokenizer=tok, cfg=cfg, data_path=str(records))
    assert_same_sample(t[1], j[1])


def test_prep_shards_through_build_dataset(env, tmp_path, monkeypatch):
    """Records with images -> the port's `sft_json_to_shards` -> one
    registry entry with `shards` -> each package's `build_dataset`."""
    tok, cfg, tcfg, _ = env
    media = tmp_path / "imgs"
    media.mkdir()
    recs = []
    for i in range(5):
        image(30 + i).save(media / f"im{i}.jpg")
        recs.append({"qa": {"ocr": f"text {i}"}, "image": f"im{i}.jpg"})
    inp = tmp_path / "records.json"
    inp.write_text(json.dumps(recs))
    shards = prep.sft_json_to_shards(str(inp), str(media), str(tmp_path / "shards"),
                                     prefix="toy", samples_per_shard=2)
    assert len(shards) == 3
    entry = {"type": "coyo_qa", "shards": shards}
    monkeypatch.setitem(tbuilder.DATASETS, "toy_qa", entry)
    monkeypatch.setitem(jbuilder.DATASETS, "toy_qa", entry)
    monkeypatch.chdir(media)  # the json's relative image name replaces the jpg
    got = tbuilder.build_dataset("toy_qa", tok, tcfg)
    want = jbuilder.build_dataset("toy_qa", tok, cfg)
    assert len(got) == len(want) == 5
    for i in (4, 0):
        assert_same_sample(got[i], want[i])
        assert got[i]["tiles"].shape[0] == 1


def test_port_tokenizer_reader_gives_the_same_samples(env):
    for cls in ("CoyoQADataset", "TextOCRDataset", "LLaVACoTDataset"):
        _same(env, cls, RECORDS[cls], idx=range(len(RECORDS[cls])), port_tok=True)
