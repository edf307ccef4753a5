"""The port's data path and trainer on the CPU: the sampler, both
collators, `DummyDataset` and `build_dataset` bit for bit against the JAX
package (with `helpers.make_tiny_tokenizer`), `chip_smoke.ByteTokenizer`'s
ids and labels against the tiny tokenizer's, and the `Trainer`: the loss
falls, a resumed run reproduces the uninterrupted one, preemption saves
and exits 124, `log_history.json` is written, the parser's presets."""

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from helpers import make_tiny_tokenizer  # noqa: E402

from vila_tpu.data import collate as jcollate  # noqa: E402
from vila_tpu.data import sampler as jsampler  # noqa: E402
from vila_tpu.data.dummy import DummyDataset as JDummy  # noqa: E402
from vila_tpu.data.tokenizer_utils import add_media_tokens as jadd_media  # noqa: E402
from vila_tpu.models import projector as jproj  # noqa: E402
from vila_tpu.models import qwen2 as jqwen2  # noqa: E402
from vila_tpu.models import siglip as jsiglip  # noqa: E402
from vila_tpu.models import vlm as jvlm  # noqa: E402
from vila_tpu_torch.cli.train import STAGE_PRESETS, build_parser, train_args  # noqa: E402
from vila_tpu_torch.constants import IGNORE_INDEX  # noqa: E402
from vila_tpu_torch.data import builder as tbuilder  # noqa: E402
from vila_tpu_torch.data import collate as tcollate  # noqa: E402
from vila_tpu_torch.data import sampler as tsampler  # noqa: E402
from vila_tpu_torch.data.dummy import DummyDataset as TDummy  # noqa: E402
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens as tadd_media  # noqa: E402
from vila_tpu_torch.data.tokenizer_utils import preprocess_conversation  # noqa: E402
from vila_tpu_torch.models import projector as tproj  # noqa: E402
from vila_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from vila_tpu_torch.models import siglip as tsiglip  # noqa: E402
from vila_tpu_torch.models import vlm as tvlm  # noqa: E402
from vila_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402
from vila_tpu_torch.train.trainer import TrainArgs, Trainer  # noqa: E402


def _jcfg():
    llm = jqwen2.LLMConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2)
    vis = jsiglip.SigLIPConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=4, image_size=56, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type="mlp_downsample", mm_hidden_size=24,
                                 hidden_size=32)
    return jvlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def _tcfg():
    j = _jcfg()
    same = lambda cls, c: cls(**{k: getattr(c, k) for k in cls.__dataclass_fields__})  # noqa: E731
    return tvlm.VLMConfig(llm=same(tqwen2.LLMConfig, j.llm),
                          vision=same(tsiglip.SigLIPConfig, j.vision),
                          projector=same(tproj.ProjectorConfig, j.projector))


def _tokenizer(add_media):
    tok = make_tiny_tokenizer()
    add_media(tok)
    return tok


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(lengths=[37], world_size=1, batch_size=4),
    dict(lengths=[23, 17, 9], rank=3, world_size=4, sp_degree=2, batch_size=2),
    dict(lengths=[40, 11], rank=1, world_size=2, batch_size=3, batch_shuffle=True),
])
def test_sampler_matches_jax(kw):
    lengths = kw.pop("lengths")
    for epoch in (0, 1):
        j = jsampler.DistributedSampler(lengths, seed=5, **kw)
        t = tsampler.DistributedSampler(lengths, seed=5, **kw)
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


def test_dummy_dataset_and_collators_match_jax():
    """DummyDataset (image and text samples) bit for bit, then both
    collators over a mixed batch: padding, packing with first-token
    masking, truncation into the emptiest row, media sentinels."""
    jtok, ttok = _tokenizer(jadd_media), _tokenizer(tadd_media)
    jds = JDummy(jtok, _jcfg(), num_instances=8, with_images=True)
    tds = TDummy(ttok, _tcfg(), num_instances=8, with_images=True)
    jtxt = JDummy(jtok, _jcfg(), num_instances=4)
    ttxt = TDummy(ttok, _tcfg(), num_instances=4)
    jex = [jds[i] for i in range(8)] + [jtxt[i] for i in range(4)]
    tex = [tds[i] for i in range(8)] + [ttxt[i] for i in range(4)]
    for a, b in zip(tex, jex):
        _assert_same(a, b)
    assert tex[0]["tiles"].shape == (1, 56, 56, 3) and len(tex[0]["media_positions"]) == 4
    for jc, tc in (
        (jcollate.Collator(seq_len=60, tile_size=56), tcollate.Collator(seq_len=60, tile_size=56)),
        (jcollate.PackingCollator(seq_len=150, rows=3, tile_size=56),
         tcollate.PackingCollator(seq_len=150, rows=3, tile_size=56)),
    ):
        for sl in (slice(0, 5), slice(6, 12), slice(8, 12)):
            _assert_same(tc(tex[sl]), jc(jex[sl]))


def test_build_dataset_dummy_mixture():
    ttok = _tokenizer(tadd_media)
    ds = tbuilder.build_dataset("dummy_mix", ttok, _tcfg())
    assert tbuilder.parse_mixture("dummy_mix") == ["dummy", "dummy-image"]
    assert [len(d) for d in ds.datasets] == [64, 64] and len(ds) == 128
    assert ds[0]["tiles"].shape[0] == 0 and ds[64]["tiles"].shape[0] == 1
    rep = tbuilder.build_dataset("dummy*3", ttok, _tcfg())
    assert len(rep) == 192
    with pytest.raises(ValueError, match="not found"):
        tbuilder.build_dataset("no_such_set", ttok, _tcfg())


def test_chip_smoke_byte_tokenizer_labels_match_tiny_tokenizer():
    """The smoke's ByteTokenizer gives the tokens and the supervised label
    positions of the tiny HF tokenizer for the same conversation (their id
    numbering differs: compare the decoded tokens)."""
    from chip_smoke import ByteTokenizer

    conv = [{"from": "human", "value": "<image>\nquestion 3: 1 2 3"},
            {"from": "gpt", "value": "answer 3: 4 5 6"},
            {"from": "human", "value": "and more?"},
            {"from": "gpt", "value": "done."}]
    got = preprocess_conversation(conv, ByteTokenizer())
    tiny = _tokenizer(tadd_media)
    want = preprocess_conversation(conv, tiny)
    btok = ByteTokenizer()
    assert len(got["input_ids"]) == len(want["input_ids"])
    assert [btok.decode([i]) for i in got["input_ids"]] == \
        [tiny.decode([int(i)]) for i in want["input_ids"]]
    np.testing.assert_array_equal(got["labels"] == IGNORE_INDEX,
                                  want["labels"] == IGNORE_INDEX)
    assert (got["labels"] != IGNORE_INDEX).sum() > 10


# --------------------------------------------------------------------------
# Trainer
# --------------------------------------------------------------------------


class ToyDataset:
    """Memorisable text-only sequences."""

    def __init__(self, n=16, seq=24, vocab=64):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            ids = rng.integers(2, vocab, seq).astype(np.int32)
            self.items.append({"input_ids": ids, "labels": ids.copy(),
                               "tiles": np.zeros((0, 28, 28, 3), np.uint8),
                               "media_positions": np.zeros((0,), np.int32)})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _toy_cfg():
    llm = tqwen2.LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2)
    vis = tsiglip.SigLIPConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=4, image_size=28, patch_size=14)
    proj = tproj.ProjectorConfig(mm_hidden_size=24, hidden_size=32)
    return tvlm.VLMConfig(llm=llm, vision=vis, projector=proj)


def _params():
    return tvlm.init_params(torch.Generator().manual_seed(0), _toy_cfg())


def _args(out, **kw):
    base = dict(output_dir=str(out), max_steps=8, per_device_batch_size=4, seq_len=24,
                learning_rate=1e-3, warmup_ratio=0.0, lr_schedule="constant",
                logging_steps=1, save_steps=4)
    base.update(kw)
    return TrainArgs(**base)


def test_trainer_loss_falls_and_resume_matches(tmp_path):
    ds, coll = ToyDataset(), tcollate.Collator(seq_len=24)
    trainer = Trainer(_toy_cfg(), _params(), ds, coll, _args(tmp_path), device="cpu")
    hist = trainer.train()["log_history"]
    assert [h["step"] for h in hist] == list(range(1, 9))
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] and np.mean(losses[-3:]) < np.mean(losses[:3])
    ckpt = CheckpointManager(os.path.join(tmp_path, "checkpoints"))
    assert ckpt.steps() == [4, 8] and ckpt.latest_step() == 8
    assert os.path.exists(os.path.join(tmp_path, "checkpoints", "metadata-4.json"))
    with open(os.path.join(tmp_path, "log_history.json")) as f:
        assert [h["loss"] for h in json.load(f)] == [h["loss"] for h in hist]
    assert os.path.getsize(os.path.join(tmp_path, "metrics.jsonl")) > 0

    # drop the last checkpoint: a fresh trainer resumes at 4 and must
    # reproduce steps 5-8 of the uninterrupted run
    import shutil

    shutil.rmtree(os.path.join(tmp_path, "checkpoints", "checkpoint-8"))
    again = Trainer(_toy_cfg(), _params(), ds, coll, _args(tmp_path), device="cpu")
    assert again.start_step == 4
    hist2 = again.train()["log_history"]
    assert [h["step"] for h in hist2] == [5, 6, 7, 8]
    np.testing.assert_allclose([h["loss"] for h in hist2],
                               [h["loss"] for h in hist[4:]], rtol=1e-6)
    for a, b in zip(hist2, hist[4:]):
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-6)


def test_checkpoint_pruning_and_atomic_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, {"x": torch.full((2,), float(step))}, metadata={"step": step})
    assert mgr.steps() == [2, 3]
    assert not os.path.exists(tmp_path / "metadata-1.json")
    assert [p for p in os.listdir(tmp_path) if ".tmp" in p] == []
    assert torch.equal(mgr.restore(3)["x"], torch.full((2,), 3.0))
    mgr.wait()


def test_preemption_saves_and_exits_124(tmp_path):
    ds, coll = ToyDataset(), tcollate.Collator(seq_len=24)
    args = _args(tmp_path, total_time_limit_s=0.0, save_margin_s=0.0)
    trainer = Trainer(_toy_cfg(), _params(), ds, coll, args, device="cpu")
    with pytest.raises(SystemExit) as e:
        trainer.train()
    assert e.value.code == 124
    assert trainer.ckpt.latest_step() == 1
    with open(os.path.join(tmp_path, "log_history.json")) as f:
        assert [h["step"] for h in json.load(f)] == [1]


def test_profile_steps_write_a_trace(tmp_path):
    ds, coll = ToyDataset(), tcollate.Collator(seq_len=24)
    args = _args(tmp_path, max_steps=3, save_steps=100, profile_step=1,
                 profile_num_steps=2)
    Trainer(_toy_cfg(), _params(), ds, coll, args, device="cpu").train()
    prof = os.path.join(tmp_path, "profile")
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0
    with open(os.path.join(prof, "ops.txt")) as f:
        assert "aten::" in f.read()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """dp / sp / su / tp > 1 without a process a device (no process group)
    raise; tp = 2 on two gloo processes runs and logs the one-process
    run's losses and grad norms (rtol 2e-5: the same global batches, the
    products split over two ranks). The other mesh runs are
    `test_torch_sp.py`'s and `test_torch_tp_train.py`'s."""
    import torch_dist_helpers as dh

    ds, coll = ToyDataset(), tcollate.Collator(seq_len=24)
    for axis in ("dp", "sp", "su", "tp"):
        with pytest.raises(ValueError, match="one process a device"):
            Trainer(_toy_cfg(), _params(), ds, coll, _args(tmp_path, **{axis: 2}),
                    device="cpu")
    cfg = _toy_cfg()
    targs = dict(max_steps=3, per_device_batch_size=4, seq_len=24, learning_rate=1e-3,
                 warmup_ratio=0.0, lr_schedule="constant", logging_steps=1, save_steps=3)
    params = dh._tree(_params(), lambda t: t.numpy())
    ranks = dh.spawn([("trainer_run", dict(
        mesh_axes=dict(tp=2), cfg=dict(llm=dh.config_fields(cfg.llm),
                                       vision=dh.config_fields(cfg.vision),
                                       projector=dh.config_fields(cfg.projector)),
        params=params, examples=ds.items, targs=dict(targs, tp=2, distributed=False),
        out_dir=str(tmp_path / "tp2")))], 2)
    one = Trainer(cfg, _params(), ds, coll, TrainArgs(output_dir=str(tmp_path / "one"), **targs),
                  device="cpu").train()["log_history"]
    want = [(h["step"], h["loss"], h["grad_norm"]) for h in one]
    for rows in ranks:
        assert [r[0] for r in rows[0]] == [w[0] for w in want] == [1, 2, 3]
        np.testing.assert_allclose([r[1:] for r in rows[0]], [w[1:] for w in want], rtol=2e-5)


def test_parser_stage_presets():
    ns = build_parser().parse_args(["--model-path", "m", "--stage", "sft",
                                    "--max-steps", "7", "--mm-projector-lr", "1e-4",
                                    "--ce-chunk-size", "256"])
    args = train_args(ns)
    assert args.max_steps == 7 and args.ce_chunk_size == 256
    assert args.mm_projector_lr == 1e-4 and args.vision_tower_lr == 2e-6
    assert args.learning_rate == STAGE_PRESETS["sft"]["learning_rate"]
    assert train_args(build_parser().parse_args(["--model-path", "m", "--stage", "align"])
                      ).tune_vision_tower is False
