"""The port's training data path for video samples and the dynamic tilings
(`vila_tpu_torch/data/dataset.py`, `data/collate.py`) against the JAX
package's (`vila_tpu/data/dataset.py`, `collate.py`) on the CPU.

* `BaseDataset.process` of a video sample (a frame list, a frame directory
  and a video file), of a single `dynamic`-tiled image, of a single
  `dynamic_s2` image (two output scales) and of several images under
  `dynamic` (resized): input_ids, labels, media positions, tiles and block
  sizes equal bit for bit;
* `Collator` and `PackingCollator` of those samples: every batch array
  equal bit for bit;
* one `vlm.forward_batch` loss on a collated video batch at a tiny f32
  config: the port within 1e-5 (relative) of JAX;
* the reference's dynamic-S2 training fault, mirrored: a dynamic-S2
  sample's token count is not a multiple of its tile count, and both
  packages fail at the same stage (the collators' media-position rows, or
  `forward_batch`'s projector, which gets one scale's channels).

The JAX side reads the tokenizer through `transformers`, the port through
its own `JsonTokenizer` of the same `tokenizer.json`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from test_torch_media import media_vlm
from vila_tpu.data import collate as jcollate
from vila_tpu.data.dataset import BaseDataset as JDataset
from vila_tpu.media import Video as JVideo
from vila_tpu.models import vlm as jvlm
from vila_tpu.train import losses as jlosses
from vila_tpu_torch.data import collate as tcollate
from vila_tpu_torch.data.dataset import BaseDataset as TDataset
from vila_tpu_torch.data.tokenizer_json import JsonTokenizer
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens
from vila_tpu_torch.media import Video as TVideo
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.train import losses as tlosses
from vila_tpu_torch.utils import weights

PIL = pytest.importorskip("PIL.Image")

LOSS_RTOL = 1e-5  # f32 on both sides, sums in another order


@pytest.fixture(scope="module")
def port_tok(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tok"))
    helpers.make_tiny_tokenizer().save_pretrained(path)
    tok = JsonTokenizer.from_pretrained(path)
    add_media_tokens(tok)
    return tok


def _frames(n, seed=0, shape=(48, 64, 3)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


def _png(path, seed, shape):
    PIL.fromarray(np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)).save(path)
    return path


def _conv(marker, answer="A cat walks across the room."):
    return [{"from": "human", "value": f"{marker}\nWhat happens here?"},
            {"from": "gpt", "value": answer}]


def _datasets(port_tok, instances, **vlm_fields):
    jtok, cfg, p, tcfg = media_vlm(**vlm_fields)
    jds = JDataset(jtok, cfg, instances=instances[0], resample_on_failure=False)
    tds = TDataset(port_tok, tcfg, instances=instances[1], resample_on_failure=False)
    return jds, tds, cfg, p, tcfg


def _assert_same_sample(want, got):
    assert set(got) == set(want)
    for k in ("input_ids", "labels", "media_positions", "tiles"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if "block_sizes" in want:
        assert [tuple(b) for b in got["block_sizes"]] == [tuple(b) for b in want["block_sizes"]]


def _video_instances(kind, tmp_path):
    frames = _frames(7)
    if kind == "frames":
        return ([{"video": JVideo(frames), "conversations": _conv("<video>")}],
                [{"video": TVideo(frames), "conversations": _conv("<video>")}])
    if kind == "directory":
        path = str(tmp_path / "frames")
        os.makedirs(path)
        for i, f in enumerate(frames):
            PIL.fromarray(f).save(os.path.join(path, f"{i:02d}.png"))
    else:
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
        for f in frames:
            writer.write(f)
        writer.release()
    inst = {"video": path, "conversations": _conv("<video>")}
    return [inst], [dict(inst)]


@pytest.mark.parametrize("kind", ["frames", "directory", "file"])
def test_video_sample_equals_jax(port_tok, tmp_path, kind):
    jds, tds, cfg, _, _ = _datasets(port_tok, _video_instances(kind, tmp_path),
                                    num_video_frames=4)
    want, got = jds[0], tds[0]
    _assert_same_sample(want, got)
    # the video marker became one image marker (and placeholder run) a frame
    assert got["tiles"].shape[0] == 4
    assert len(got["media_positions"]) == 4 * cfg.tokens_per_image


def _image_instances(tmp_path, shapes, marker="<image>"):
    paths = [_png(str(tmp_path / f"img{i}.png"), i, s) for i, s in enumerate(shapes)]
    inst = {"image": paths if len(paths) > 1 else paths[0],
            "conversations": _conv(marker * len(paths))}
    return [inst], [dict(inst)]


TILINGS = {
    "dynamic": (dict(image_aspect_ratio="dynamic", max_tiles=6), [(100, 170, 3)]),
    "dynamic_several": (dict(image_aspect_ratio="dynamic", max_tiles=6),
                        [(100, 170, 3), (60, 60, 3)]),
    "dynamic_s2": (dict(scales=(56, 112), max_tiles=12), [(112, 168, 3)]),
    "dynamic_s2_last": (dict(scales=(56, 112), max_tiles=12,
                             s2_resize_output_to_scale_idx=-1), [(112, 168, 3)]),
    "dynamic_s2_several": (dict(scales=(56, 112), max_tiles=12),
                           [(112, 168, 3), (60, 80, 3)]),
}


@pytest.mark.parametrize("name", sorted(TILINGS))
def test_dynamic_tiling_samples_equal_jax(port_tok, tmp_path, name):
    fields, shapes = TILINGS[name]
    jds, tds, cfg, _, _ = _datasets(port_tok, _image_instances(tmp_path, shapes), **fields)
    want, got = jds[0], tds[0]
    _assert_same_sample(want, got)
    if name == "dynamic":
        assert got["tiles"].shape[0] > 1  # a marker and a "\n" per tile
        assert len(got["media_positions"]) == got["tiles"].shape[0] * cfg.tokens_per_image
    if name.startswith("dynamic_s2") and len(shapes) == 1:
        assert got["block_sizes"] == [(2, 3)]
    if name.endswith("several"):
        assert "block_sizes" not in got and got["tiles"].shape[0] == len(shapes)


def _collated(port_tok, tmp_path):
    """A video sample and a dynamic-tiled sample through both packages."""
    vj, vt = _video_instances("frames", tmp_path)
    dj, dt = _image_instances(tmp_path, [(100, 170, 3)])
    out = {}
    for key, (inst, fields) in {
        "video": ((vj, vt), dict(num_video_frames=4)),
        "dynamic": ((dj, dt), dict(image_aspect_ratio="dynamic", max_tiles=6)),
    }.items():
        jds, tds, cfg, p, tcfg = _datasets(port_tok, inst, **fields)
        out[key] = (jds[0], tds[0], cfg, p, tcfg)
    return out


@pytest.mark.parametrize("collator", ["Collator", "PackingCollator"])
def test_collated_media_batches_equal_jax(port_tok, tmp_path, collator):
    samples = _collated(port_tok, tmp_path)
    kw = dict(seq_len=512, tile_size=56) if collator == "Collator" else dict(
        seq_len=384, rows=2, tile_size=56)
    for key in ("video", "dynamic"):
        want, got = samples[key][:2]
        jb = getattr(jcollate, collator)(**kw)([want, want])
        tb = getattr(tcollate, collator)(**kw)([got, got])
        assert set(tb) == set(jb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"{key} {k}")


def test_forward_batch_loss_on_a_video_batch_equals_jax(port_tok, tmp_path):
    """Both videos' frames packed into one row (segments, media positions
    shifted by each sample's offset), the vision tower over every frame,
    the LLM's loss: the port within LOSS_RTOL of JAX, on the CPU in f32."""
    want, got, cfg, p, tcfg = _collated(port_tok, tmp_path)["video"]
    jb = jcollate.PackingCollator(seq_len=384, rows=1, tile_size=56)([want, want])
    tb = tcollate.PackingCollator(seq_len=384, rows=1, tile_size=56)([got, got])
    assert (jb["segment_ids"] == 2).any() and jb["pixel_values"].shape[1] == 8
    jlogits = jvlm.forward_batch(jax.tree.map(jnp.asarray, p), cfg,
                                 {k: jnp.asarray(v) for k, v in jb.items()})
    jloss, jn = jlosses.causal_lm_loss(jlogits, jnp.asarray(jb["labels"]))
    tlogits = tvlm.forward_batch(weights.from_jax_params(p, device="cpu"), tcfg,
                                 {k: torch.as_tensor(v) for k, v in tb.items()})
    tloss, tn = tlosses.causal_lm_loss(tlogits, torch.as_tensor(tb["labels"]).long())
    assert int(tn) == int(jn) > 0
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=LOSS_RTOL)


def _stage(collate, forward, batch_of):
    """Where a dynamic-S2 sample's training fails: "collate" or "forward"
    (or "ok")."""
    try:
        batch = collate()
    except ValueError:
        return "collate"
    try:
        forward(batch_of(batch))
    except (ValueError, RuntimeError):
        return "forward"
    return "ok"


@pytest.mark.parametrize("scale_idx,collator", [(0, "Collator"), (0, "PackingCollator"),
                                                (-1, "Collator"), (-1, "PackingCollator")])
def test_dynamic_s2_training_fault_is_mirrored(port_tok, tmp_path, scale_idx, collator):
    """The reference's collators derive tokens per tile as
    len(media_positions) // tiles, and `forward_batch` encodes every tile
    as one plain image: a dynamic-S2 sample (7 tiles of two scales, 4 or 24
    tokens) cannot be trained. Both packages fail at the same stage."""
    jds, tds, cfg, p, tcfg = _datasets(
        port_tok, _image_instances(tmp_path, [(112, 168, 3)]), scales=(56, 112),
        max_tiles=12, s2_resize_output_to_scale_idx=scale_idx)
    want, got = jds[0], tds[0]
    _assert_same_sample(want, got)
    assert len(got["media_positions"]) % got["tiles"].shape[0]  # no whole count a tile
    kw = dict(seq_len=256, tile_size=56) if collator == "Collator" else dict(
        seq_len=256, rows=1, tile_size=56)
    jstage = _stage(lambda: getattr(jcollate, collator)(**kw)([want]),
                    lambda b: jvlm.forward_batch(jax.tree.map(jnp.asarray, p), cfg, b),
                    lambda b: {k: jnp.asarray(v) for k, v in b.items()})
    tstage = _stage(lambda: getattr(tcollate, collator)(**kw)([got]),
                    lambda b: tvlm.forward_batch(weights.from_jax_params(p, device="cpu"),
                                                 tcfg, b),
                    lambda b: {k: torch.as_tensor(v) for k, v in b.items()})
    assert tstage == jstage != "ok"
    assert jstage == ("forward" if (scale_idx, collator) == (0, "Collator") else "collate")
