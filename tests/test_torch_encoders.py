"""The port's TSP video encoder (`vila_tpu_torch.models.encoders`) against
`vila_tpu/models/encoders.py` on the CPU: the temporal-spatial pooling, the
token counts and the encode of a frame stack at f32, then whole video
requests: the JAX and the port engine loaded from one tiny checkpoint give
the same greedy transcript (as `tests/test_encoders.py` drives the JAX
engine), and the continuous batcher admits S2 and TSP entries with the
serial engine's transcript."""

import concurrent.futures as cf
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helpers
from test_torch_media import media_engines, media_vlm
from vila_tpu import entry as jentry
from vila_tpu.inference import generate as jgen
from vila_tpu.media import Video as JVideo
from vila_tpu.models import encoders as jenc
from vila_tpu_torch import entry as tentry
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.media import Video
from vila_tpu_torch.models import encoders as tenc
from vila_tpu_torch.serving.batcher import ContinuousBatcher
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False

NEW_TOKENS = 8


@pytest.mark.parametrize("t,nl,pool", [(4, 4, (2, 2, 2)), (2, 3, (1, 1, 1)), (8, 4, (4, 1, 1)),
                                       (8, 4, (2, 2, 1)), (64, 16, (4, 1, 1))])
def test_tsp_pool_matches_jax(t, nl, pool):
    x = np.random.default_rng(t + nl).standard_normal((t, nl * nl, 6)).astype(np.float32)
    got = tenc.tsp_pool(torch.as_tensor(x), pool).numpy()
    want = np.asarray(jenc.tsp_pool(jnp.asarray(x), pool))
    assert got.shape == want.shape == (t // pool[0], (nl // pool[1]) * (nl // pool[2]), 6)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tsp_token_counts_match_jax():
    for ptype in ("mlp_downsample", "mlp_downsample_3x3_fix", "linear"):
        _, cfg, _, tcfg = media_vlm(projector_type=ptype)
        for frames, pools in ((8, [(2, 1, 1)]), (8, [(2, 1, 1), (4, 2, 2)]), (64, [(4, 1, 1)]),
                              (4, [(1, 1, 1), (2, 2, 2)])):
            if any(int(round(cfg.tokens_per_image ** 0.5)) % p[1] for p in pools):
                continue
            assert (tenc.tsp_tokens_per_video(tcfg, frames, pools)
                    == jenc.tsp_tokens_per_video(cfg, frames, pools))


@pytest.mark.parametrize("pools", [((1, 1, 1),), ((2, 1, 1), (4, 2, 2))])
def test_tsp_encode_video_matches_jax(pools):
    _, cfg, p, tcfg = media_vlm()
    frames = np.random.default_rng(3).integers(0, 256, (8, 56, 56, 3), np.uint8)
    want = np.asarray(jenc.tsp_encode_video(jax.tree.map(jnp.asarray, p), cfg,
                                            jnp.asarray(frames), pools))
    got = tenc.tsp_encode_video(weights.from_jax_params(p, device="cpu"), tcfg,
                                torch.as_tensor(frames), pools).numpy()
    assert got.shape == want.shape == (tenc.tsp_tokens_per_video(tcfg, 8, pools), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("pools", [((2, 1, 1),), ((1, 1, 1), (2, 2, 2))])
def test_video_tsp_generate_matches_the_jax_engine(tmp_path, pools):
    """Both packages load one tiny checkpoint (f32 on the CPU) with a TSP
    video encoder; a 4-frame video request expands to the same ids and
    media positions, its media embeddings agree, and greedy decoding gives
    the same transcript."""
    helpers.save_tiny_checkpoint(str(tmp_path))
    tsp = dict(video_encoder="tsp", tsp_pool_sizes=pools, num_video_frames=4)
    jengine = jentry.load(str(tmp_path))
    jengine.cfg = dataclasses.replace(jengine.cfg, **tsp)
    tengine = tentry.load(str(tmp_path), device="cpu")
    tengine.cfg = dataclasses.replace(tengine.cfg, **tsp)
    frames = [np.random.default_rng(i).integers(0, 255, (40, 52, 3), np.uint8)
              for i in range(4)]
    jin = jengine.prepare_inputs([JVideo(frames), "what happens?"])
    tin = tengine.prepare_inputs([Video(frames), "what happens?"])
    np.testing.assert_array_equal(tin["input_ids"], jin["input_ids"])
    np.testing.assert_array_equal(tin["media_pos"], jin["media_pos"])
    assert [e["kind"] for e in tin["media"]] == ["tsp"]
    want_m = np.asarray(jengine.encode_media(jin["media"]))
    got_m = tengine.encode_media(tin["media"]).numpy()
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-4 * np.abs(want_m).max())
    want = jengine.generate_ids(jin, jgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    got = tengine.generate_ids(tin, tgen.GenerationConfig(
        max_new_tokens=NEW_TOKENS, stop_token_ids=(-1,)))
    assert len(want) == NEW_TOKENS and got == want


@pytest.mark.parametrize("kw", [
    dict(scales=(56, 112), projector_type="mlp_downsample_3x3_fix",
         s2_resize_output_to_scale_idx=-1),
    dict(video_encoder="tsp", num_video_frames=8, tsp_pool_sizes=((2, 1, 1),)),
])
def test_batcher_admits_s2_and_tsp_entries(kw):
    """A dynamic-S2 image request and a TSP video request beside a text
    one on two slots: each transcript equals the serial engine's, and the
    serial engine's equals the JAX engine's."""
    jengine, tengine = media_engines(**kw)
    img = np.random.default_rng(5).integers(0, 256, (336, 448, 3), np.uint8)
    frames = [np.random.default_rng(6 + i).integers(0, 256, (60, 80, 3), np.uint8)
              for i in range(8)]
    media = Video(frames) if "video_encoder" in kw else img
    prompts = [[media, "describe"], "hello there"]
    gc = dict(max_new_tokens=6, do_sample=False, stop_token_ids=(-1,))
    serial = [tengine.generate_content(list(p) if isinstance(p, list) else p,
                                       tgen.GenerationConfig(**gc)) for p in prompts]
    jmedia = JVideo(frames) if "video_encoder" in kw else img
    assert serial[0] == jengine.generate_content([jmedia, "describe"],
                                                 jgen.GenerationConfig(**gc))
    batcher = ContinuousBatcher(tengine, max_batch=2, max_len=512)
    try:
        with cf.ThreadPoolExecutor(len(prompts)) as ex:
            futs = [ex.submit(batcher.generate_content, list(p) if isinstance(p, list) else p,
                              tgen.GenerationConfig(**gc)) for p in prompts]
            got = [f.result(timeout=300) for f in futs]
    finally:
        batcher.shutdown()
    assert got == serial
