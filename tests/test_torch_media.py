"""The port's host media path (`vila_tpu_torch.data.preprocess`,
`utils.imageproc`, `utils.media_loader`, `GenerationEngine.prepare_inputs`)
against the JAX package's, on the CPU: every tile, resized frame, token id
and media position must be equal, not close.

* the aspect-ratio search and the dynamic, dynamic-S2 and longest-edge
  tilings of seeded images, uint8 tiles bit for bit with equal block sizes;
* the native bicubic resize (the port's copy of `native/imageproc.cpp`),
  bit for bit against JAX's `resize_frames` / `resize_pil_batch`, and no
  PIL fallback where the library cannot be built;
* `load_video_frames` on a frame list, a frame directory and an unreadable
  file (the reference's black frames);
* `prepare_inputs` for dynamic tiles, a dynamic-S2 image, several images
  under dynamic-S2 (1x1-block S2 entries), basic and TSP video.

`media_vlm` builds the tiny VLMs the media tests share: a JAX config,
numpy-drawn parameters in its tree layout and the port's config.
"""

import dataclasses

import jax
import numpy as np
import pytest

import helpers
from vila_tpu.data import preprocess as jpre
from vila_tpu.data.tokenizer_utils import add_media_tokens
from vila_tpu.inference import generate as jgen
from vila_tpu.media import Video as JVideo
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import siglip as jsiglip
from vila_tpu.models import vlm as jvlm
from vila_tpu.utils import imageproc as jimg
from vila_tpu.utils import media_loader as jloader
from vila_tpu_torch.data import preprocess as tpre
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.media import Video
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.utils import imageproc as timg
from vila_tpu_torch.utils import media_loader as tloader
from vila_tpu_torch.utils import weights

PIL = pytest.importorskip("PIL.Image")


def _same(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def media_vlm(projector_type="mlp_downsample", scales=None, seed=0, **vlm_fields):
    """(tokenizer, JAX VLMConfig, numpy params, port VLMConfig) of a tiny
    f32 VLM: 2-layer LLM (D 64), 2-layer SigLIP at 56² (4 x 4 patches of
    48 channels); with `scales` the projector takes every scale's features
    (mm_hidden 48 x the number of scales), as under dynamic-S2."""
    tok = helpers.make_tiny_tokenizer()
    add_media_tokens(tok)
    llm = jqwen2.LLMConfig(vocab_size=len(tok), hidden_size=64, intermediate_size=128,
                           num_hidden_layers=2, num_attention_heads=4,
                           num_key_value_heads=2, dtype="float32")
    vis = jsiglip.SigLIPConfig(hidden_size=48, intermediate_size=96, num_hidden_layers=2,
                               num_attention_heads=4, image_size=56, patch_size=14)
    proj = jproj.ProjectorConfig(projector_type=projector_type,
                                 mm_hidden_size=48 * len(scales or (56,)), hidden_size=64)
    if scales:
        vlm_fields.setdefault("image_aspect_ratio", "dynamic_s2")
        vlm_fields["s2_scales"] = tuple(scales)
    cfg = jvlm.VLMConfig(llm=llm, vision=vis, projector=proj, **vlm_fields)
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.1 * x

    p = jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))
    tcfg = tvlm.VLMConfig(llm=_same(tqwen2.LLMConfig, llm),
                          vision=_same(tsiglip.SigLIPConfig, vis),
                          projector=_same(tproj.ProjectorConfig, proj),
                          **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(tvlm.VLMConfig)
                             if f.name not in ("llm", "vision", "projector")})
    return tok, cfg, p, tcfg


def media_engines(**kw):
    """The JAX and the port engine over one `media_vlm` (port on the CPU)."""
    tok, cfg, p, tcfg = media_vlm(**kw)
    jengine = jgen.GenerationEngine(jax.tree.map(jax.numpy.asarray, p), cfg, tok)
    tengine = tgen.GenerationEngine(weights.from_jax_params(p, device="cpu"), tcfg, tok,
                                    device="cpu")
    return jengine, tengine


# --------------------------------------------------------------------------
# tiling


def test_aspect_ratio_search_matches_jax():
    for lo, hi in ((1, 12), (4, 12), (9, 12), (1, 1), (4, 6)):
        assert tpre._candidate_ratios(lo, hi) == jpre._candidate_ratios(lo, hi)
        ratios = jpre._candidate_ratios(lo, hi)
        for w, h in ((448, 336), (1344, 1008), (100, 900), (640, 640), (1000, 250), (57, 56)):
            assert (tpre.find_closest_aspect_ratio(w / h, ratios, w, h, 448)
                    == jpre.find_closest_aspect_ratio(w / h, ratios, w, h, 448)), (lo, hi, w, h)


TILINGS = [
    ("dynamic", (336, 448, 3), dict(min_tiles=1, max_tiles=12)),
    ("dynamic", (90, 300, 3), dict(min_tiles=1, max_tiles=6)),
    ("dynamic", (56, 56, 3), dict(min_tiles=1, max_tiles=12)),
    ("dynamic_s2", (336, 448, 3), dict(max_tiles=12, s2_scales=(56, 112))),
    ("dynamic_s2", (1008, 1344, 3), dict(max_tiles=12, s2_scales=(56, 112, 168))),
    ("dynamic_s2", (300, 120, 3), dict(max_tiles=12, s2_scales=(56, 112, 168))),
    ("dynamic_s2", (280, 400, 3), dict(max_tiles=1, s2_scales=(56, 112))),
    ("longest_edge", (90, 300, 3), {}),
    ("longest_edge", (300, 90, 3), {}),
    ("pad", (90, 300, 3), {}),
    ("resize", (90, 300, 3), {}),
]


@pytest.mark.parametrize("mode,shape,kw", TILINGS)
@pytest.mark.parametrize("as_pil", [False, True])
def test_process_image_tiles_bit_equal(mode, shape, kw, as_pil):
    img = _image(shape, sum(shape) + len(mode))
    src = PIL.fromarray(img) if as_pil else img
    got, got_bs = tpre.process_image(src, image_size=56, image_aspect_ratio=mode, **kw)
    want, want_bs = jpre.process_image(img, image_size=56, image_aspect_ratio=mode, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got_bs == want_bs


def test_dynamic_s2_tile_counts_at_nvila_8b():
    """A 4:3 1344 x 1008 image at scales (448, 896, 1344), max 12 tiles:
    1 + 4 + 12 tiles of 448² and a 3 x 4 block grid (rows, cols)."""
    img = PIL.fromarray(_image((1008, 1344, 3), 7))
    tiles, bs = tpre.dynamic_s2_tile(img, s2_scales=(448, 896, 1344), max_num=12,
                                     image_size=448)
    assert len(tiles) == 17 and bs == (3, 4)
    assert all(t.size == (448, 448) for t in tiles)


# --------------------------------------------------------------------------
# native resize


@pytest.mark.parametrize("shape,size", [((3, 64, 80, 3), 48), ((2, 200, 300, 3), 56),
                                        ((1, 30, 20, 3), 56), ((4, 720, 1280, 3), 448)])
def test_native_resize_bit_equal_to_jax(shape, size):
    frames = _image(shape, shape[1])
    assert jimg._load_lib() is not None
    got = timg.resize_frames(frames, size)
    assert got.shape == (shape[0], size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, jimg.resize_frames(frames, size))
    same = _image((2, size, size, 3), 1)
    assert timg.resize_frames(same, size) is same
    for bad in (frames.astype(np.float32), frames[0], frames[..., :2]):
        with pytest.raises(ValueError):
            timg.resize_frames(bad, size)


def test_resize_pil_batch_takes_arrays_and_pil_images():
    frames = [_image((60, 60, 3), 2), _image((40, 90, 3), 3), _image((60, 60, 3), 4)]
    want = jimg.resize_pil_batch([PIL.fromarray(f) for f in frames], 32)
    np.testing.assert_array_equal(timg.resize_pil_batch(frames, 32), want)
    mixed = [PIL.fromarray(frames[0]), frames[1], PIL.fromarray(frames[2])]
    np.testing.assert_array_equal(timg.resize_pil_batch(mixed, 32), want)


def test_no_pil_fallback_when_the_library_cannot_be_built(monkeypatch, tmp_path):
    bad = tmp_path / "imageproc.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(timg, "SOURCE", bad)
    monkeypatch.setattr(timg, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(timg, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        timg.resize_frames(_image((1, 20, 30, 3), 5), 16)


# --------------------------------------------------------------------------
# video frames


def _as_arrays(frames):
    return [np.asarray(f.convert("RGB")) if hasattr(f, "convert") else f for f in frames]


def test_load_video_frames_from_a_frame_list():
    frames = [_image((40, 52, 3), 10 + i) for i in range(11)]
    for n in (4, 8, 11, 16):
        got = tloader.load_video_frames(Video(frames), num_frames=n)
        want = jloader.load_video_frames(JVideo(frames), num_frames=n)
        assert len(got) == len(want) == n
        for g, w in zip(_as_arrays(got), _as_arrays(want)):
            np.testing.assert_array_equal(g, w)


def test_load_video_frames_from_a_directory(tmp_path):
    for i in range(9):
        PIL.fromarray(_image((30, 40, 3), 20 + i)).save(tmp_path / f"f{i:03d}.png")
    got = tloader.load_video_frames(Video(str(tmp_path)), num_frames=5)
    want = jloader.load_video_frames(JVideo(str(tmp_path)), num_frames=5)
    assert len(got) == 5
    for g, w in zip(_as_arrays(got), _as_arrays(want)):
        np.testing.assert_array_equal(g, w)


def test_unreadable_video_gives_the_reference_black_frames(tmp_path):
    path = str(tmp_path / "broken.mp4")
    with open(path, "wb") as f:
        f.write(b"not a video")
    got = tloader.load_video_frames(Video(path), num_frames=3)
    want = jloader.load_video_frames(JVideo(path), num_frames=3)
    assert len(got) == 3
    for g, w in zip(_as_arrays(got), _as_arrays(want)):
        np.testing.assert_array_equal(g, w)
    assert not np.any(got[0])


def test_load_video_frames_from_a_file(tmp_path):
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    for i in range(12):
        writer.write(_image((48, 64, 3), 40 + i))
    writer.release()
    for fps in (0.0, 4.0):
        got = tloader.load_video_frames(Video(path), num_frames=6, fps=fps)
        want = jloader.load_video_frames(JVideo(path), num_frames=6, fps=fps)
        assert len(got) == len(want) > 0
        for g, w in zip(_as_arrays(got), _as_arrays(want)):
            np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# prompt assembly

IMG, IMG2 = _image((336, 448, 3), 0), _image((280, 400, 3), 1)
FRAMES = [_image((200, 300, 3), 10 + i) for i in range(8)]

PROMPTS = {
    "dynamic": (dict(image_aspect_ratio="dynamic", max_tiles=6),
                [[IMG, "Describe."], [IMG, "and", IMG2, "compare"]]),
    "dynamic_s2": (dict(scales=(56, 112), projector_type="mlp_downsample_3x3_fix",
                        s2_resize_output_to_scale_idx=-1),
                   [[IMG, "Describe."], [IMG, "and", IMG2, "compare"], ["text only"]]),
    "dynamic_s2_idx0": (dict(scales=(56, 112, 168)),
                        [[IMG2, "Describe."], [IMG2, IMG, "two"]]),
    "video_basic": (dict(num_video_frames=3), [[Video(FRAMES), "What happens?"]]),
    "video_tsp": (dict(video_encoder="tsp", num_video_frames=8,
                       tsp_pool_sizes=((2, 1, 1), (4, 2, 2))),
                  [[Video(FRAMES), "What happens?"], [IMG, Video(FRAMES), "both"]]),
}


def _jax_prompt(prompt):
    return [JVideo(p.frames) if isinstance(p, Video) else p for p in prompt]


@pytest.mark.parametrize("name", sorted(PROMPTS))
def test_prepare_inputs_bit_equal(name):
    kw, prompts = PROMPTS[name]
    jengine, tengine = media_engines(**kw)
    for prompt in prompts:
        got = tengine.prepare_inputs(list(prompt))
        want = jengine.prepare_inputs(_jax_prompt(prompt))
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["media_pos"], want["media_pos"])
        assert len(got["media"]) == len(want["media"])
        for g, w in zip(got["media"], want["media"]):
            assert g["kind"] == w["kind"]
            np.testing.assert_array_equal(g["tiles"], w["tiles"])
            assert tuple(g.get("block_size") or ()) == tuple(w.get("block_size") or ())
            assert g.get("pool_sizes") == w.get("pool_sizes")
