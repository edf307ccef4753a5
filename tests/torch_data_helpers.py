"""Shared pieces of the dataset-type parity tests
(`test_torch_{dataset_impl,interleaved,data_registry}.py`): one tiny
tokenizer and config for both packages, seeded images, and an exact
comparison of processed samples."""

import os

import numpy as np

import helpers
from test_torch_media import media_vlm
from vila_tpu_torch.data.tokenizer_json import JsonTokenizer
from vila_tpu_torch.data.tokenizer_utils import add_media_tokens


def data_env(tmp_dir):
    """(tokenizer, JAX VLMConfig, port VLMConfig, the port's JsonTokenizer of
    the same tokenizer.json): `test_torch_media.media_vlm`'s tiny VLM (SigLIP
    at 56²), the tokenizer `helpers.make_tiny_tokenizer` with the media
    tokens, shared by both packages."""
    tok, cfg, _, tcfg = media_vlm()
    helpers.make_tiny_tokenizer().save_pretrained(tmp_dir)
    jtok = JsonTokenizer.from_pretrained(tmp_dir)
    add_media_tokens(jtok)
    return tok, cfg, tcfg, jtok


def image(seed, shape=(40, 50, 3)):
    from PIL import Image as PILImage

    return PILImage.fromarray(np.random.default_rng(seed).integers(0, 255, shape, np.uint8))


def image_file(seed, path, shape=(40, 40, 3)):
    image(seed, shape).save(path)
    return str(path)


def jpeg_bytes(seed, shape=(32, 32, 3)):
    import io

    buf = io.BytesIO()
    image(seed, shape).save(buf, format="JPEG")
    return buf.getvalue()


def assert_same_sample(got, want):
    """Every array of a processed sample equal bit for bit, dtype included."""
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k


def frame_dir(root, seed, n=4, shape=(48, 64, 3)):
    """A directory of `n` seeded PNG frames (a video as the loaders take it)."""
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        image_file(seed * 100 + i, os.path.join(root, f"{i:04d}.png"), shape)
    return str(root)
