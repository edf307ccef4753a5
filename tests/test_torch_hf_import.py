"""The port's checkpoint reader, writer and converters
(`vila_tpu_torch.utils.hf_import`) on the CPU: the numpy safetensors reader
against `safetensors.safe_open` on files that `safetensors.torch.save_file`
wrote (F32, BF16, F16, I64, two shards, a `__metadata__`), the writer read
back by `safe_open` bit for bit, the LLM, SigLIP and projector converters
against the JAX package's on the same state dicts bit for bit, and the
towers not ported yet raising."""

import os
import sys

import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from vila_tpu.models import qwen2 as jqwen2  # noqa: E402
from vila_tpu.models import siglip as jsiglip  # noqa: E402
from vila_tpu.utils import hf_import as jhf  # noqa: E402
from vila_tpu_torch.models import qwen2 as tqwen2  # noqa: E402
from vila_tpu_torch.models import siglip as tsiglip  # noqa: E402
from vila_tpu_torch.utils import hf_import as thf  # noqa: E402


def _draw(seed):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.f32": torch.randn((3, 5), generator=g),
        "b.bf16": torch.randn((4, 7), generator=g).to(torch.bfloat16),
        "c.f16": torch.randn((6,), generator=g).to(torch.float16),
        "d.i64": torch.randint(-(2 ** 40), 2 ** 40, (2, 3), generator=g),
        "e.i32": torch.randint(-1000, 1000, (5,), generator=g, dtype=torch.int32),
        "f.u8": torch.randint(0, 256, (9,), generator=g, dtype=torch.uint8),
        "g.bool": torch.rand((4,), generator=g) > 0.5,
        "h.empty": torch.zeros((0, 3)),
        "i.scalar": torch.tensor(2.5),
    }


def _same(got: torch.Tensor, want: torch.Tensor):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_reader_matches_safe_open_on_two_shards(tmp_path):
    shards = {"model-00001-of-00002.safetensors": _draw(0),
              "model-00002-of-00002.safetensors": {k + "2": v for k, v in _draw(1).items()}}
    want = {}
    for name, sd in shards.items():
        save_file(sd, str(tmp_path / name), metadata={"format": "pt", "shard": name})
        with safe_open(str(tmp_path / name), framework="pt") as f:
            want.update({k: f.get_tensor(k) for k in f.keys()})
    got = thf.load_safetensors_dir(str(tmp_path))
    assert sorted(got) == sorted(want) and len(got) == 18
    for k in want:
        _same(got[k], want[k])
    peek = thf.peek_safetensors(str(tmp_path), ["b.bf16", "d.i642", "missing"])
    assert sorted(peek) == ["b.bf16", "d.i642"]
    _same(peek["d.i642"], want["d.i642"])


def test_writer_read_back_by_safe_open(tmp_path):
    sd = _draw(2)
    sd["t.transposed"] = torch.arange(12.0).reshape(3, 4).T  # a non-contiguous view
    sd["n.numpy"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    path = str(tmp_path / "model.safetensors")
    n = thf.save_safetensors(sd, path)
    assert n == os.path.getsize(path)
    with safe_open(path, framework="pt") as f:
        assert sorted(f.keys()) == sorted(sd)
        for k in sd:
            want = torch.as_tensor(sd[k]).contiguous()
            _same(f.get_tensor(k), want)
    back = thf.read_safetensors(path)
    for k in sd:
        _same(back[k], torch.as_tensor(sd[k]).contiguous())


def test_reader_refuses_truncated_file(tmp_path):
    path = str(tmp_path / "model.safetensors")
    save_file({"x": torch.ones(64)}, path)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - 4)
    with pytest.raises(ValueError, match="file ends"):
        thf.read_safetensors(path)


def test_bin_fallback(tmp_path):
    sd = {"w": torch.randn(3, 2), "b": torch.randn(2).to(torch.bfloat16)}
    torch.save(sd, str(tmp_path / "pytorch_model.bin"))
    got = thf.load_safetensors_dir(str(tmp_path))
    for k in sd:
        _same(got[k], sd[k])
    with pytest.raises(FileNotFoundError):
        thf.load_safetensors_dir(str(tmp_path / "none"))


def _tree_equal(got, want, path=""):
    """A port tree (tensors) against a JAX converter's tree (numpy), bit
    for bit after widening both to f32."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}/{k}")
        return
    assert isinstance(got, torch.Tensor) and got.is_contiguous(), path
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32),
                                  err_msg=path)


@pytest.fixture(scope="module")
def hf_models():
    llm, vit, proj, llm_hf, vis_hf, _ = helpers.make_tiny_vlm_torch(
        seed=3, hidden_size=64, intermediate_size=96)
    return llm, vit, proj, llm_hf.to_dict(), vis_hf.to_dict()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_llm_converter_matches_jax(hf_models, dtype):
    llm, _, _, llm_hf, _ = hf_models
    sd = {k: v.to(dtype) for k, v in llm.state_dict().items()}
    jcfg = jqwen2.LLMConfig.from_hf_config(llm_hf)
    tcfg = tqwen2.LLMConfig.from_hf_config(llm_hf)
    got = thf.convert_llm_state_dict(sd, tcfg)
    assert got["layers"]["q_proj"]["kernel"].dtype == dtype  # stored dtype kept
    _tree_equal(got, jhf.convert_llm_state_dict(sd, jcfg))
    assert "lm_head" in got and "bias" in got["layers"]["k_proj"]


def test_siglip_converter_matches_jax(hf_models):
    _, vit, _, _, vis_hf = hf_models
    sd = vit.state_dict()
    got = thf.convert_siglip_state_dict(sd, tsiglip.SigLIPConfig.from_hf_config(vis_hf))
    _tree_equal(got, jhf.convert_siglip_state_dict(
        sd, jsiglip.SigLIPConfig.from_hf_config(vis_hf)))


def test_projector_converter_matches_jax(hf_models):
    _, _, proj, _, _ = hf_models
    sd = {f"layers.{k}": v for k, v in proj.state_dict().items()}
    got = thf.convert_projector_state_dict(sd)
    _tree_equal(got, jhf.convert_projector_state_dict(sd))
    assert {"kernel", "bias"} <= set(got["2"]) and "scale" in got["1"]


@pytest.mark.parametrize("fn,tower", [
    (lambda: thf.convert_vit_state_dict({}, None), "CLIP / InternViT"),
    (lambda: thf.convert_radio_state_dict({}, None), "RADIO"),
    (lambda: thf.radio_image_stats({}), "RADIO"),
    (lambda: thf.convert_ps3_state_dict({}, None), "PS3"),
])
def test_unported_towers_raise(fn, tower):
    with pytest.raises(NotImplementedError, match=tower):
        fn()
