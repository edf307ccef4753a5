"""The port's weight tools (`vila_tpu_torch.utils.weights_tools`) and its
top-level `save` against the JAX package's, on the CPU:

* `make_delta` / `apply_delta` give JAX's f32 leaves bit for bit;
* a port `Trainer` run consolidated with `consolidate_checkpoint` loads
  through `vila_tpu_torch.load(device="cpu")` and through JAX's
  `entry.load_params`, with logits equal to the trained tree's within 1e-5;
* `merge_lora_and_save` (LoRA and DoRA) saves weights within 1e-6 of JAX's
  on the same base checkpoint and LoRA state;
* `vila_tpu_torch.save` round-trips, and JAX loads what it wrote;
* the tools that load default to the card and raise without CUDA.
"""

import os
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
import vila_tpu_torch  # noqa: E402
from vila_tpu import entry as jentry  # noqa: E402
from vila_tpu.models import qwen2 as jqwen2  # noqa: E402
from vila_tpu.train import lora as jlora  # noqa: E402
from vila_tpu.utils import weights_tools as jtools  # noqa: E402
from vila_tpu_torch import entry  # noqa: E402
from vila_tpu_torch.data import collate  # noqa: E402
from vila_tpu_torch.models import qwen2  # noqa: E402
from vila_tpu_torch.train import lora  # noqa: E402
from vila_tpu_torch.train.trainer import TrainArgs, Trainer  # noqa: E402
from vila_tpu_torch.utils import weights, weights_tools  # noqa: E402
from vila_tpu_torch.utils.hf_import import load_safetensors_dir  # noqa: E402

IDS = np.random.default_rng(5).integers(0, 500, (1, 19))


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("base"))
    helpers.save_tiny_checkpoint(d, seed=0)
    return d


def _tree(rng, dtype):
    """A nested tree as both packages take it: numpy leaves (bf16 through
    ml_dtypes) and their torch twins."""
    shapes = {"llm": {"embed": (7, 5), "layers": {"q": (2, 5, 5), "b": (2, 5)}}, "proj": (3,)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32).astype(dtype)

    return draw(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(tree.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(tree)


def _assert_bits(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_bits(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, path
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32)), path


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_make_and_apply_delta_match_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    b, t = _tree(rng, dtype), _tree(rng, dtype)
    want = jtools.make_delta(b, t)
    got = weights_tools.make_delta(_to_torch(b), _to_torch(t))
    _assert_bits(got, want)
    _assert_bits(weights_tools.apply_delta(_to_torch(b), got), jtools.apply_delta(b, want))
    with pytest.raises(ValueError, match="structures differ"):
        weights_tools.make_delta(_to_torch(b), {"llm": _to_torch(t)["llm"]})


def _port_logits(params, cfg):
    with torch.no_grad():
        return qwen2.forward(params["llm"], cfg.llm, input_ids=torch.tensor(IDS))[0].numpy()


class _Rows:
    """Text-only rows over the tiny checkpoint's vocabulary."""

    def __init__(self, n=8, seq=16):
        rng = np.random.default_rng(1)
        self.items = [{"input_ids": ids, "labels": ids.copy(),
                       "tiles": np.zeros((0, 56, 56, 3), np.uint8),
                       "media_positions": np.zeros((0,), np.int32)}
                      for ids in rng.integers(2, 500, (n, seq)).astype(np.int32)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def test_consolidated_run_loads_in_both_packages(base, tmp_path):
    cfg = entry.build_config(base, dtype="float32", device="cpu")
    params = entry.load_params(base, cfg, device="cpu")
    run = str(tmp_path / "run")
    args = TrainArgs(output_dir=run, max_steps=2, per_device_batch_size=4, seq_len=16,
                     learning_rate=1e-3, warmup_ratio=0.0, lr_schedule="constant",
                     logging_steps=1, save_steps=2)
    trainer = Trainer(cfg, params, _Rows(), collate.Collator(seq_len=16), args, device="cpu")
    trainer.train()
    trained = _port_logits(trainer.params, cfg)
    assert not np.array_equal(trained, _port_logits(entry.load_params(base, cfg, device="cpu"),
                                                    cfg))
    out = str(tmp_path / "consolidated")
    assert weights_tools.consolidate_checkpoint(os.path.join(run, "checkpoints"), base, out,
                                                map_location="cpu") == out

    engine = vila_tpu_torch.load(out, device="cpu")
    np.testing.assert_allclose(_port_logits(engine.params, engine.cfg), trained, atol=1e-5,
                               rtol=0)
    jcfg = jentry.build_config(out, dtype="float32")
    jparams = jentry.load_params(out, jcfg)
    jl, _ = jqwen2.forward(jparams["llm"], jcfg.llm, input_ids=jnp.asarray(IDS))
    np.testing.assert_allclose(np.asarray(jl, np.float32), trained, atol=1e-5, rtol=0)


@pytest.mark.parametrize("use_dora", [False, True])
def test_merge_lora_and_save_matches_jax(base, tmp_path, use_dora):
    jcfg = jentry.build_config(base, dtype="float32")
    jparams = jentry.load_params(base, jcfg)
    kw = dict(rank=4, alpha=8.0, use_dora=use_dora)
    jstate = jlora.init_lora(jax.random.PRNGKey(2), jparams["llm"], jlora.LoRAConfig(**kw))
    rng = np.random.default_rng(3)  # B drawn nonzero so that the merge moves the kernels
    jstate = {n: dict(e, b=jnp.asarray(0.05 * rng.standard_normal(e["b"].shape), jnp.float32))
              for n, e in jstate.items()}
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jtools.merge_lora_and_save(base, jstate, jlora.LoRAConfig(**kw), jout)
    tstate = weights.from_jax_params(jax.tree.map(np.asarray, jstate), device="cpu")
    weights_tools.merge_lora_and_save(base, tstate, lora.LoRAConfig(**kw), tout, device="cpu")
    for comp in ("llm", "vision_tower", "mm_projector"):
        want = load_safetensors_dir(os.path.join(jout, comp))
        got = load_safetensors_dir(os.path.join(tout, comp))
        assert sorted(got) == sorted(want), comp
        for k in want:
            assert torch.allclose(got[k], want[k], atol=1e-6, rtol=0), (comp, k)
    moved = load_safetensors_dir(os.path.join(tout, "llm"))["model.layers.0.self_attn.q_proj.weight"]
    orig = load_safetensors_dir(os.path.join(base, "llm"))["model.layers.0.self_attn.q_proj.weight"]
    assert not torch.equal(moved, orig.float())


def test_top_level_save_round_trips_and_loads_in_jax(base, tmp_path):
    cfg = entry.build_config(base, dtype="float32", device="cpu")
    params = entry.load_params(base, cfg, device="cpu")
    out = str(tmp_path / "saved")
    assert vila_tpu_torch.save(params, cfg, entry.load_tokenizer(base), out) > 0
    again = entry.load_params(out, entry.build_config(out, dtype="float32", device="cpu"),
                              device="cpu")
    for (path, want), (_, got) in zip(sorted(_leaves(params)),
                                      sorted(_leaves(again))):
        assert torch.equal(got, want), path
    jcfg = jentry.build_config(out, dtype="float32")
    jl, _ = jqwen2.forward(jentry.load_params(out, jcfg)["llm"], jcfg.llm,
                           input_ids=jnp.asarray(IDS))
    np.testing.assert_allclose(np.asarray(jl, np.float32), _port_logits(params, cfg),
                               atol=1e-5, rtol=0)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_loading_tools_default_to_the_card(no_cuda, base, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights_tools.merge_lora_and_save(base, {}, lora.LoRAConfig(), str(tmp_path / "m"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights_tools.consolidate_checkpoint(str(tmp_path / "run"), base, str(tmp_path / "c"))
