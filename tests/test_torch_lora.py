"""The port's LoRA / DoRA (`vila_tpu_torch.train.lora`) against
`vila_tpu/train/lora.py` on the CPU in f32 over the tiny VLM of
`test_torch_train.py`: the factors' shapes and DoRA's initial magnitudes,
the adapted model equal to the base model at init (bit for bit for LoRA),
the merged kernels within 1e-6, and one LoRA / DoRA step (`lora_loss_fn`,
`optax.adamw` against the port's `adamw`) with loss and updated factors
within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vila_tpu.train import lora as jlora
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.train import lora as tlora
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train.step import apply_gradients, batch_to_device
from vila_tpu_torch.utils import weights

from test_torch_fp8 import _tcfg
from test_torch_train import _draw, _packed_batch, _tiny_cfg

CPU = torch.device("cpu")


def _lora_draw(params, lcfg, seed):
    """Nonzero factors (and magnitudes near the column norms) from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in lcfg.targets:
        L, din, dout = params["llm"]["layers"][name]["kernel"].shape
        e = {"a": (rng.standard_normal((L, din, lcfg.rank)) / 4).astype(np.float32),
             "b": (0.05 * rng.standard_normal((L, lcfg.rank, dout))).astype(np.float32)}
        if lcfg.use_dora:
            norm = np.linalg.norm(params["llm"]["layers"][name]["kernel"], axis=1)
            e["magnitude"] = (norm * (1.0 + 0.1 * rng.standard_normal(norm.shape))
                              ).astype(np.float32)
        out[name] = e
    return out


@pytest.mark.parametrize("dora", [False, True])
def test_init_lora_starts_at_the_base_model(dora):
    cfg = _tiny_cfg()
    params = _draw(cfg, 0)
    jl = jlora.LoRAConfig(rank=4, use_dora=dora)
    tl = tlora.LoRAConfig(rank=4, use_dora=dora)
    want = jlora.init_lora(jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, params["llm"]), jl)
    tp = weights.from_jax_params(params, device="cpu")
    got = tlora.init_lora(torch.Generator().manual_seed(0), tp["llm"], tl)
    assert sorted(got) == sorted(want) == sorted(tlora.DEFAULT_TARGETS)
    for name, entry in got.items():
        assert {k: tuple(v.shape) for k, v in entry.items()} == {
            k: tuple(v.shape) for k, v in want[name].items()}
        assert not entry["b"].any()
        if dora:
            np.testing.assert_allclose(entry["magnitude"].numpy(),
                                       np.asarray(want[name]["magnitude"]), rtol=1e-6)
    tcfg = _tcfg(cfg)
    batch = batch_to_device(_packed_batch(cfg, 1), CPU)
    base = tvlm.forward_batch(tp, tcfg, batch)
    adapted = tvlm.forward_batch(tlora.apply_lora(tp, got, tl), tcfg, batch)
    if dora:  # w / |w| * |w|: within an ulp of w
        np.testing.assert_allclose(adapted.numpy(), base.numpy(), rtol=0,
                                   atol=1e-5 * float(base.abs().max()))
    else:
        assert torch.equal(adapted, base)


@pytest.mark.parametrize("dora", [False, True])
def test_merge_lora_matches_jax(dora):
    cfg = _tiny_cfg()
    params = _draw(cfg, 2)
    jl = jlora.LoRAConfig(rank=4, use_dora=dora)
    tl = tlora.LoRAConfig(rank=4, use_dora=dora)
    lora = _lora_draw(params, jl, 3)
    want = jlora.merge_lora(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, lora), jl)
    tp = weights.from_jax_params(params, device="cpu")
    got = tlora.merge_lora(tp, weights.to_torch_tree(lora, CPU), tl)
    for name in jl.targets:
        w = np.asarray(want["llm"]["layers"][name]["kernel"])
        g = got["llm"]["layers"][name]["kernel"].numpy()
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
    # the input tree is left as it was
    assert torch.equal(tp["llm"]["layers"]["q_proj"]["kernel"],
                       torch.tensor(params["llm"]["layers"]["q_proj"]["kernel"]))


@pytest.mark.parametrize("dora", [False, True])
def test_lora_step_matches_jax(dora):
    """One step of the factors alone (the base tree gets no gradient) on a
    packed image batch: loss and the updated factors within 1e-5."""
    cfg = _tiny_cfg()
    params = _draw(cfg, 4)
    batch = _packed_batch(cfg, 5)
    jl = jlora.LoRAConfig(rank=4, use_dora=dora)
    tl = tlora.LoRAConfig(rank=4, use_dora=dora)
    lora = _lora_draw(params, jl, 6)

    fn = jlora.lora_loss_fn(jax.tree.map(jnp.asarray, params), cfg, jl)
    opt = optax.adamw(1e-3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(lr):
        (loss, _), g = jax.value_and_grad(lambda x: fn(x, jb), has_aux=True)(lr)
        upd, _ = opt.update(g, opt.init(lr), lr)
        return loss, optax.apply_updates(lr, upd)

    jloss, jl2 = jstep(jax.tree.map(jnp.asarray, lora))
    tp = weights.from_jax_params(params, device="cpu")
    tfn = tlora.lora_loss_fn(tp, _tcfg(cfg), tl)
    tl_ = weights.to_torch_tree(lora, CPU)
    topt_ = topt.adamw(1e-3)
    tb = batch_to_device(batch, CPU)
    loss, metrics, _, _ = apply_gradients(tl_, lambda: tfn(tl_, tb), topt_, topt_.init(tl_))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(metrics["loss"]) == float(loss)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jl2)[0],
                                 topt.leaves(tl_)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=jax.tree_util.keystr(path))
    assert all(t.grad is None and not t.requires_grad for t in topt.leaves(tp))
