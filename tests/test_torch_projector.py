"""Every projector type of the port (`vila_tpu_torch.models.projector`)
against `vila_tpu/models/projector.py` on the CPU, in f32 (as
`tests/test_projector_parity.py` holds the JAX side against the reference's
nn.Sequential): the spec, the downsample rate and token count, the forward
on numpy-drawn parameters, the odd-grid padding of `flat_square`, and the
HF converter (`utils.hf_import.convert_projector_state_dict`) on each
type's `layers.{i}` state dict, whose indices must be the spec's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_media import media_vlm
from vila_tpu.models import projector as jproj
from vila_tpu.utils import hf_import as jhf
from vila_tpu_torch import entry as tentry
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import siglip as tsiglip
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.utils import hf_import as thf

TYPES = ["identity", "linear", "mlp_downsample", "mlp_downsample_2x2_fix",
         "mlp_downsample_3x3_fix", "mlp_downsample_3x3_s2", "mlp_downsample_3x3_s2_new",
         "mlp2x_gelu", "mlp3x_gelu"]


def _draw(cfg, seed):
    """A JAX projector tree with numpy-drawn leaves."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jproj.init_params(jax.random.PRNGKey(0), cfg))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        return 1.0 + 0.1 * x if "scale" in jax.tree_util.keystr(path) else 0.05 * x

    return jax.tree.map(np.asarray, jax.tree_util.tree_map_with_path(draw, shapes))


def _cfgs(ptype, m=48, h=64):
    kw = dict(projector_type=ptype, mm_hidden_size=m, hidden_size=h)
    return jproj.ProjectorConfig(**kw), tproj.ProjectorConfig(**kw)


@pytest.mark.parametrize("ptype", TYPES)
def test_spec_and_rate_match_jax(ptype):
    jcfg, tcfg = _cfgs(ptype)
    assert tproj.build_spec(tcfg) == jproj.build_spec(jcfg)
    assert tcfg.downsample_rate == jcfg.downsample_rate
    assert tcfg.downsample_rate == (3 if "3x3" in ptype else 2 if "downsample" in ptype else 1)


@pytest.mark.parametrize("ptype", TYPES)
@pytest.mark.parametrize("side", [4, 6, 5])
def test_forward_matches_jax(ptype, side):
    jcfg, tcfg = _cfgs(ptype, h=48 if ptype == "identity" else 64)
    p = _draw(jcfg, len(ptype) + side)
    x = np.random.default_rng(side).standard_normal((2, side * side, 48)).astype(np.float32)
    want = np.asarray(jproj.forward(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x)))
    got = tproj.forward(jax.tree.map(torch.as_tensor, p), tcfg, torch.as_tensor(x)).numpy()
    r = tcfg.downsample_rate
    assert got.shape == want.shape == (2, (-(-side // r)) ** 2, tcfg.hidden_size)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("r", [2, 3])
@pytest.mark.parametrize("side", [4, 5, 7, 32])
def test_flat_square_pads_odd_grids_like_jax(r, side):
    x = np.random.default_rng(side).standard_normal((1, side, side, 8)).astype(np.float32)
    got = tproj.flat_square(torch.as_tensor(x), r).numpy()
    np.testing.assert_array_equal(got, np.asarray(jproj.flat_square(jnp.asarray(x), r)))
    assert got.shape == (1, -(-side // r), -(-side // r), 8 * r * r)


def test_3x3_at_448_gives_121_tokens():
    """SigLIP at 448² has 32 x 32 patches; the 3x3 family pads them to 33
    and keeps 11 x 11 tokens a tile."""
    _, _, _, tcfg = media_vlm(projector_type="mlp_downsample_3x3_fix")
    cfg = tvlm.VLMConfig(llm=tcfg.llm, vision=tsiglip.SigLIPConfig(), projector=tcfg.projector)
    assert cfg.tokens_per_image == 121


@pytest.mark.parametrize("ptype", TYPES)
def test_hf_converter_keeps_the_spec_indices(ptype):
    """The reference's `layers.{i}` state dict of each type (written by the
    port's `entry.projector_state_dict`) converts to the spec's slots, equal
    to what the JAX converter makes of the same dict."""
    jcfg, tcfg = _cfgs(ptype, h=48 if ptype == "identity" else 64)
    tree = jax.tree.map(torch.as_tensor, _draw(jcfg, 9))
    sd = tentry.projector_state_dict({"mm_projector": tree})
    got = thf.convert_projector_state_dict(sd)
    want = jhf.convert_projector_state_dict({k: v.numpy() for k, v in sd.items()})
    spec = {str(i): op for i, (op, _, _) in enumerate(tproj.build_spec(tcfg))
            if op in ("linear", "ln")}
    assert sorted(got) == sorted(want) == sorted(spec) == sorted(tree)
    for i, op in spec.items():
        assert sorted(got[i]) == sorted(want[i]) == (
            ["bias", "kernel"] if op == "linear" else ["bias", "scale"])
        for k in got[i]:
            np.testing.assert_array_equal(got[i][k].numpy(), np.asarray(want[i][k]))
            np.testing.assert_array_equal(got[i][k].numpy(), tree[i][k].numpy())
