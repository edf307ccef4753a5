"""PS3 / VILA-HD training in the port (`collate._collate_ps3_extras`,
`vlm.forward_batch_ps3`, `step.loss_fn`'s token-selection loss) against
the JAX package on the CPU in f32, numpy-drawn parameters and images: the
collated PS3 keys bit for bit; the LM and selection losses of `loss_fn`
(chunked and full logits) within 1e-5; one stage-1.5 `train_step` (tower
and projector tuned, the LLM frozen) against JAX's. Two faults of the
reference are mirrored: only `Collator` carries the PS3 keys
(`PackingCollator` drops them), and it carries one high-res scale, so a
tower with two high scales cannot train from a collated batch; a batch
with one array per high scale (a list) trains in both packages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vila_tpu.data import collate as jcollate
from vila_tpu.models import projector as jproj
from vila_tpu.models import qwen2 as jqwen2
from vila_tpu.models import vlm as jvlm
from vila_tpu.train import optimizer as jopt
from vila_tpu.train import step as jstep
from vila_tpu_torch.data import collate as tcollate
from vila_tpu_torch.models import projector as tproj
from vila_tpu_torch.models import qwen2 as tqwen2
from vila_tpu_torch.models import vlm as tvlm
from vila_tpu_torch.train import optimizer as topt
from vila_tpu_torch.train import step as tstep
from vila_tpu_torch.utils import weights

from test_torch_ps3 import _cfgs
from test_torch_train import _same

CPU = torch.device("cpu")
K = 5


def _vlm(scales=(28, 56)):
    jvis, tvis = _cfgs(nlc=1, k=K, scales=scales, prompt_dim=0)
    llm = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, dtype="float32")
    proj = dict(projector_type="mlp2x_gelu", mm_hidden_size=32, hidden_size=64)
    return (jvlm.VLMConfig(llm=jqwen2.LLMConfig(**llm), vision=jvis,
                           projector=jproj.ProjectorConfig(**proj), vision_tower_type="ps3"),
            tvlm.VLMConfig(llm=tqwen2.LLMConfig(**llm), vision=tvis,
                           projector=tproj.ProjectorConfig(**proj), vision_tower_type="ps3"))


def _params(jcfg, seed):
    shapes = jax.eval_shape(lambda: jvlm.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        key = jax.tree_util.keystr(path)
        if "scale'" in key and "scale_embedding" not in key:
            return 1.0 + 0.1 * x
        return (0.3 if "select_head" in key else 0.05) * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _examples(jcfg, seed, n=2, gt=(True, False), hi_list=False):
    """n samples of one image each (tokens at positions 1..), high-res
    views of every high scale (one array, or a list a scale with
    `hi_list`), gt maps (8 x 8 on a 56-pixel scale) where `gt` says."""
    rng = np.random.default_rng(seed)
    tpi = jcfg.tokens_per_image
    out = []
    for i in range(n):
        k = 14 + tpi + 2 * i
        ids = rng.integers(3, 120, k).astype(np.int32)
        ids[1:1 + tpi] = 127
        labels = np.where(np.arange(k) > tpi, ids, -100).astype(np.int32)
        scales = jcfg.vision.s3_scales
        his = [rng.integers(0, 256, (1, s, s, 3), dtype=np.uint8) for s in scales[1:]]
        e = {"input_ids": ids, "labels": labels,
             "tiles": rng.integers(0, 256, (1, scales[0], scales[0], 3), dtype=np.uint8),
             "media_positions": np.arange(1, 1 + tpi, dtype=np.int32),
             "tiles_high": his if hi_list else his[0]}
        if gt[i % len(gt)]:
            m = np.zeros((1, 8, 8), np.float32)
            m[0, 2:5, 1:4] = 1.0
            e["gt_selection_map"] = m
        out.append(e)
    return out


def test_collated_ps3_keys_are_the_references_bit_for_bit():
    """Two samples (the second without a gt map), then one without high-res
    views; the helper alone as well."""
    jcfg, _ = _vlm()
    ex = _examples(jcfg, 0)
    for batch_ex in (ex, ex[:1] + [dict(ex[1], tiles_high=None)]):
        want = jcollate.Collator(seq_len=40, tile_size=28)(batch_ex)
        got = tcollate.Collator(seq_len=40, tile_size=28)(batch_ex)
        assert sorted(got) == sorted(want)
        assert {"pixel_values_high", "gt_selection_maps"} <= set(got)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    jout, tout = {}, {}
    jcollate._collate_ps3_extras(jout, ex, 3)
    tcollate._collate_ps3_extras(tout, ex, 3)
    assert sorted(jout) == sorted(tout)
    for k in jout:
        np.testing.assert_array_equal(tout[k], jout[k])


def test_reference_faults_of_ps3_batches_are_mirrored():
    """(1) `PackingCollator` keeps no PS3 key, so its batch has no high-res
    views and `forward_batch_ps3` fails in both packages. (2) A sample with
    a view a high scale (a list) cannot be collated (the collator reads
    one array's shape), and a collated batch's one array feeds only one of
    two high scales: the tower refuses it in both."""
    jcfg, tcfg = _vlm()
    p = _params(jcfg, 1)
    packed = jcollate.PackingCollator(seq_len=40, rows=1, tile_size=28)(_examples(jcfg, 2))
    tpacked = tcollate.PackingCollator(seq_len=40, rows=1, tile_size=28)(_examples(jcfg, 2))
    assert "pixel_values_high" not in packed and "gt_selection_maps" not in tpacked
    jp, tp = jax.tree.map(jnp.asarray, p), weights.from_jax_params(p, device="cpu")
    with pytest.raises(AssertionError):
        jvlm.forward_batch_ps3(jp, jcfg, jax.tree.map(jnp.asarray, packed))
    with pytest.raises(AssertionError):
        tvlm.forward_batch_ps3(tp, tcfg, tstep.batch_to_device(tpacked, CPU))

    jcfg3, tcfg3 = _vlm(scales=(28, 56, 112))
    listed = _examples(jcfg3, 3, hi_list=True)
    for coll in (jcollate.Collator, tcollate.Collator):
        with pytest.raises(AttributeError):
            coll(seq_len=40, tile_size=28)(listed)
    one = [dict(e, tiles_high=e["tiles_high"][0]) for e in listed]
    batch = jcollate.Collator(seq_len=40, tile_size=28)(one)
    p3 = _params(jcfg3, 4)
    with pytest.raises(AssertionError):
        jvlm.forward_batch_ps3(jax.tree.map(jnp.asarray, p3), jcfg3,
                               jax.tree.map(jnp.asarray, batch))
    with pytest.raises(AssertionError):
        tvlm.forward_batch_ps3(weights.from_jax_params(p3, device="cpu"), tcfg3,
                               tstep.batch_to_device(batch, CPU))


def _listed_batch(jcfg, seed):
    """A collated batch whose `pixel_values_high` is a list, one (B, T, s,
    s, 3) array a high scale (what `forward_batch_ps3` takes)."""
    ex = _examples(jcfg, seed, hi_list=True)
    batch = jcollate.Collator(seq_len=40, tile_size=28)(
        [dict(e, tiles_high=e["tiles_high"][0]) for e in ex])
    batch["pixel_values_high"] = [np.stack([e["tiles_high"][i] for e in ex])
                                  for i in range(len(jcfg.vision.s3_scales) - 1)]
    return batch


@pytest.mark.parametrize("scales,chunk", [((28, 56), None), ((28, 56), 16),
                                          ((28, 56, 112), None)])
def test_ps3_loss_fn_matches_jax(scales, chunk):
    """LM loss plus the BCE + DICE selection loss (weight 0.5), chunked and
    full-logits, one and two high scales; the selection loss reported."""
    jcfg, tcfg = _vlm(scales)
    p = _params(jcfg, 5)
    batch = _listed_batch(jcfg, 6)
    want_loss, want = jstep.loss_fn(jax.tree.map(jnp.asarray, p), jcfg,
                                    jax.tree.map(jnp.asarray, batch), chunk,
                                    token_selection_loss_weight=0.5)
    tb = tstep.batch_to_device(batch, CPU)
    got_loss, got = tstep.loss_fn(weights.from_jax_params(p, device="cpu"), tcfg, tb, chunk,
                                  token_selection_loss_weight=0.5)
    assert sorted(got) == sorted(want)
    for k in ("loss", "token_selection_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5)
    assert int(got["n_tokens"]) == int(want["n_tokens"])
    np.testing.assert_allclose(float(got_loss), float(want_loss), rtol=1e-5)
    assert float(got["token_selection_loss"]) > 0


def test_ps3_stage15_train_step_matches_jax():
    """Stage 1.5: tower and projector tuned, the LLM frozen; loss, selection
    loss, grad norm and the updated tree against JAX's (eps 1e-6, as in
    `test_torch_train.py`)."""
    jcfg, tcfg = _vlm()
    p = _params(jcfg, 7)
    batch = jcollate.Collator(seq_len=40, tile_size=28)(_examples(jcfg, 8))
    ocfg = jopt.OptimizerConfig(learning_rate=1e-3, schedule="constant", warmup_ratio=0.0,
                                eps=1e-6, tune_language_model=False)
    opt = jopt.make_optimizer(ocfg)
    jp = jax.tree.map(jnp.asarray, p)
    step = jax.jit(functools.partial(jstep.train_step, cfg=jcfg, optimizer=opt))
    jp2, _, jm = step(jp, opt.init(jp), jax.tree.map(jnp.asarray, batch))
    topt_ = topt.make_optimizer(_same(topt.OptimizerConfig, ocfg))
    _, tp, tst = tstep.make_train_step(tcfg, weights.from_jax_params(p, device="cpu"), topt_)
    tp, _, tm = tstep.train_step(tp, tst, tstep.batch_to_device(batch, CPU), cfg=tcfg,
                                 optimizer=topt_)
    for k in ("loss", "token_selection_loss"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jp2)[0],
                                 topt.leaves(tp)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5, err_msg=jax.tree_util.keystr(path))
    llm = weights.from_jax_params(p["llm"], device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(topt.leaves(llm), topt.leaves(tp["llm"])))
