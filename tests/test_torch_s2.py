"""The port's dynamic-S2 module (`vila_tpu_torch.models.s2`) against
`vila_tpu/models/s2.py` on the CPU, in f32: the chessboard merge and
split, the area resize (adaptive average pooling), the block and token
counts, and the whole multi-scale encode of one image on a tiny tower,
with numpy-drawn parameters handed to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_media import media_vlm
from vila_tpu.models import s2 as js2
from vila_tpu_torch.models import s2 as ts2
from vila_tpu_torch.utils import weights

torch.backends.cuda.matmul.allow_tf32 = False

# f32 on both sides, sums in another order: the tower's features and the
# projector's outputs agree to 1e-4 relative to their largest value
ENCODE_RTOL = 1e-4


@pytest.mark.parametrize("gh,gw,side", [(1, 1, 4), (2, 2, 4), (3, 4, 32), (2, 3, 5)])
def test_merge_split_round_trip_and_jax(gh, gw, side):
    x = np.random.default_rng(gh * 10 + gw).standard_normal(
        (gh * gw, side * side, 6)).astype(np.float32)
    merged = ts2.merge_grid(torch.as_tensor(x), gh, gw)
    assert merged.shape == (gh * side, gw * side, 6)
    np.testing.assert_array_equal(merged.numpy(), np.asarray(js2.merge_grid(jnp.asarray(x), gh, gw)))
    back = ts2.split_grid(merged, gh, gw)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(js2.split_grid(jnp.asarray(merged.numpy()), gh, gw)))


@pytest.mark.parametrize("hw,out", [((8, 8), (4, 4)), ((12, 16), (4, 4)), ((4, 4), (12, 16)),
                                    ((7, 5), (3, 2)), ((32, 32), (96, 128)), ((96, 128), (32, 32)),
                                    ((6, 6), (6, 6))])
def test_area_resize_matches_jax_and_adaptive_pooling(hw, out):
    x = np.random.default_rng(sum(hw)).standard_normal(hw + (5,)).astype(np.float32)
    got = ts2.area_resize(torch.as_tensor(x), *out).numpy()
    want = np.asarray(js2.area_resize(jnp.asarray(x), *out))
    assert got.shape == out + (5,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    if out[0] <= hw[0] and out[1] <= hw[1]:  # the same semantics as adaptive pooling
        pool = torch.nn.functional.adaptive_avg_pool2d(
            torch.as_tensor(x).permute(2, 0, 1), out).permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, pool, rtol=1e-6, atol=1e-6 * np.abs(pool).max())


@pytest.mark.parametrize("scales", [(56, 112), (56, 112, 168)])
@pytest.mark.parametrize("idx", [0, 1, -1])
def test_block_and_token_counts_match_jax(scales, idx):
    _, cfg, _, tcfg = media_vlm(scales=scales, s2_resize_output_to_scale_idx=idx)
    for bs in ((1, 1), (2, 2), (3, 4), (4, 3), (2, 6)):
        assert ts2.output_block_size(tcfg, bs) == js2.output_block_size(cfg, bs)
        assert ts2.tokens_for_block_size(tcfg, bs) == js2.tokens_for_block_size(cfg, bs)


ENCODES = [
    # (scales, projector, output scale index, last-scale block grid)
    ((56, 112), "mlp_downsample", 0, (2, 3)),
    ((56, 112), "mlp_downsample_3x3_fix", -1, (2, 3)),
    ((56, 112, 168), "mlp_downsample_3x3_fix", -1, (3, 4)),
    ((56, 112, 168), "mlp_downsample_2x2_fix", 1, (4, 3)),
    ((56, 112), "mlp_downsample", 0, (1, 1)),
]


@pytest.mark.parametrize("scales,ptype,idx,block", ENCODES)
def test_encode_image_s2_matches_jax(scales, ptype, idx, block):
    _, cfg, p, tcfg = media_vlm(projector_type=ptype, scales=scales,
                                s2_resize_output_to_scale_idx=idx)
    n_tiles = sum((s // scales[0]) ** 2 for s in scales[:-1]) + block[0] * block[1]
    tiles = np.random.default_rng(len(scales)).integers(0, 256, (n_tiles, 56, 56, 3), np.uint8)
    want = np.asarray(js2.encode_image_s2(jax.tree.map(jnp.asarray, p), cfg,
                                          jnp.asarray(tiles), block))
    got = ts2.encode_image_s2(weights.from_jax_params(p, device="cpu"), tcfg,
                              torch.as_tensor(tiles), block).numpy()
    assert got.shape == want.shape == (ts2.tokens_for_block_size(tcfg, block), 64)
    np.testing.assert_allclose(got, want, rtol=0, atol=ENCODE_RTOL * np.abs(want).max())
