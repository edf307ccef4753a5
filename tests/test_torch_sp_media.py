"""Media under MM-SP (`models/vlm.py` `_encode_share`, `parallel/sp.py`
`frame_share` / `gather_media`) and the tower's recomputation
(`siglip.forward(remat=True)`), on the CPU at tiny widths.

Four gloo processes (one spawn for the module, `torch_dist_helpers`) run
the VLM loss over their part of a packed batch of two videos, each rank
encoding an even share of the tiles and gathering the features over the
ring: in both ring layouts, the loss and every leaf's gradient (summed over
the ranks) equal the one-device forward's, which encodes every tile in one
process, and the loss equals the plain reference's
(`port_bench/reference/long_train.py`) on the same seeded weights. A batch
of two tiles leaves two ranks without a tile of their own. The new spans
(`model.vision` frames, `parallel.media_gather`, `parallel.ring`,
`parallel.zero_gather` / `zero_scatter`) carry their attributes under
`profiling.recording()`.

Tolerances (float32): losses rtol 1e-5, gradients rtol 1e-4 plus atol
1e-6 x the leaf's largest |gradient| (summation order over the ranks and
the ring's steps, as `test_torch_sp.py`); the reference's loss rtol 1e-5.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

import torch_dist_helpers as dh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2**33 + 23
S = 128


def config():
    with open(os.path.join(ROOT, "port_bench", "configs", "qwen2-7b-longvila.json")) as f:
        c = json.load(f)
    c["llm"].update(vocab_size=512, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                    num_attention_heads=4, num_key_value_heads=2)
    c["vision"].update(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                       num_attention_heads=2, image_size=56, patch_size=14)
    c["training"]["seq_len"] = S
    return c


def video(frames, text, seed):
    """A sample: `frames` tiles of 4 media tokens each, a newline, then
    `text` tokens (the first half masked)."""
    from port_bench import longvideo

    r = np.random.default_rng(seed)
    media = 4 * frames
    ids = np.concatenate([np.full(media, 259), [10], r.integers(300, 512, text)]).astype(np.int32)
    labels = ids.copy()
    labels[:media + 1 + text // 2] = longvideo.IGNORE
    return {"input_ids": ids, "labels": labels,
            "tiles": r.integers(0, 256, (frames, 56, 56, 3)).astype(np.uint8),
            "media_positions": np.arange(media, dtype=np.int32)}


ROWS = {"videos": [video(5, 24, 1), video(3, 30, 2)],  # 8 tiles: 2 a rank
        "two_tiles": [video(2, 40, 3)]}  # ranks 2 and 3 encode blank tiles only


def collate(samples):
    from vila_tpu_torch.data.collate import PackingCollator

    return PackingCollator(seq_len=S, rows=1, pad_token_id=256, tile_size=56)(samples)


CASES = [(rows, layout) for rows in ROWS for layout in ("zigzag", "contiguous")]


@pytest.fixture(scope="module")
def ranks():
    cases = [("media_sp", dict(mesh_axes=dict(sp=4), config=config(), seed=SEED,
                               batch=collate(ROWS[rows]), layout=layout))
             for rows, layout in CASES]
    cases.append(("media_sharded_step", dict(mesh_axes=dict(sp=4), config=config(), seed=SEED,
                                             batch=collate(ROWS["videos"]), layout="zigzag")))
    return dh.spawn(cases, 4, timeout=300)


def one_device(rows):
    """(loss, gradients) of the one-device forward (every tile encoded in
    one process, no sp)."""
    from vila_tpu_torch.train.optimizer import leaves
    from vila_tpu_torch.train.step import batch_to_device, loss_fn

    cfg, params = dh._media_model(config(), SEED)
    for t in leaves(params):
        t.requires_grad_(True)
    loss, _ = loss_fn(params, cfg, batch_to_device(collate(ROWS[rows]), torch.device("cpu")))
    loss.backward()
    return float(loss), dh._tree(params, lambda t: np.zeros(t.shape, np.float32) if t.grad is None
                                 else t.grad.numpy())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("rows,layout", CASES, ids=[f"{r}-{l}" for r, l in CASES])
def test_split_frames_match_one_device(rows, layout, ranks):
    i = CASES.index((rows, layout))
    want_loss, want_grads = one_device(rows)
    for r in range(4):
        loss, grads, _ = ranks[r][i]
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    got = dict(_leaves(ranks[0][i][1]))
    n_tower = 0
    for name, want in _leaves(want_grads):
        np.testing.assert_allclose(got[name], want, rtol=1e-4,
                                   atol=1e-6 * max(1.0, float(np.abs(want).max())), err_msg=name)
        n_tower += name.startswith("vision_tower") and bool(np.abs(want).max() > 0)
    assert n_tower > 0  # the tower's gradient reached it through the gather


@pytest.mark.parametrize("rows", list(ROWS))
def test_split_frames_loss_matches_plain_reference(rows, ranks):
    from port_bench.reference import long_train

    want = long_train.steps(torch, config(), SEED, ROWS[rows], [torch.device("cpu")])
    np.testing.assert_allclose(ranks[0][CASES.index((rows, "zigzag"))][0], want["losses"][0],
                               rtol=1e-5)


def test_each_rank_encodes_its_share(ranks):
    """8 tiles over 4 ranks: 2 each; 2 tiles: ranks 2 and 3 hold none of
    their own and still run (blank tiles, gathered and dropped)."""
    for rows, per, held in (("videos", 2, [2, 2, 2, 2]), ("two_tiles", 1, [1, 1, 0, 0])):
        i = CASES.index((rows, "zigzag"))
        for r in range(4):
            spans = ranks[r][i][2]
            vision = [a for n, a in spans if n == "model.vision"]
            gather = [a for n, a in spans if n == "parallel.media_gather"]
            assert [(a["tiles"], a["frames"]) for a in vision] == [(per, held[r])]
            assert [(a["frames_held"], a["frames_gathered"]) for a in gather] == [(held[r],
                                                                                  4 * per)]


def test_ring_spans_carry_layer_layout_and_bytes(ranks):
    spans = [a for n, a in ranks[0][CASES.index(("videos", "zigzag"))][2] if n == "parallel.ring"]
    fwd = [a for a in spans if a["direction"] == "forward"]
    bwd = [a for a in spans if a["direction"] == "backward"]
    assert sorted(a["layer"] for a in fwd) == [0, 1] and sorted(a["layer"] for a in bwd) == [0, 1]
    assert all(a["layout"] == "zigzag" and a["rotations"] == 3 for a in fwd)
    # K and V (S/4 x 2 heads x 16, f32) and the int32 segment ids, 3 hops
    assert all(a["bytes"] == 3 * (2 * 32 * 2 * 16 * 4 + 32 * 4) for a in fwd)
    assert all(a["bytes"] > fwd[0]["bytes"] for a in bwd)


def test_zero_spans_carry_bytes(ranks):
    loss, spans = ranks[0][-1]
    assert np.isfinite(loss)
    names = {n for n, _ in spans}
    assert names == {"parallel.zero_gather", "parallel.zero_scatter"}
    assert all(a["bytes"] > 0 for _, a in spans)


@pytest.mark.parametrize("n_tiles", [3, 20])
def test_tower_remat_equals_plain(n_tiles):
    """`siglip.forward(remat=True)`: the same features and gradients, with
    fewer tiles than `REMAT_TILES` and with more (encoded a group at a
    time)."""
    from vila_tpu_torch.models import siglip

    cfg = siglip.SigLIPConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                              num_attention_heads=2, image_size=28, patch_size=14)
    gen = torch.Generator().manual_seed(5)
    params = siglip.init_params(gen, cfg)
    pixels = torch.randint(0, 256, (n_tiles, 28, 28, 3), generator=gen, dtype=torch.uint8)
    cot = torch.randn((n_tiles, 4, 32), generator=gen)
    out = []
    for remat in (False, True):
        p = copy.deepcopy(params)
        leaves = [t.requires_grad_(True) for t in dh._tree_leaves(p)]
        feats = siglip.forward(p, cfg, pixels, remat=remat)
        (feats * cot).sum().backward()
        out.append((feats.detach(), [t.grad for t in leaves]))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=1e-5, atol=1e-6)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
