"""The operation, byte and pair counts against small cases worked by hand."""

import pytest

from port_bench import flops
from port_bench.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

LLM = {"vocab_size": 1000, "hidden_size": 256, "intermediate_size": 512,
       "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1}


def test_w4_bytes():
    # 256 x 128 nibbles, and 2 groups of 128 rows x 128 columns of bf16 scales
    assert flops.w4_bytes(256, 128) == 256 * 128 // 2 + 2 * 128 * 2


def test_segment_pairs():
    assert flops.causal_pairs(4) == 10
    assert flops.segment_pairs([1, 1, 1, 2, 2, 0, 0]) == 6 + 3
    assert flops.segment_pairs([0, 0]) == 0


def test_layer_params_and_forward():
    # qkv 256 x (2 + 2) 128, o 256 x 256, gate_up 256 x 1024, down 512 x 256
    p = 256 * 512 + 256 * 256 + 256 * 1024 + 512 * 256
    assert flops.llm_layer_params(LLM) == p
    f = flops.llm_forward_flops(LLM, tokens=3, context_pairs=6, logits=1)
    assert f == 2 * 3 * 2 * p + 4 * 2 * 2 * 128 * 6 + 2 * 256 * 1000


def test_decode_step_least_is_bytes_bound_here():
    rows = [10, 20]
    got = flops.decode_step_least_s(LLM, rows)
    w = 2 * (flops.w4_bytes(256, 512) + flops.w4_bytes(256, 256) + flops.w4_bytes(256, 1024)
             + flops.w4_bytes(512, 256) + 512 * 2 + 2 * 256 * 2)
    kv = 30 * 2 * 2 * 1 * 128 * 2
    assert got["layers"] == pytest.approx(max((w + kv) / PEAK_HBM_BYTES_PER_S,
                                              (2 * 2 * 2 * flops.llm_layer_params(LLM)
                                               + 4 * 2 * 2 * 128 * 30) / PEAK_BF16_FLOPS))
    head = flops.w4_bytes(256, 1000) + 2 * 1000 * 2
    assert got["lm_head"] == pytest.approx(head / PEAK_HBM_BYTES_PER_S)


def test_prefill_least_counts_real_rows():
    m = 100
    want = 2 * sum(flops.least_s(2 * m * i * o, flops.w4_bytes(i, o) + m * (i + o) * 2)
                   for i, o in ((256, 512), (256, 256), (256, 1024), (512, 256)))
    assert flops.prefill_w4_least_s(LLM, m) == pytest.approx(want)


def test_flash_least():
    pairs, tokens = 1000, 100
    hdim, kv = 256, 256
    want = (flops.least_s(4 * hdim * pairs, tokens * (2 * hdim + kv) * 2)
            + flops.least_s(10 * hdim * pairs, tokens * (4 * hdim + 2 * kv) * 2))
    assert flops.flash_least_s(LLM, pairs, tokens) == pytest.approx(want)


def test_tower_and_projector():
    vis = {"hidden_size": 8, "intermediate_size": 16, "patch_size": 2, "image_size": 4,
           "num_hidden_layers": 3, "feature_layer": -2}
    n = 4  # 2 x 2 patches of 2 x 2 x 3 pixels
    per = 2 * n * 12 * 8 + 2 * (2 * n * (4 * 64 + 2 * 8 * 16) + 4 * n * n * 8)
    assert flops.tower_layers_run(vis) == 2
    assert flops.tower_forward_flops(vis, 3, 2) == 3 * per
    # 2 x 2 patches unshuffle to 1 token of 32 channels, then 32 -> 10 -> 10
    assert flops.projector_forward_flops(vis, 10, 3) == 3 * 2 * 1 * (32 * 10 + 100)
