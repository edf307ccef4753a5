"""The sequence-parallel training cell on the CPU: its traffic, a whole run
of its driver over four gloo processes at tiny widths (the plain versions
standing in for the kernels), the runs that must read `correct` false or
end with no result, and each of its readers on a synthetic trace."""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

from port_bench import flops, harness, longvideo, traffic
from port_bench.trace import Trace

CELL = "qwen2-7b-longvila-sp4"
SEED = 2**33 + 7


def tiny():
    cell = copy.deepcopy(harness.cell(CELL))
    c = cell["config"]
    c["llm"].update(vocab_size=2048, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, num_key_value_heads=1)
    c["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                       num_attention_heads=4, image_size=112)
    c["training"]["seq_len"] = 512
    mix = cell["traffic"]
    mix.update(tile_size=112, tile_pool=8, first_text_id=300, pool=64, max_steps=400,
               check_seq_len=256)
    mix["frames"].update(uniform=[1, 4], step=2)
    mix["text_tokens"].update(min=16, max=64)
    return cell


def run(fault=None, seconds=2.0):
    ctx = {"cell": tiny(), "seed": SEED, "seconds": seconds, "trace": False,
           "device": torch.device("cpu"), "t_start": time.perf_counter(), "trace_path": None,
           "fault": fault}
    return harness.driver("train_sp").run(ctx)


def test_traffic_frames_text_and_fill():
    cell = harness.cell(CELL)
    mix, config = cell["traffic"], cell["config"]
    samples = longvideo.samples(mix, config["llm"]["vocab_size"], 259, 256, SEED)
    for s in samples:
        f = len(s["frame_ids"])
        assert 64 <= f <= 256 and f % 8 == 0
        media = 256 * f
        text = len(s["input_ids"]) - media - 1
        assert 64 <= text <= 1024
        assert (s["input_ids"][:media] == 259).all() and s["input_ids"][media] == 10
        labelled = np.nonzero(s["labels"] != longvideo.IGNORE)[0]
        assert labelled.min() == media + 1 + round(text / 2)  # the question is masked
        assert (s["frame_ids"] < mix["tile_pool"]).all()
    rows = traffic.rows(samples, config["training"]["seq_len"], mix["max_steps"])
    fill = [sum(len(s["input_ids"]) for s in r) / config["training"]["seq_len"] for r in rows]
    assert all(2 <= len(r) <= 5 for r in rows)
    assert 0.75 <= np.mean(fill) <= 0.95 and max(fill) <= 1.0
    frames = [sum(len(s["frame_ids"]) for s in r) for r in rows]
    assert 350 <= np.mean(frames) <= 550
    # another seed: the same sizes in another order
    other = longvideo.samples(mix, config["llm"]["vocab_size"], 259, 256, SEED + 1)
    assert sorted(len(s["input_ids"]) for s in other) == sorted(len(s["input_ids"])
                                                                 for s in samples)


def test_check_row_packs_videos_from_the_run():
    """The check's row: at least two of the run's videos, in the run's
    order, inside `check_seq_len`, which the zigzag ring divides."""
    from port_bench.drivers.train_sp import check_row

    cell = harness.cell(CELL)
    n = cell["traffic"]["check_seq_len"]
    sp = cell["config"]["training"]["mesh"]["sp"]
    assert n % (2 * sp) == 0 and n < cell["config"]["training"]["seq_len"]
    for seed in (SEED, SEED + 1, 3000000126):
        samples = longvideo.samples(cell["traffic"], cell["config"]["llm"]["vocab_size"], 259,
                                    256, seed)
        row = check_row(cell, seed)
        assert len(row) >= 2 and sum(len(s["input_ids"]) for s in row) <= n
        at = [next(i for i, t in enumerate(samples) if np.array_equal(t["input_ids"],
                                                                       s["input_ids"]))
              for s in row]
        assert at == sorted(at)


def test_run_holds():
    rec = run()
    c = rec["compared"]
    assert rec["correct"], c
    assert set(c) == {"loss_gap", "grad_gap", "step_gap"}
    assert rec["failed"] == 0 and rec["metrics"]["train_tok_s"] > 0
    assert len(rec["rank_memory_peaks"]) == 4
    ref = rec["reference"]
    assert len(ref["losses"]) == 2 and ref["losses"][0] == ref["losses"][1]
    assert min(ref["step"].values()) >= 0 and max(ref["step"].values()) > 0


@pytest.mark.parametrize("fault, caught, passed", [
    pytest.param("frozen", "step_gap", "grad_gap", id="frozen"),
    pytest.param("features", "grad_gap", None, id="features"),
])
def test_fault_reads_incorrect(fault, caught, passed):
    """An update computed and not written back is caught by the step along
    the gradient alone (its moments, and so its gradient, are sound); rank
    1's features zeroed by the gradient."""
    rec = run(fault)
    c = rec["compared"]
    assert not rec["correct"]
    assert c[caught]["value"] > c[caught]["limit"]
    if passed is not None:
        assert c[passed]["value"] <= c[passed]["limit"]
    if fault == "frozen":
        assert c["step_gap"]["value"] == pytest.approx(1.0)


def test_a_rank_that_raises_ends_the_run():
    t = time.perf_counter()
    with pytest.raises(SystemExit, match="exited with .* every rank stopped, no result"):
        run("raise")
    assert time.perf_counter() - t < 120


# --------------------------------------------------------------------------
# readers on a synthetic trace
# --------------------------------------------------------------------------


def synthetic():
    """One traced step (program spans and device operations, seconds) and
    one untraced step."""
    from vila_tpu_torch.utils.profiling import Span

    def span(name, a, b, **attrs):
        return Span(name, 0, None, None, 1, a, b, attrs)

    kernels = [(1, 1.3, 1.3, 1.5, "vision_gemm"), (2, 1.6, 1.6, 1.9, "ncclDevKernel_AllGather"),
               (3, 2.1, 2.1, 2.6, "flash_fwd_sm90_kernel"),
               (4, 2.5, 2.6, 2.8, "ncclDevKernel_SendRecv"),
               (8, 3.2, 3.2, 3.4, "ce_rows_sm90_kernel"),
               (5, 6.1, 6.1, 6.5, "flash_bwd_dq_sm90_kernel"),
               (6, 6.2, 6.3, 6.6, "ncclDevKernel_SendRecv"),
               (7, 7.6, 7.6, 7.7, "ncclDevKernel_ReduceScatter"),
               (9, 8.1, 8.1, 8.4, "multi_tensor_apply_kernel")]
    events = [{"cat": "user_annotation", "name": "trace_window", "ts": 0, "dur": 10e6}]
    for corr, at, s, e, name in kernels:
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
                       "ts": at * 1e6, "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": s * 1e6, "dur": (e - s) * 1e6,
                       "args": {"correlation": corr}})
    tr = Trace(events, [((1, 1), 1.0, 9.0, "train_step#2"), ((1, 1), 8.0, 8.5, "optimizer#0")],
               0.0)
    config = harness.cell(CELL)["config"]
    spans = [span("data.collate", 0.2, 0.5), span("train.to_device", 0.6, 0.7),
             span("train.step", 1.0, 9.0), span("train.forward", 1.0, 3.5),
             span("model.vision", 1.2, 1.4, frames=120),
             span("parallel.zero_gather", 1.5, 1.8), span("parallel.ring", 2.0, 3.0),
             span("train.lm_head", 3.1, 3.5), span("train.backward", 5.9, 7.9),
             span("parallel.ring", 6.0, 7.0), span("parallel.zero_scatter", 7.5, 7.8),
             span("train.update", 8.0, 8.5)]
    steps = {2: {"wall": 8.0, "tokens": 110000, "tiles": 420, "pairs": 2 * 10**9,
                 "rank_pairs": 5 * 10**8, "rank_tokens": 27500, "traced": True},
             3: {"wall": 10.0, "tokens": 120000, "tiles": 460, "pairs": 3 * 10**9,
                 "rank_pairs": 7 * 10**8, "rank_tokens": 30000, "traced": False}}
    return {"trace": tr, "program_spans": spans, "config": config, "steps": steps}


READINGS = {
    "ring_ms.sp4": 1400.0, "ring_exposed_ms.sp4": 300.0, "zero_comm_ms.sp4": 400.0,
    "vision_ms.sp4": 200.0, "forward_ms.sp4": 1400.0, "backward_ms.sp4": 800.0,
    "update_ms.sp4": 300.0, "lm_head_ms.sp4": 200.0, "step_idle_ms.sp4": 5700.0,
    "data_ms.sp4": 400.0,
    # the sft cell's readers, which read rank 0's record as they read the sft cell's
    "idle_share.sft": 77.0, "optimizer_ms.sft": 300.0,
    "row_fill.sft": 100.0 * 230000 / (2 * 131072),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_synthetic_trace(name):
    got = harness.metric_reader(name)(synthetic())
    assert got == pytest.approx(READINGS[name], rel=1e-6)
    if name != "row_fill.sft":  # read from the steps, traced or not
        assert harness.metric_reader(name)({"trace": None}) is None


def test_flash_roofline_reader_on_synthetic_trace():
    rec = synthetic()
    llm = rec["config"]["llm"]
    least = llm["num_hidden_layers"] * flops.flash_least_s(llm, 5 * 10**8, 27500)
    got = harness.metric_reader("flash_roofline.sp4")(rec)
    assert got == pytest.approx(100.0 * least / 0.9, rel=1e-6)


def test_mfu_reader_on_synthetic_trace():
    rec = synthetic()
    want = flops.train_step_flops(rec["config"], 120000, 3 * 10**9, 460)
    got = harness.metric_reader("mfu.sp4")(rec)
    assert got == pytest.approx(100.0 * want / (10.0 * 4 * harness.PEAK_BF16_FLOPS), rel=1e-6)
    assert 0 < got < 100


def test_benchmark_entries_name_readers():
    bench = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    mine = [m for m in bench["per_layer"] if CELL in m.get("workloads", [])]
    assert sorted(m["name"] for m in mine) == sorted([*READINGS, "flash_roofline.sp4", "mfu.sp4"])
    for m in mine:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics", m["name"] + ".py"))


@pytest.mark.parametrize("layout", ["zigzag", "contiguous"])
def test_rank_pairs_add_up_to_the_row(layout):
    from port_bench.drivers import train_sp
    from vila_tpu_torch.parallel.ring_attention import zigzag_order

    seg = np.repeat([1, 2, 3, 0], [700, 1500, 900, 996])  # three samples and padding
    order = zigzag_order(len(seg), 4) if layout == "zigzag" else np.arange(len(seg))
    per_rank = [train_sp.rank_pairs(seg, order, 4, r) for r in range(4)]
    assert sum(per_rank) == flops.segment_pairs(seg) and min(per_rank) > 0
