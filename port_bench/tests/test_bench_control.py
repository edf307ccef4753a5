"""The controls that set each cell's limits: the reference in the nearest
precision below the configuration's (fp8 for bf16) must read as not
correct at the cell's own size, on the card (`control.py` runs the same
readings over several seeds). On the CPU at tiny widths the control path
runs and reads further from the reference than the program does."""

import pytest
import torch

from port_bench import control, harness
from test_bench_runs import tiny  # noqa: E402

CELLS = [w["name"] for w in harness.load_json(harness.ROOT + "/BENCHMARK.json")["workloads"]]
SEED = 2**32 + 9


def over_limit(cell, row):
    lim = cell["workload"]["limits"]
    if "control_logit_gap" in row:
        return row["control_logit_gap"] > lim["logit_gap"] >= row["program_logit_gap"]
    return any(row["fp8"][k] > lim[k] for k in lim)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the H100: the control is read at the cell's own size")
    cell = harness.cell(name)
    dev = torch.device("cuda", 0)
    row = (control.train_readings(cell, SEED, dev) if cell["workload"]["driver"] == "train"
           else control.serve_readings(cell, SEED, 15.0, dev))
    assert over_limit(cell, row), row


def test_serving_control_reads_further_than_the_program():
    cell = tiny("nvila8b-chat")
    cell["traffic"].update(sample_tokens=120, sample_requests=8)
    cell["traffic"]["output_tokens"].update(max=24, median=16, min=8)
    cell["workload"]["rate_per_s"] = 1.5
    row = control.serve_readings(cell, SEED, 4.0, torch.device("cpu"))
    assert row["failed"] == 0
    assert row["control_logit_gap"] > row["program_logit_gap"]


def test_training_control_and_fault_read_further_than_rounding():
    row = control.train_readings(tiny("nvila-lite-2b-sft2k"), SEED, torch.device("cpu"))
    assert row["fp8"]["loss_gap"] > 1e-5 and row["fp8"]["grad_gap"] > 1e-3
    assert row["half_batch"]["grad_gap"] > 10 * row["fp8"]["grad_gap"]
