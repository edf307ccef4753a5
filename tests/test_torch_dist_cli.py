"""The port's command lines on a mesh, on the CPU over gloo: `cli.train`
with `--distributed true --sp 2` (two ranks, the zigzag ring, ZeRO-3)
logs the losses of the same command on one process (each step's loss and
grad norm within rtol 2e-5: the same global batches, summed in another
order), and its checkpoint resumes on one process; `eval.niah_cli` writes
the same grid at `--sp 2` as on one process. Over the tiny checkpoint
`helpers.save_tiny_checkpoint(seed=0, **FLAVORS["base"])`.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
import torch_dist_helpers as dh  # noqa: E402
from gen_goldens import FLAVORS  # noqa: E402
from vila_tpu_torch.cli import train as train_cli  # noqa: E402
from vila_tpu_torch.eval import niah_cli  # noqa: E402


def _train_argv(ckpt, out, steps=3, **extra):
    argv = ["--model-path", ckpt, "--device", "cpu", "--stage", "sft",
            "--data-mixture", "dummy_mix", "--max-steps", str(steps), "--save-steps", "2",
            "--seq-len", "256", "--logging-steps", "1", "--output-dir", out,
            "--ce-chunk-size", "128"]
    for k, v in extra.items():
        argv += ["--" + k.replace("_", "-"), str(v)]
    return argv


NIAH_ARGS = ["--contexts", "128", "256", "--depths", "0.0", "1.0", "--num-frames", "4",
             "--device", "cpu"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist_cli")
    ckpt = str(tmp / "base")
    helpers.save_tiny_checkpoint(ckpt, seed=0, **FLAVORS["base"])
    calls = [("cli_main", dict(module="vila_tpu_torch.cli.train", argv=_train_argv(
                 ckpt, str(tmp / "sp2"), distributed="true", sp=2))),
             ("cli_main", dict(module="vila_tpu_torch.eval.niah_cli", argv=[
                 "--model-path", ckpt, "--output-dir", str(tmp / "niah_sp2"), "--sp", "2"]
                 + NIAH_ARGS))]
    rcs = dh.spawn(calls, 2, timeout=400)
    return tmp, ckpt, rcs


def _history(out):
    with open(os.path.join(out, "log_history.json")) as f:
        return [(r["step"], r["loss"], r["grad_norm"]) for r in json.load(f)]


def test_train_cli_sp2_matches_one_process_and_resumes(runs):
    tmp, ckpt, rcs = runs
    assert [r[0] for r in rcs] == [0, 0]
    sp2 = _history(str(tmp / "sp2"))
    assert train_cli.main(_train_argv(ckpt, str(tmp / "one"))) == 0
    one = _history(str(tmp / "one"))
    assert [r[0] for r in sp2] == [r[0] for r in one] == [1, 2, 3]
    np.testing.assert_allclose([r[1:] for r in sp2], [r[1:] for r in one], rtol=2e-5)
    # the sp=2 run's step-2 checkpoint (whole tensors) resumed on one process
    resumed = str(tmp / "resumed")
    shutil.copytree(os.path.join(tmp, "sp2", "checkpoints", "checkpoint-2"),
                    os.path.join(resumed, "checkpoints", "checkpoint-2"))
    assert train_cli.main(_train_argv(ckpt, resumed, steps=3)) == 0
    np.testing.assert_allclose([r[1:] for r in _history(resumed)], [r[1:] for r in sp2[2:]],
                               rtol=2e-5)


def test_niah_cli_sp2_matches_one_process(runs):
    tmp, ckpt, rcs = runs
    assert [r[1] for r in rcs] == [0, 0]
    assert niah_cli.main(["--model-path", ckpt, "--output-dir", str(tmp / "niah_one")]
                         + NIAH_ARGS) == 0
    grids = []
    for name in ("niah_sp2", "niah_one"):
        with open(os.path.join(tmp, name, "metrics.json")) as f:
            grids.append(json.load(f)["niah/grid"])
    assert grids[0] == grids[1] and len(grids[0]) == 4
