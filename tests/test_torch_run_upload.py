"""The port's `vila-torch-run` and `vila-torch-upload` against the JAX
package's `vila-run` and `vila-upload`, and `utils.profiling`'s `annotate`
and `MetricsLogger`, on the CPU:

* `run_with_retries` returns JAX's codes after JAX's attempts on the same
  scripts (`time.sleep` patched, so nothing waits), and `main` strips a
  leading `--`; paired with the port's `Trainer`, a run preempted with exit
  124 is retried and resumes from its checkpoint to the end;
* `vila-torch-upload` stages what JAX's stages, through a stub
  `huggingface_hub` (no test reaches the network): the component
  checkpoint as it is, or with `--remote-code --device cpu` the port's
  export (config.json equal to JAX's export's); a checkpoint without a
  component and a missing `huggingface_hub` raise JAX's `SystemExit`;
  `--remote-code` defaults to the card;
* `annotate(name)` shows in a CPU trace's timeline and op table;
* with a `wandb` whose `init` raises, both packages' `MetricsLogger`s
  carry on and write `metrics.jsonl`.
"""

import json
import os
import sys
import textwrap
import types

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from vila_tpu.cli import run as jrun  # noqa: E402
from vila_tpu.cli import upload as jupload  # noqa: E402
from vila_tpu.utils import profiling as jprofiling  # noqa: E402
from vila_tpu_torch.cli import run  # noqa: E402
from vila_tpu_torch.cli import upload  # noqa: E402
from vila_tpu_torch.utils import profiling  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# each script's exit code by attempt (its last one repeats)
SCRIPTS = {"ok": [0], "fails": [3], "timeout_then_ok": [124, 0], "fails_then_ok": [7, 0],
           "timeouts_then_fails": [124, 124, 5]}


def _script(tmp_path, codes):
    counter = tmp_path / "attempts"
    counter.write_text("0")
    path = tmp_path / "job.py"
    path.write_text(textwrap.dedent(f"""
        import sys
        n = int(open({str(counter)!r}).read())
        open({str(counter)!r}, "w").write(str(n + 1))
        codes = {codes!r}
        sys.exit(codes[min(n, len(codes) - 1)])
    """))
    return [sys.executable, str(path)], counter


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_with_retries_matches_jax(tmp_path, monkeypatch, name):
    waits = []
    monkeypatch.setattr(run.time, "sleep", waits.append)
    assert jrun.time is run.time  # one patch holds both modules
    out = {}
    for tag, fn in (("jax", jrun.run_with_retries), ("port", run.run_with_retries)):
        (tmp_path / tag).mkdir()
        cmd, counter = _script(tmp_path / tag, SCRIPTS[name])
        code = fn(cmd, max_retries=2)
        out[tag] = (code, int(counter.read_text()), list(waits))
        waits.clear()
    assert out["port"] == out["jax"]


def test_main_strips_a_leading_separator(tmp_path):
    cmd, counter = _script(tmp_path, [4])
    with pytest.raises(SystemExit) as e:
        run.main(["--max-retries", "0", "--"] + cmd)
    assert e.value.code == 4 and counter.read_text() == "1"


TRAIN_JOB = """
import os
import sys
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from vila_tpu_torch.data import collate
from vila_tpu_torch.models import projector, qwen2, siglip, vlm
from vila_tpu_torch.train.trainer import TrainArgs, Trainer

first = not os.path.exists({marker!r})
open({marker!r}, "a").write("x")
ids = np.random.default_rng(0).integers(2, 64, (8, 24)).astype(np.int32)
rows = [{{"input_ids": r, "labels": r.copy(), "tiles": np.zeros((0, 28, 28, 3), np.uint8),
          "media_positions": np.zeros((0,), np.int32)}} for r in ids]
cfg = vlm.VLMConfig(
    llm=qwen2.LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2),
    vision=siglip.SigLIPConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                               num_attention_heads=4, image_size=28, patch_size=14),
    projector=projector.ProjectorConfig(mm_hidden_size=24, hidden_size=32))
args = TrainArgs(output_dir={out!r}, max_steps=2, per_device_batch_size=4, seq_len=24,
                 learning_rate=1e-3, warmup_ratio=0.0, lr_schedule="constant",
                 logging_steps=1, save_steps=1,
                 **(dict(total_time_limit_s=0.0, save_margin_s=0.0) if first else {{}}))
trainer = Trainer(cfg, vlm.init_params(torch.Generator().manual_seed(0), cfg), rows,
                  collate.Collator(seq_len=24), args, device="cpu")
hist = trainer.train()["log_history"]
print("steps", [h["step"] for h in hist], "from", trainer.start_step)
"""


def test_run_retries_a_preempted_trainer_to_the_end(tmp_path, capfd):
    """The port's `Trainer` saves and exits 124 on preemption; the runner
    retries it and the retry resumes from the saved step."""
    job = tmp_path / "train_job.py"
    job.write_text(TRAIN_JOB.format(repo=REPO, marker=str(tmp_path / "started"),
                                    out=str(tmp_path / "out")))
    assert run.run_with_retries([sys.executable, str(job)], max_retries=0) == 0
    assert (tmp_path / "started").read_text() == "xx"
    assert "steps [2] from 1" in capfd.readouterr().out


class _Hub:
    """A stub `huggingface_hub` whose `HfApi` records its calls."""

    def __init__(self):
        self.calls = []
        hub = self

        class HfApi:
            def __init__(self, token=None):
                hub.calls.append(("HfApi", {"token": token}))

            def create_repo(self, repo_id, **kw):
                hub.calls.append(("create_repo", dict(kw, repo_id=repo_id)))

            def upload_folder(self, **kw):
                hub.calls.append(("upload_folder", kw))

        self.module = types.ModuleType("huggingface_hub")
        self.module.HfApi = HfApi


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ckpt"))
    helpers.save_tiny_checkpoint(d, seed=0)
    return d


def test_upload_stages_the_component_checkpoint_as_jax(monkeypatch, ckpt):
    argv = [ckpt, "org/model", "--private", "--branch", "dev", "--token", "t"]
    calls = {}
    for tag, main in (("jax", jupload.main), ("port", upload.main)):
        hub = _Hub()
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
        assert main(argv) == 0
        calls[tag] = hub.calls
    assert calls["port"] == calls["jax"]
    assert calls["port"][2] == ("upload_folder", dict(
        folder_path=ckpt, repo_id="org/model", revision="dev",
        commit_message="upload vila_tpu checkpoint"))


def test_upload_remote_code_stages_the_port_export(monkeypatch, ckpt):
    folders = {}
    for tag, main, extra in (("jax", jupload.main, []),
                             ("port", upload.main, ["--device", "cpu"])):
        hub = _Hub()
        monkeypatch.setitem(sys.modules, "huggingface_hub", hub.module)
        assert main([ckpt, "org/model", "--remote-code"] + extra) == 0
        folders[tag] = hub.calls[-1][1]["folder_path"]
    configs = []
    for d in folders.values():
        assert os.path.exists(os.path.join(d, "model.safetensors"))
        with open(os.path.join(d, "config.json")) as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]


def test_upload_refuses_what_jax_refuses(monkeypatch, ckpt, tmp_path):
    partial = tmp_path / "partial"
    for sub in ("llm", "vision_tower"):
        (partial / sub).mkdir(parents=True)
    monkeypatch.setitem(sys.modules, "huggingface_hub", _Hub().module)
    msgs = []
    for main in (jupload.main, upload.main):
        with pytest.raises(SystemExit) as e:
            main([str(partial), "org/model"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "missing mm_projector/" in msgs[1]
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)  # the import fails
    msgs = []
    for main in (jupload.main, upload.main):
        with pytest.raises(SystemExit) as e:
            main([ckpt, "org/model"])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "huggingface_hub is not installed" in msgs[1]


def test_upload_remote_code_defaults_to_the_card(monkeypatch, ckpt):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.setitem(sys.modules, "huggingface_hub", _Hub().module)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        upload.main([ckpt, "org/model", "--remote-code"])


def test_annotate_shows_in_the_trace_and_the_op_table(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("decode_step"):
            (x @ x).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    region = [e for e in events if e.get("name") == "decode_step"]
    assert region and all(e.get("dur", 0) > 0 for e in region)
    inside = [e for e in events if e.get("name") == "aten::mm"
              and region[0]["ts"] <= e["ts"] <= region[0]["ts"] + region[0]["dur"]]
    assert inside
    with open(tmp_path / "ops.txt") as f:
        assert "decode_step" in f.read()


def test_metrics_logger_survives_a_failing_wandb_init(monkeypatch, tmp_path):
    wandb = types.ModuleType("wandb")

    def init(**kw):
        raise RuntimeError("wandb cannot start here")

    wandb.init = init
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    for tag, mod in (("jax", jprofiling), ("port", profiling)):
        logger = mod.MetricsLogger(str(tmp_path / tag), project="vila", run_name="r")
        logger.log({"loss": 1.5}, step=3)
        logger.close()
        with open(tmp_path / tag / "metrics.jsonl") as f:
            rec = json.loads(f.read())
        assert rec["loss"] == 1.5 and rec["step"] == 3
