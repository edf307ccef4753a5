"""The port's evaluation (`vila_tpu_torch/eval/{vqa,smoke,loss_eval,lmms,
lmms_tasks,lmms_cli}.py`, `cli/eval.py` and its registry) against the JAX
package's on the CPU, over `helpers.save_tiny_checkpoint(seed=0,
**FLAVORS["base"])` loaded by both packages (f32):

* `vqa.run_eval` gives JAX's greedy predictions, scores and metrics over
  image and text rows; `smoke.run`'s generations equal JAX's engine on the
  task's prompts and `smoke.main` writes JAX's metrics.json; `loss_eval`'s
  loss is JAX's within 1e-5 (relative; f32 on both sides, sums in another
  order) over the same token count;
* `vila-torch-eval` (`cli.eval.main`, tasks as subprocesses with `--device
  cpu`) writes the `results.json` of the JAX package's `vila-eval` for
  smoke-text and loss-regression (the loss within 1e-5); without CUDA and
  without `--device cpu` every task fails and is reported failed, and the
  task modules' `main` raise;
* the registry is JAX's, each command naming the port's module and taking
  `--device $DEVICE`; its breadth, `json_path` and the CLI over a
  synthetic registry (tags, failures, concurrency) as `tests/
  test_benchmarks.py` pins them for JAX;
* the lmms-eval wrapper in standalone mode (no `lmms_eval` here), its task
  helpers and its `!function` shim as lm-eval resolves it; `lmms_cli`
  exits 2 with JAX's message.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from gen_goldens import FLAVORS  # noqa: E402
from vila_tpu.cli import eval as jcli  # noqa: E402
from vila_tpu.eval import lmms_tasks as jtasks  # noqa: E402
from vila_tpu.eval import vqa as jvqa  # noqa: E402
from vila_tpu_torch.cli import eval as tcli  # noqa: E402
from vila_tpu_torch.eval import lmms_tasks as ttasks  # noqa: E402
from vila_tpu_torch.eval import loss_eval, smoke  # noqa: E402
from vila_tpu_torch.eval import vqa as tvqa  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("eval") / "base")
    with torch.no_grad():
        helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    return d


@pytest.fixture(scope="module")
def engines(ckpt):
    import vila_tpu
    from vila_tpu_torch import entry

    return vila_tpu.load(ckpt), entry.load(ckpt, device="cpu")


@pytest.fixture(scope="module")
def vqa_set(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("vqa")
    for i in range(2):
        Image.fromarray(np.random.default_rng(i).integers(
            0, 256, (48, 64, 3), np.uint8)).save(root / f"{i}.png")
    rows = [{"image": "0.png", "question": "What is in the picture?", "answer": "a cat"},
            {"image": "1.png", "question": "Is it red?", "answer": ["yes", "Yes."]},
            {"image": None, "question": "Name a colour.", "answer": "blue"}]
    (root / "vqa.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    return str(root), rows


@pytest.mark.parametrize("pred,golds", [("The Cat!", ["cat"]), ("a dog runs", ["dog"]),
                                        ("", ["x"]), ("An apple.", ["apple", "pear"]),
                                        ("yes", [""])])
def test_scoring_matches_jax(pred, golds):
    assert tvqa.normalize_answer(pred) == jvqa.normalize_answer(pred)
    assert tvqa.score_answer(pred, golds) == jvqa.score_answer(pred, golds)


def test_vqa_run_eval_matches_jax(engines, ckpt, vqa_set, tmp_path):
    root, rows = vqa_set
    path = os.path.join(root, "vqa.jsonl")
    assert tvqa.load_dataset(path) == jvqa.load_dataset(path) == rows
    want = jvqa.run_eval(engines[0], rows, max_new_tokens=6, media_root=root)
    got = tvqa.run_eval(engines[1], rows, max_new_tokens=6, media_root=root)
    assert got == want
    assert [r["prediction"] for r in got["results"]] and got["metrics"]["vqa/count"] == 3
    out = tmp_path / "out"
    assert tvqa.main(["--model-path", ckpt, "--dataset", path,
                      "--output-dir", str(out), "--media-root", root,
                      "--max-new-tokens", "6", "--device", "cpu"]) == 0
    assert json.loads((out / "metrics.json").read_text()) == want["metrics"]
    assert json.loads((out / "results.json").read_text()) == want["results"]


@pytest.mark.parametrize("mode", ["text", "image"])
def test_smoke_matches_jax(engines, ckpt, mode, tmp_path, monkeypatch):
    import vila_tpu
    from vila_tpu.eval import smoke as jsmoke
    from vila_tpu.inference.generate import GenerationConfig

    jengine, tengine = engines
    n_pass, n_total, outs = smoke.run(tengine, mode)
    prompts = ["Hello!", "What is the capital of France?"]
    if mode == "image":
        from PIL import Image as PILImage

        img = PILImage.fromarray(np.random.default_rng(0).integers(0, 255, (224, 224, 3),
                                                                    np.uint8))
        prompts = [[vila_tpu.Image(img), p] for p in prompts]
    want = [jengine.generate_content(p, GenerationConfig(max_new_tokens=16)) for p in prompts]
    assert (n_pass, n_total) == (2, 2) and outs == want
    monkeypatch.setattr(vila_tpu, "load", lambda path, **kw: jengine)
    monkeypatch.setattr(sys, "argv", ["smoke", "--model-path", ckpt, "--output-dir",
                                      str(tmp_path / "jax"), "--mode", mode])
    jsmoke.main()
    assert smoke.main(["--model-path", ckpt, "--output-dir", str(tmp_path / "port"),
                       "--mode", mode, "--device", "cpu"]) == 0
    assert (json.loads((tmp_path / "port" / "metrics.json").read_text())
            == json.loads((tmp_path / "jax" / "metrics.json").read_text())
            == {"smoke": {"pass_rate": 1.0}})


@pytest.mark.parametrize("seq", [64, 128])
def test_loss_eval_matches_jax(engines, ckpt, seq, tmp_path, monkeypatch):
    import vila_tpu
    from vila_tpu.eval import loss_eval as jloss

    jengine, tengine = engines
    monkeypatch.setattr(vila_tpu, "load", lambda path, **kw: jengine)
    monkeypatch.setattr(sys, "argv", ["loss_eval", "--model-path", ckpt, "--output-dir",
                                      str(tmp_path / "jax"), "--seq-len", str(seq)])
    jloss.main()
    want = json.loads((tmp_path / "jax" / "metrics.json").read_text())["loss_eval"]
    value, n = loss_eval.loss(tengine.params, tengine.cfg, seq, "cpu")
    assert n == want["n_tokens"] == 2 * (seq - 1)
    assert abs(value - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    assert loss_eval.main(["--model-path", ckpt, "--output-dir", str(tmp_path / "port"),
                           "--seq-len", str(seq), "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "port" / "metrics.json").read_text())["loss_eval"]
    assert got == {"loss": value, "n_tokens": n}


def test_cli_results_equal_jaxs(ckpt, tmp_path):
    """Both CLIs over their own shipped registries, the same two tasks."""
    tasks = ["smoke-text", "loss-regression"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_DEFAULT_MATMUL_PRECISION="highest")
    jax_run = subprocess.Popen(
        [sys.executable, "-m", "vila_tpu.cli.eval", "-m", ckpt, "--tasks", *tasks,
         "-o", str(tmp_path / "jax")], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    tcli.main(["-m", ckpt, "--tasks", *tasks, "-o", str(tmp_path / "port"), "--device", "cpu"])
    out, _ = jax_run.communicate(timeout=300)
    assert jax_run.returncode == 0, out
    got = json.loads((tmp_path / "port" / "base" / "results.json").read_text())
    want = json.loads((tmp_path / "jax" / "base" / "results.json").read_text())
    assert set(got) == set(want) == set(tasks)
    loss = got["loss-regression"]["metrics"].pop("loss")
    want_loss = want["loss-regression"]["metrics"].pop("loss")
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert got == want
    assert want["smoke-text"] == {"exit_code": 0, "metrics": {"pass_rate": 1.0}}


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_without_cuda_tasks_fail_and_are_reported(no_cuda, ckpt, tmp_path, capsys):
    tcli.main(["-m", ckpt, "--tasks", "smoke-text", "loss-regression", "-o", str(tmp_path)])
    results = json.loads((tmp_path / "base" / "results.json").read_text())
    assert set(results) == {"smoke-text", "loss-regression"}
    for r in results.values():
        assert r["exit_code"] != 0 and r["metrics"] == {}
    for name in results:
        assert not (tmp_path / "base" / name / "metrics.json").exists()
        assert "CUDA is not available" in (tmp_path / "base" / name / "log.txt").read_text()
    assert "FAIL(1)] smoke-text" in capsys.readouterr().out
    for main, extra in ((tvqa.main, ["--dataset", "x.jsonl"]), (smoke.main, []),
                        (loss_eval.main, [])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--model-path", ckpt, "--output-dir", str(tmp_path / "o"), *extra])


def test_registry_is_jaxs_with_the_ports_modules():
    got, want = tcli.load_registry(), jcli.load_registry()
    assert list(got) == list(want) and len(got) == 96
    for name, spec in want.items():
        assert got[name]["tags"] == spec["tags"] and got[name]["metrics"] == spec["metrics"]
        assert got[name]["command"] == spec["command"].replace(
            "python -m vila_tpu.eval.", "python -m vila_tpu_torch.eval.") + " --device $DEVICE"
    cmd = tcli.command(got["pope-mini"], "M", "O", "cpu")
    assert cmd.startswith(sys.executable) and cmd.endswith("--device cpu")
    assert "vila_tpu_torch.eval.benchmarks --task pope --model-path M" in cmd


def test_registry_breadth_pinned():
    reg = tcli.load_registry()
    by_tag = {}
    for name, spec in reg.items():
        for t in spec.get("tags", []):
            by_tag.setdefault(t, []).append(name)
        assert spec.get("metrics"), name
    assert len(by_tag["benchmark"]) >= 45 and len(by_tag["lmms"]) >= 35
    assert len(by_tag["longvila"]) >= 10 and sorted(by_tag["mini"]) == ["pope-mini",
                                                                         "textvqa-mini"]
    for task in ("textvqa", "gqa", "scienceqa", "pope", "videomme", "videomme_w_subtitle",
                 "lmms-videomme_w_subtitle-64", "egoschema_val", "lmms-mmmu_val"):
        assert task in reg and "command" in reg[task]


@pytest.mark.parametrize("obj,path,want", [({"mme/total": 1523.0}, "mme/total", 1523.0),
                                           ({"smoke": {"pass_rate": 1.0}}, "smoke/pass_rate", 1.0),
                                           ({"a/b": 1, "a": {"b": 2}}, "a/b", 1)])
def test_json_path_flat_and_nested(obj, path, want):
    assert tcli.json_path(obj, path) == jcli.json_path(obj, path) == want


def test_cli_end_to_end_over_a_synthetic_registry(tmp_path, capsys):
    from vila_tpu_torch.utils import io as tio

    reg = {
        "good": {"tags": ["core"], "metrics": {"accuracy": "acc"}, "command": (
            "python -c \"import json; json.dump({'acc': 0.75, 'dev': '$DEVICE'}, "
            "open('$OUTPUT_DIR/metrics.json', 'w'))\"")},
        "bad": {"tags": ["core"], "command": "exit 7", "metrics": {"accuracy": "acc"}},
        "missing": {"tags": ["core"], "command": "python -c \"import json; json.dump({}, "
                    "open('$OUTPUT_DIR/metrics.json', 'w'))\"", "metrics": {"x": "y/z"}},
        "skipped": {"tags": ["other"], "command": "true", "metrics": {"x": "x"}},
    }
    path = str(tmp_path / "registry.yaml")
    tio.save(path, reg)
    out = tmp_path / "runs"
    tcli.main(["-m", "model-x", "--tags", "core", "-o", str(out), "--registry", path,
               "--concurrency", "2", "--device", "cpu"])
    results = json.loads((out / "model-x" / "results.json").read_text())
    assert results == {"good": {"exit_code": 0, "metrics": {"accuracy": 0.75}},
                       "bad": {"exit_code": 7, "metrics": {}},
                       "missing": {"exit_code": 0, "metrics": {"x": None}}}
    assert json.loads((out / "model-x" / "good" / "metrics.json").read_text())["dev"] == "cpu"
    text = capsys.readouterr().out
    assert "FAIL(7)] bad" in text and "== summary ==" in text
    tcli.main(["-m", "m", "--tags", "none", "--registry", path, "-o", str(out)])
    assert "no tasks selected" in capsys.readouterr().out


class FakeEngine:
    def __init__(self, table):
        self.table, self.prompts = table, []

    def generate_content(self, prompt, gen=None):
        self.prompts.append((prompt, gen.max_new_tokens, gen.temperature, gen.top_p))
        return next((a for k, a in self.table.items() if k in prompt[-1]), "unknown")


def test_lmms_wrapper_standalone_matches_jax(monkeypatch, tmp_path):
    import vila_tpu
    import vila_tpu_torch
    from vila_tpu.eval.lmms import VILA as JVILA
    from vila_tpu_torch.eval import lmms
    from vila_tpu_torch.media import Image

    assert not lmms._HAVE_LMMS and lmms.VILA.__mro__[1] is object
    engines = []
    monkeypatch.setattr(vila_tpu_torch, "load", lambda path, device="cuda": engines.append(
        (path, device)) or FakeEngine({"describe": "a scene", "video": "a clip"}))
    jeng = FakeEngine({"describe": "a scene", "video": "a clip"})
    monkeypatch.setattr(vila_tpu, "load", lambda path, **kw: jeng)
    model = lmms.VILA(model_path="dummy", cache_dir=str(tmp_path / "port"), device="cpu")
    jmodel = JVILA(model_path="dummy", cache_dir=str(tmp_path / "jax"))
    assert engines == [("dummy", "cpu")]
    reqs = [{"context": "describe this", "media": [], "gen_kwargs": {"max_new_tokens": 8}},
            {"context": "the video?", "media": ["v.mp4", "p.png"],
             "gen_kwargs": {"temperature": 0.5, "top_p": 0.9}}]
    out = model.generate_until(reqs)
    assert out == jmodel.generate_until(reqs) == ["a scene", "a clip"]
    port_prompts = model.engine.prompts
    kinds = [[type(m).__name__ for m in p[:-1]] for p, *_ in port_prompts]
    assert kinds == [[], ["Video", "Image"]] and isinstance(port_prompts[1][0][1], Image)
    assert [p[1:] for p in port_prompts] == [p[1:] for p in jeng.prompts]
    n = len(port_prompts)
    assert model.generate_until(reqs) == out and len(model.engine.prompts) == n  # cached
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    with pytest.raises(AssertionError):
        lmms.VILA(model_path="dummy", batch_size=2)


def test_lmms_task_helpers_match_jax(tmp_path):
    doc = {"question": "What happens?", "options": ["A. runs", "B. sits", "C. eats", "D. sleeps"],
           "answer": "B", "videoID": "vid1"}
    (tmp_path / "vid1.srt").write_text(
        "1\n00:00:01,000 --> 00:00:02,000\n<i>hello there</i>\n\n"
        "2\n00:00:03,000 --> 00:00:04,000\ngeneral\n")
    assert ttasks.doc_to_text(doc) == jtasks.doc_to_text(doc)
    for d, root in ((doc, str(tmp_path)), ({**doc, "videoID": "nope"}, None),
                    ({**doc, "subtitles": ["a", "b"]}, None)):
        assert ttasks.doc_to_text_subtitle(d, root) == jtasks.doc_to_text_subtitle(d, root)
    assert "hello there general" in ttasks.doc_to_text_subtitle(doc, str(tmp_path))
    for pred in ("The answer is B", "B.", "A", "It is a man sitting", "(b) because", "c.",
                 "d", "", "none of them"):
        assert ttasks.parse_mc_answer(pred) == jtasks.parse_mc_answer(pred)
        assert ttasks.process_results(doc, [pred]) == jtasks.process_results(doc, [pred])
    assert ttasks.register() is None


def test_lmms_yaml_function_refs_resolve_like_lm_eval():
    """lm-eval loads `<yaml_dir>/<mod>.py` as a loose file for `!function
    mod.fn`; the port's shim resolves every reference in a fresh
    interpreter without loading JAX or the JAX package."""
    import re

    yaml_dir = os.path.join(REPO, "vila_tpu_torch", "eval", "lmms_yaml")
    refs = sorted({m.group(1) for f in os.listdir(yaml_dir) if f.endswith(".yaml")
                   for line in open(os.path.join(yaml_dir, f))
                   for m in [re.search(r"!function\s+(\S+)", line)] if m})
    assert refs == ["utils.doc_to_text", "utils.doc_to_text_subtitle_env",
                    "utils.doc_to_visual", "utils.process_results"]
    code = (
        "import importlib.util, json, sys\n"
        f"refs = {refs!r}\n"
        "for ref in refs:\n"
        "    mod, fn = ref.rsplit('.', 1)\n"
        f"    spec = importlib.util.spec_from_file_location(mod, {yaml_dir!r} + '/' + mod + '.py')\n"
        "    m = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(m)\n"
        "    assert callable(getattr(m, fn)), ref\n"
        "    assert getattr(m, fn).__module__ == 'vila_tpu_torch.eval.lmms_tasks'\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'vila_tpu', 'yaml'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd="/", capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_lmms_cli_exits_2_with_jaxs_message_without_lmms_eval(capsys):
    from vila_tpu.eval import lmms_cli as jlmms_cli
    from vila_tpu_torch.eval import lmms_cli

    argv = ["--task", "videomme", "--model-path", "m", "--output-dir", "o"]
    assert lmms_cli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err
    assert jlmms_cli.main(argv) == 2
    want = capsys.readouterr().err
    assert got == want.replace("vila_tpu.eval.benchmarks", "vila_tpu_torch.eval.benchmarks")
    assert "lmms-eval is not installed" in got
