"""The port's quantized-accuracy measurement (`vila_tpu_torch/eval/
quant_acc.py`) against the JAX package's (`scripts/quant_acc.py`'s steps,
run here on the CPU without writing its result file) on the committed
quant probe and the first 8 pope-mini questions, both in f32:

* the calibration ids are equal;
* the bf16, W4-RTN and W4-AWQ engines give the same predictions and
  metrics (AWQ keeps every calibration row on both sides, 8 x 48 = 384, so
  that the JAX and torch row draws select the same rows);
* each engine's first-token logits agree: the bf16 engine's (f32 on both
  sides here) within 1e-3, the sums running in other orders; the W4
  engines' within one bf16 step of the largest logit (2^-7 max|logit|):
  their W4 lm_head rounds its f32 sums, taken in another order on each
  side, to bf16 (K1's tolerance), and the AWQ scales carry the ulps by
  which the two libraries' pow, log and exp differ.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest

from vila_tpu import entry as jentry
from vila_tpu.eval import benchmarks as jbench
from vila_tpu.inference.generate import GenerationEngine as JEngine
from vila_tpu.ops.awq import awq_quantize_llm as jawq_quantize
from vila_tpu.ops.quant import quantize_llm_params as jquantize
from vila_tpu_torch import entry as tentry
from vila_tpu_torch.eval import quant_acc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 8
ROWS = LIMIT * 48


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_quant_acc", os.path.join(REPO, "scripts", "quant_acc.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def both():
    ds_path = jbench.resolve_dataset(quant_acc.DATASET)
    dataset = jbench.load_dataset(ds_path)[:LIMIT]
    media_root = os.path.dirname(ds_path)

    jeng = jentry.load(quant_acc.PROBE)
    tok = jeng.tokenizer
    calib = np.zeros((LIMIT, 48), np.int32)
    for i, r in enumerate(dataset[:32]):
        ids = tok(r["question"], add_special_tokens=False).input_ids[:48]
        calib[i, :len(ids)] = ids
    llm = jeng.params["llm"]
    jengines = {
        "bf16": jeng,
        "w4_rtn": JEngine({**jeng.params, "llm": jquantize(llm, bits=4, fuse=True,
                                                           cfg=jeng.cfg.llm)}, jeng.cfg, tok),
        "w4_awq": JEngine({**jeng.params, "llm": jawq_quantize(llm, jeng.cfg.llm,
                                                               jnp.asarray(calib),
                                                               sample_rows=ROWS)},
                          jeng.cfg, tok),
    }
    teng = tentry.load(quant_acc.PROBE, device="cpu")
    out, preds, tengines = quant_acc.measure(teng, LIMIT, sample_rows=ROWS)
    return dataset, media_root, calib, jengines, out, preds, tengines


def test_calibration_ids_equal(both):
    dataset, _, calib, _, _, _, tengines = both
    got = quant_acc.calibration_ids(tengines["bf16"].tokenizer, dataset)
    np.testing.assert_array_equal(got.numpy(), calib)


@pytest.mark.parametrize("name", quant_acc.ENGINES)
def test_predictions_and_metrics_equal(both, name):
    dataset, media_root, _, jengines, out, preds, _ = both
    r = jbench.run_benchmark(jengines[name], "pope", dataset, max_new_tokens=4,
                             media_root=media_root)
    assert preds[name] == [row["prediction"] for row in r["results"]]
    want = {k: round(float(v), 4) for k, v in r["metrics"].items()}
    assert {k: v for k, v in out[name].items() if k.startswith("pope/")} == want


@pytest.mark.parametrize("name", quant_acc.ENGINES)
def test_first_token_logits_agree(both, name):
    dataset, media_root, _, jengines, out, _, tengines = both
    script = _jax_script()
    tpreps = quant_acc.prompts(tengines["bf16"], dataset, media_root)
    from PIL import Image

    for r, tp in zip(dataset, tpreps):
        with Image.open(os.path.join(media_root, r["image"])) as img:
            img.load()
            jp = jengines["bf16"].prepare_inputs([img, r["question"] + quant_acc.POPE_SUFFIX])
        np.testing.assert_array_equal(tp["input_ids"], jp["input_ids"])
        want = script.first_token_logits(jengines[name], jp)
        got = quant_acc.first_token_logits(tengines[name], tp)
        tol = 1e-3 if name == "bf16" else 2.0 ** -7 * np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_reported_fidelity_and_deltas(both):
    """The reported numbers are the JAX script's, rounded as it rounds."""
    _, _, _, _, out, _, _ = both
    for name in ("w4_rtn", "w4_awq"):
        assert 0.0 <= out[name]["first_token_top1_agreement"] <= 1.0
        assert out[name]["mean_abs_logit_diff"] > 0.0
    acc = "pope/accuracy"
    assert out["acc_delta_rtn"] == round(out["bf16"][acc] - out["w4_rtn"][acc], 4)
    assert out["acc_delta_awq"] == round(out["bf16"][acc] - out["w4_awq"][acc], 4)
    assert out["n_examples"] == LIMIT and out["probe_meta"]["steps"] == 600


def test_main_writes_only_where_asked(tmp_path, capsys):
    before = set(os.listdir(REPO))
    target = tmp_path / "qa.json"
    assert quant_acc.main(["--limit", "2", "--device", "cpu", "--output", str(target)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert target.exists() and '"n_examples": 2' in printed
    assert set(os.listdir(REPO)) == before
