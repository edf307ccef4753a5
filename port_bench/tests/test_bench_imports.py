"""What a run imports holds no JAX and no JAX package, compared by whole
top-level names (`vila_tpu_torch` begins with `vila_tpu`); the plain
references hold nothing of the program either. Each import runs in a
fresh interpreter."""

import json
import subprocess
import sys

from port_bench.harness import ROOT

HARNESS = ["port_bench.run", "port_bench.harness", "port_bench.traffic", "port_bench.weights",
           "port_bench.flops", "port_bench.trace", "port_bench.readers", "port_bench.program",
           "port_bench.sweep", "port_bench.control", "port_bench.drivers.serve",
           "port_bench.drivers.train",
           # what the drivers import from the program when they run
           "vila_tpu_torch.inference.generate", "vila_tpu_torch.serving.batcher",
           "vila_tpu_torch.train.step", "vila_tpu_torch.train.optimizer",
           "vila_tpu_torch.data.collate", "vila_tpu_torch.ops.quant", "vila_tpu_torch.models.vlm"]
REFERENCE = ["port_bench.reference.vlm", "port_bench.reference.train", "port_bench.weights",
             "port_bench.tokenizer"]


def tops_after_import(modules):
    code = ("import importlib, json, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_imports_no_jax():
    tops = tops_after_import(HARNESS)
    assert "vila_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "vila_tpu"}


def test_reference_imports_nothing_of_the_program():
    tops = tops_after_import(REFERENCE)
    assert not tops & {"jax", "jaxlib", "flax", "vila_tpu", "vila_tpu_torch"}


def test_the_guard_compares_whole_names():
    from port_bench import harness

    assert "vila_tpu" not in harness.forbidden_modules() or "vila_tpu" in {
        n.split(".")[0] for n in sys.modules}
    sys.modules.setdefault("vila_tpu_torch_probe_only", sys)
    try:
        assert "vila_tpu" not in harness.forbidden_modules() or "vila_tpu" in sys.modules
    finally:
        sys.modules.pop("vila_tpu_torch_probe_only", None)
