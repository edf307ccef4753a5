"""Hygiene of the PyTorch/CUDA port (`vila_tpu_torch`).

* Importing every module of the port loads neither JAX nor the JAX package,
  nor `safetensors` or `transformers`, nor PIL or cv2 (the media modules
  import them when an image must be opened or a video file decoded); the
  media modules (`models/{s2,encoders}`, `utils/{imageproc,media_loader}`)
  are among those walked, and the native resize builds from the port's own
  copy of its C++ source.
* No function body of the port loads an undefined global (the check of
  `tests/test_lint.py`, which walks only `vila_tpu`); a kernel wrapper that
  is never reached on the CPU is checked like everything else.
* Without CUDA nothing falls back to the CPU: entry points default to the
  card and raise (the loader's tower branches too: CLIP, InternViT, RADIO,
  PS3), and a kernel wrapper given a tensor that is not on the CPU launches
  its kernel or raises, never takes its plain version. A PS3 tower refuses
  W8A8 as the JAX package does.
"""

import builtins
import dis
import importlib
import json
import os
import pkgutil
import shutil
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import vila_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _module_names():
    return ["vila_tpu_torch"] + [
        info.name for info in pkgutil.walk_packages(
            vila_tpu_torch.__path__, prefix="vila_tpu_torch.")
    ]


PROBE = os.path.join(REPO, "vila_tpu", "eval", "fixtures", "quant_probe")


def _imported_by_port(roots, then=""):
    """Modules under any of `roots` that importing every module of the
    port loads, in a fresh interpreter, after running the code `then`."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
        + then +
        f"roots = {tuple(roots)!r}\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in roots)))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_port_imports_no_jax_and_no_jax_package():
    assert _imported_by_port(("jax", "jaxlib", "vila_tpu")) == "[]"


def test_port_imports_neither_safetensors_nor_transformers():
    """The loader reads and writes safetensors with numpy and reads
    `tokenizer.json` with the port's own reader: neither importing the port
    nor `entry.load_tokenizer` and `entry.load` of a checkpoint (the
    committed quant probe, on the CPU) loads `safetensors`, `transformers`
    or `tokenizers`; the card's host has none of them."""
    then = ("from vila_tpu_torch import entry\n"
            f"entry.load_tokenizer({PROBE!r})\n"
            f"entry.load({PROBE!r}, device='cpu')\n")
    assert _imported_by_port(("safetensors", "transformers", "tokenizers"), then) == "[]"


def test_port_imports_neither_pil_nor_cv2():
    assert _imported_by_port(("PIL", "cv2")) == "[]"


def test_media_modules_are_walked_and_own_their_native_source():
    names = _module_names()
    for mod in ("models.s2", "models.encoders", "utils.imageproc", "utils.media_loader"):
        assert f"vila_tpu_torch.{mod}" in names
    from vila_tpu_torch.utils import imageproc

    src = imageproc.SOURCE
    assert src.is_file() and src.parent == Path(vila_tpu_torch.__file__).resolve().parent / "native"
    assert imageproc.BUILD_DIR.name == "_build"


def test_tower_modules_are_walked():
    """The other towers' modules are among those the import and globals
    checks walk."""
    names = _module_names()
    for mod in ("models.vit", "models.ps3", "models.siglip", "utils.hf_import"):
        assert f"vila_tpu_torch.{mod}" in names


DECODING_AND_MEDIA = {
    # module: what running it needs, beside importing it
    "vila_tpu_torch.inference.speculative": (
        "from vila_tpu_torch.inference.speculative import draft_tokens, init_history\n"
        "h, n = init_history([5, 6, 7, 5, 6], 7, 16)\n"
        "assert list(draft_tokens(h, n, 7, 6, 2)) == [5, 6]\n"),
    "vila_tpu_torch.inference.constrained": (
        "from vila_tpu_torch.inference.constrained import JsonAutomaton\n"
        "assert JsonAutomaton().run('{\"a\": [1') == 'ok'\n"),
    "vila_tpu_torch.data.dataset": "",
}


@pytest.mark.parametrize("name", sorted(DECODING_AND_MEDIA))
def test_decoding_and_training_media_modules_import_no_jax(name):
    """The decoding options' modules and the training dataset, imported
    (and run) alone in a fresh interpreter, load neither JAX nor the JAX
    package; the constrained module's copy of the grammar is numpy only."""
    code = (f"import importlib, json, sys\nimportlib.import_module({name!r})\n"
            + DECODING_AND_MEDIA[name]
            + "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'vila_tpu', 'torch'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert {m.split(".")[0] for m in loaded} <= {"torch"}
    if name.endswith("constrained"):
        assert loaded == []


TRAINING_MODES = {
    # module: what running it needs, beside importing it
    "vila_tpu_torch.ops.fp8": (
        "import torch\nfrom vila_tpu_torch.ops.fp8 import quantize_grouped\n"
        "q, s = quantize_grouped(torch.ones(2, 130))\nassert q.shape == (2, 2, 128)\n"),
    "vila_tpu_torch.ops.fake_quant": "",
    "vila_tpu_torch.train.fp8_adamw": "",
    "vila_tpu_torch.train.lora": "",
    "vila_tpu_torch.train.dpo": "",
    "vila_tpu_torch.train.rlhf": "",
}


@pytest.mark.parametrize("name", sorted(TRAINING_MODES))
def test_training_mode_modules_are_walked_and_import_no_jax(name):
    """The fp8, QAT, LoRA, DPO and RLHF modules are among those the import
    and globals checks walk, and imported (and run) alone in a fresh
    interpreter they load neither JAX nor the JAX package."""
    assert name in _module_names()
    code = (f"import importlib, json, sys\nimportlib.import_module({name!r})\n"
            + TRAINING_MODES[name]
            + "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'vila_tpu'))))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (25, 100, 40)])
def test_fp8_linear_off_the_cpu_takes_scaled_mm(monkeypatch, m, k, n):
    """Tensors that are not on the CPU take `torch._scaled_mm` (three
    products: forward, dx, dw), never the plain f32 product; the operands
    reach it row-major and column-major, with f32 scales and exact
    accumulation, every dimension zero-padded to a multiple of 16 (the
    second shape) and the results cut back."""
    from vila_tpu_torch.ops import fp8

    calls = []

    def scaled_mm(a, b, scale_a, scale_b, out_dtype, use_fast_accum):
        assert a.shape[1] == b.shape[0] and all(d % 16 == 0 for d in (*a.shape, b.shape[1]))
        calls.append((a.dtype, b.dtype, a.is_contiguous(), b.t().is_contiguous(),
                      scale_a.dtype, out_dtype, use_fast_accum))
        return torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)

    monkeypatch.setattr(torch, "_scaled_mm", scaled_mm)
    x = torch.empty((2, m, k), dtype=torch.bfloat16, device="meta", requires_grad=True)
    w = torch.empty((k, n), dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = fp8.fp8_linear(x, w)
    assert y.shape == (2, m, n) and y.device.type == "meta"
    y.backward(torch.empty_like(y))
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    e4, e5, bf, f32 = fp8.E4M3, fp8.E5M2, torch.bfloat16, torch.float32
    assert calls == [(e4, e4, True, True, f32, bf, False), (e5, e4, True, True, f32, bf, False),
                     (e4, e5, True, True, f32, bf, False)]

def _walk_code(code):
    yield code
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            yield from _walk_code(const)


@pytest.mark.parametrize("name", _module_names())
def test_no_undefined_globals(name):
    mod = importlib.import_module(name)
    with open(mod.__file__) as f:
        tree = compile(f.read(), mod.__file__, "exec")
    namespace = set(vars(mod)) | set(vars(builtins)) | {"__class__", "__annotations__"}
    missing = set()
    for const in tree.co_consts:
        if not isinstance(const, types.CodeType):
            continue
        for code in _walk_code(const):
            stored = {i.argval for i in dis.get_instructions(code)
                      if i.opname in ("STORE_NAME", "DELETE_NAME", "IMPORT_NAME")}
            missing |= {i.argval for i in dis.get_instructions(code)
                        if i.opname in ("LOAD_GLOBAL", "LOAD_NAME")
                        and i.argval not in stored and i.argval not in namespace}
    assert not missing, f"{name}: undefined globals {sorted(missing)}"


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda):
    from vila_tpu_torch.inference.generate import GenerationEngine
    from vila_tpu_torch.models import qwen2
    from vila_tpu_torch.utils import weights

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qwen2.init_cache(qwen2.LLMConfig(num_hidden_layers=1), 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        weights.from_jax_params({"a": torch.zeros(2).numpy()})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine({}, None, None)
    from vila_tpu_torch.train.trainer import TrainArgs, Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(None, {}, [], None, TrainArgs())
    from vila_tpu_torch import entry

    # both raise before they read the (missing) checkpoint
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.load("no-such-checkpoint")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.load_params("no-such-checkpoint", None)


def test_kernel_wrappers_never_fall_back(no_cuda):
    """A tensor off the CPU goes to the kernel launch, which refuses it;
    the plain version is taken for CPU tensors only."""
    from vila_tpu_torch.ops import fused_decode, quant

    w = quant.quantize_w4(0.02 * torch.randn(2, 256, 128))
    packed, scales = w["packed"], w["scales"]
    x_meta = torch.empty((1, 256), dtype=torch.bfloat16, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        quant.w4_matmul_decode(x_meta, packed, scales, layer_index=1)
    with pytest.raises((ValueError, RuntimeError)):
        quant.w4_matmul_prefill(x_meta.expand(40, 256), packed, scales, layer_index=1)
    slot = {"packed": packed, "scales": scales}
    with pytest.raises((ValueError, RuntimeError)):
        fused_decode.fused_layer(
            torch.empty((8, 64), dtype=torch.bfloat16, device="meta"),
            torch.zeros(1, 16), torch.zeros(8, 256, dtype=torch.bfloat16), 0,
            torch.zeros(2, 1, 16, 64), torch.zeros(2, 1, 16, 64),
            slot, slot, slot, slot, torch.ones(2, 256), torch.ones(2, 256),
            hkv=1, hd=64)

    from vila_tpu_torch.ops import flash_attention as fa

    qm = torch.empty((1, 128, 2, 128), dtype=torch.bfloat16, device="meta")
    km = torch.empty((1, 128, 1, 128), dtype=torch.bfloat16, device="meta")
    lse = torch.empty((1, 2, 128), device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        fa.flash_fwd(qm, km, km, causal=True, scale=0.1)
    with pytest.raises((ValueError, RuntimeError)):
        fa.flash_bwd_dq(qm, km, km, qm, lse, lse, causal=True, scale=0.1)
    with pytest.raises((ValueError, RuntimeError)):
        fa.flash_bwd_dkv(qm, km, km, qm, lse, lse, causal=True, scale=0.1)

    class CudaLike:
        device = torch.device("cuda")

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quant.require_cuda(CudaLike())


def test_kernel_build_needs_nvcc(no_cuda, monkeypatch, tmp_path):
    """Kernels are built from `csrc/` at first use; without nvcc the build
    raises instead of leaving a wrapper without its kernel."""
    from vila_tpu_torch.ops import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    for src in _build.SOURCES:
        assert (_build.CSRC / src).exists()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("w4_gemv_sm90.cu")


TOWERS = ("clip", "internvit", "radio", "ps3")


@pytest.mark.parametrize("kind", TOWERS)
def test_tower_loading_defaults_to_cuda(no_cuda, tmp_path, kind):
    """`build_config` of a tower checkpoint picks the card's bf16, and
    `load_params` / `load` (W8A8 or not) default to the card and raise."""
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_tower_load import write_tower_ckpt

    from vila_tpu_torch import entry

    d = write_tower_ckpt(str(tmp_path / kind), kind)
    cfg = entry.build_config(d)
    assert cfg.vision_tower_type == kind and cfg.vision.dtype == "bfloat16"
    for call in (lambda: entry.load_params(d, cfg), lambda: entry.load(d),
                 lambda: entry.load(d, vision_int8=True)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_vision_int8_refuses_ps3_as_jax(tmp_path):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_tower_load import write_tower_ckpt

    from vila_tpu import entry as jentry
    from vila_tpu_torch import entry

    d = write_tower_ckpt(str(tmp_path / "ps3"), "ps3")
    with pytest.raises(ValueError, match="vision_int8 unsupported for tower 'ps3'") as want:
        jentry.load(d, vision_int8=True)
    with pytest.raises(ValueError, match="vision_int8 unsupported for tower 'ps3'") as got:
        entry.load(d, device="cpu", vision_int8=True)
    assert str(got.value) == str(want.value)


# the long-context stack: MM-SP, ZeRO-3, context extension, the sharded
# engine, NIAH, and the gloo tests' worker module (its spawned processes
# must never load JAX)
LONG_CONTEXT_MODULES = (
    "vila_tpu_torch.parallel.distributed", "vila_tpu_torch.parallel.mesh",
    "vila_tpu_torch.parallel.ring_attention", "vila_tpu_torch.parallel.sp",
    "vila_tpu_torch.train.context_extend", "vila_tpu_torch.inference.long_context",
    "vila_tpu_torch.eval.niah", "vila_tpu_torch.eval.niah_cli",
)


@pytest.fixture(scope="module")
def long_context_imports():
    """For each long-context module (and `tests/torch_dist_helpers.py`),
    the JAX and JAX-package modules importing it alone loads, in a fresh
    interpreter."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'tests')!r})\n"
        "out = {}\n"
        f"for name in {LONG_CONTEXT_MODULES + ('torch_dist_helpers',)!r}:\n"
        "    importlib.import_module(name)\n"
        "    out[name] = sorted(m for m in sys.modules\n"
        "                       if m.split('.')[0] in ('jax', 'jaxlib', 'vila_tpu'))\n"
        "print(json.dumps(out))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", LONG_CONTEXT_MODULES + ("torch_dist_helpers",))
def test_long_context_modules_import_no_jax(name, long_context_imports):
    if name != "torch_dist_helpers":
        assert name in _module_names()
    assert long_context_imports[name] == []


def test_tensor_parallel_modules_are_walked():
    """The tensor-parallel slice's module is among those the import checks
    above walk (no `jax`, no `vila_tpu`)."""
    names = _module_names()
    for mod in ("vila_tpu_torch.parallel.tensor_parallel", "vila_tpu_torch.parallel.mesh",
                "vila_tpu_torch.train.fp8_adamw"):
        assert mod in names


# the dataset types, the registries and evaluation: none of them may load
# JAX, the JAX package or PyYAML (the card's host has no PyYAML), at import
# or when the registries are read
DATA_AND_EVAL_MODULES = (
    "vila_tpu_torch.utils.io", "vila_tpu_torch.utils.yaml_lite", "vila_tpu_torch.data.tario",
    "vila_tpu_torch.data.prep", "vila_tpu_torch.data.filters",
    "vila_tpu_torch.data.dataset_impl", "vila_tpu_torch.data.interleaved",
    "vila_tpu_torch.data.builder", "vila_tpu_torch.eval.vqa", "vila_tpu_torch.eval.smoke",
    "vila_tpu_torch.eval.loss_eval", "vila_tpu_torch.eval.lmms",
    "vila_tpu_torch.eval.lmms_tasks", "vila_tpu_torch.eval.lmms_cli",
    "vila_tpu_torch.cli.eval",
)


def test_data_and_eval_modules_load_no_jax_and_no_yaml():
    names = _module_names()
    assert all(name in names for name in DATA_AND_EVAL_MODULES)
    code = (
        "import importlib, json, sys\n"
        f"for name in {DATA_AND_EVAL_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from vila_tpu_torch.data import builder\n"
        "from vila_tpu_torch.cli.eval import load_registry\n"
        "assert len(builder.register_datasets()) == 21 and len(builder.register_mixtures()) == 6\n"
        "assert len(load_registry()) == 96\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'jaxlib', 'vila_tpu', 'yaml'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the last slice: the export, the weight tools and the two CLIs; the remote
# code shipped into an export imports `transformers`, so it is data that the
# walk never reaches (a directory without `__init__.py`)
EXPORT_AND_TOOLS = ("vila_tpu_torch.export", "vila_tpu_torch.export.hf_remote",
                    "vila_tpu_torch.utils.weights_tools", "vila_tpu_torch.cli.run",
                    "vila_tpu_torch.cli.upload")
# JAX files whose twin lives elsewhere in the port: the remote code
TWIN_PATHS = {os.path.join("export", "modeling_vila.py"):
              os.path.join("export", "remote_code", "modeling_vila.py")}


def _package_files(root):
    out = set()
    for d, _, files in os.walk(root):
        if "__pycache__" in d or "_build" in d:
            continue
        out |= {os.path.relpath(os.path.join(d, f), root) for f in files
                if f.endswith((".py", ".yaml", ".cpp"))}
    return out


def test_every_jax_module_has_a_twin_in_the_port():
    jax_files = _package_files(os.path.join(REPO, "vila_tpu"))
    port_files = _package_files(os.path.join(REPO, "vila_tpu_torch"))
    assert sorted(f for f in jax_files if TWIN_PATHS.get(f, f) not in port_files) == []
    import vila_tpu_torch.export.hf_remote as hf_remote

    names = _module_names()
    assert all(name in names for name in EXPORT_AND_TOOLS)
    assert not any("remote_code" in name or "modeling_vila" in name for name in names)
    assert os.path.isfile(hf_remote.REMOTE_CODE)
    assert not os.path.exists(os.path.join(os.path.dirname(hf_remote.REMOTE_CODE),
                                           "__init__.py"))
