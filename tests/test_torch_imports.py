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
  card and raise, and a kernel wrapper given a tensor that is not on the
  CPU launches its kernel or raises, never takes its plain version.
"""

import builtins
import dis
import importlib
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


def _imported_by_port(roots):
    """Modules under any of `roots` that importing every module of the
    port loads, in a fresh interpreter."""
    code = (
        "import importlib, json, sys\n"
        f"for name in {_module_names()!r}:\n"
        "    importlib.import_module(name)\n"
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
    """The loader reads and writes safetensors with numpy, and
    `entry.load_tokenizer` imports `transformers` only when called: the
    card's host has neither package."""
    assert _imported_by_port(("safetensors", "transformers")) == "[]"


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
