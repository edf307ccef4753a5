"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled on its own by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. Builds happen at
first use, into `vila_tpu_torch/_build/` (listed in `.gitignore`); the
library name carries a hash of its source, so an edited kernel is never
served from a stale build. `build_all()` starts one `nvcc` per source, all
at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("w4_gemv.cu", "w4_gemm.cu", "decode_attn.cu")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Launch counts of the kernel wrappers: each public wrapper adds one where
# it launches its kernel on the card (K1 w4_matmul_decode, K2
# w4_matmul_prefill, K3 fused_layer), and nowhere else.
LAUNCHES: Dict[str, int] = {"w4_gemv": 0, "w4_gemm": 0, "fused_layer": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _target(src: str) -> Path:
    text = (CSRC / src).read_bytes()
    digest = hashlib.sha1(text).hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def _command(src: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / src),
    ]


def build_all(sources: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns {source: ptxas
    report} for what was built (empty for what was already there)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (tmp, out, subprocess.Popen(
            _command(src, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    reports = {}
    failed = []
    for src, (tmp, out, proc) in procs.items():
        log, _ = proc.communicate()
        reports[src] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {src} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(src: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            out = _target(src)
            if not out.exists():
                build_all([src])
            lib = ctypes.CDLL(str(out))
            _libs[src] = lib
        return lib


def check(status: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if status != 0:
        raise RuntimeError(f"CUDA launch of {name} failed: cudaError {status}")
