"""Build and load the port's CUDA kernels (`csrc/*.cu`).

Each source is compiled on its own by `nvcc` for `sm_90a` into a shared
library with a plain C interface, loaded with `ctypes`. Builds happen at
first use, into `vila_tpu_torch/_build/` (listed in `.gitignore`); the
library name carries a hash of its source and of the shared header
`sm90_common.cuh`, so an edited kernel is never served from a stale build.
`build_all()` starts one `nvcc` per source, all at once. Nothing links
against libcuda: the Hopper sources take `cuTensorMapEncodeTiled` (TMA
descriptors) with `dlsym` from the `libcuda.so.1` the process already
holds (`sm90_common.cuh`, which also holds the mbarrier, TMA and wgmma
helpers; `w4_common.cuh` holds the W4 prologue and int8 fragments the GEMV
kernels share, `w4_persist.cuh` the grid barrier, ring and group product of
the persistent W4 kernels K1, K3 and K4/K5).
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
SOURCES = ("w4_gemv_sm90.cu", "w4_gemv_mma.cu", "w4_gemm_sm90.cu", "decode_layer_sm90.cu",
           "w4_pair_sm90.cu", "decode_attn.cu", "flash_attn_sm90.cu", "ce_rows_sm90.cu")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# Launch counts of the kernel wrappers: each public wrapper adds one
# (`count`) where it launches its kernel on the card (K1 w4_matmul_decode,
# K2 w4_matmul_prefill, K3 fused_layer, K4 fused_o_gateup, K5
# fused_down_qkv, K6 fused_layer_batched, K7 flash_fwd, K8 flash_bwd_dq,
# K9 flash_bwd_dkv; the LM head's cross-entropy rows, ce_rows; and K2's
# products alone, bf16_matmul_dots, on no path), and nowhere else. The serving loop and its admission
# thread both launch, hence the lock.
LAUNCHES: Dict[str, int] = {
    "w4_gemv": 0, "w4_gemm": 0, "w4_gemm_dots": 0, "fused_layer": 0,
    "fused_o_gateup": 0, "fused_down_qkv": 0, "fused_layer_batched": 0,
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "ce_rows": 0,
}
_count_lock = threading.Lock()


def count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
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
    h = hashlib.sha1((CSRC / src).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):  # what the sources include
        h.update(header.read_bytes())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"lib{Path(src).stem}_{digest}.so"


def _command(src: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(out), str(CSRC / src), "-ldl",
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
