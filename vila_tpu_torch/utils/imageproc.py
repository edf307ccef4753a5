"""Native batched frame resize, as `vila_tpu/utils/imageproc.py`: a ctypes
binding for the port's copy of the C++ resize (`native/imageproc.cpp`).

A video prompt resizes its 64-512 decoded frames on the host; one native
call over the whole stack replaces per-frame PIL round trips. Bicubic with
a = -0.75, edges clamped (cv2 `INTER_CUBIC` semantics).

The library is built with `g++ -O3 -shared -fPIC` at first use into
`vila_tpu_torch/_build/` (git-ignored; the name carries the source's hash).
There is no PIL fallback: PIL's bicubic gives other pixels, so a host that
cannot build the library raises rather than serve different frames. Frames
are uint8 arrays or PIL images, so hosts without PIL resize arrays.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "imageproc.cpp"
BUILD_DIR = _PKG / "_build"
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _target() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libimageproc_{digest}.so"


def _load_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises if g++ fails."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        so = _target()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            try:
                proc = subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                    capture_output=True, text=True)
            except OSError as e:
                raise RuntimeError(f"cannot build {SOURCE.name}: g++ not found ({e})") from e
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.resize_batch_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.resize_batch_u8.restype = None
        _LIB = lib
        return lib


def resize_frames(frames: np.ndarray, size: int) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, size, size, 3) uint8, bicubic; frames that
    are already `size` square come back as they are."""
    if frames.ndim != 4 or frames.shape[-1] != 3 or frames.dtype != np.uint8:
        raise ValueError(f"resize_frames takes (N, H, W, 3) uint8, not {frames.shape} "
                         f"{frames.dtype}")
    if size < 1 or min(frames.shape[:3]) < 1:
        raise ValueError(f"cannot resize {frames.shape} to {size}")
    n, h, w, _ = frames.shape
    if h == size and w == size:
        return frames
    lib = _load_lib()
    src = np.ascontiguousarray(frames)
    dst = np.empty((n, size, size, 3), np.uint8)
    lib.resize_batch_u8(
        src.ctypes.data_as(ctypes.c_void_p), n, h, w,
        dst.ctypes.data_as(ctypes.c_void_p), size, size,
    )
    return dst


def _rgb_array(frame) -> np.ndarray:
    if isinstance(frame, np.ndarray):
        if frame.dtype == np.uint8 and frame.ndim == 3 and frame.shape[2] == 3:
            return frame
        from PIL import Image as PILImage

        frame = PILImage.fromarray(frame)
    return np.asarray(frame.convert("RGB"))


def resize_pil_batch(frames: List, size: int) -> np.ndarray:
    """Frames (PIL images or uint8 (H, W, 3) arrays, mixed sizes allowed)
    -> (N, size, size, 3). Same-shaped frames go through one native call;
    the others are resized by shape."""
    arrs = [_rgb_array(f) for f in frames]
    out = np.empty((len(arrs), size, size, 3), np.uint8)
    by_shape: dict = {}
    for i, a in enumerate(arrs):
        by_shape.setdefault(a.shape, []).append(i)
    for idxs in by_shape.values():
        resized = resize_frames(np.stack([arrs[i] for i in idxs]), size)
        for j, i in enumerate(idxs):
            out[i] = resized[j]
    return out

