"""vila_tpu_torch — the PyTorch/CUDA port of vila_tpu for NVIDIA Hopper.

The package mirrors `vila_tpu`'s module paths (`vila_tpu/ops/quant.py` ->
`vila_tpu_torch/ops/quant.py`) and keeps its public signatures and layouts
(flat `(L, B, S, Hkv*hd)` KV cache, tiled W4 slots), so the two can be held
against each other on the same inputs. It imports `torch` and never `jax`
or `vila_tpu`; the JAX-free helpers it needs are copies.

Every Pallas kernel on the served path is a hand-written CUDA C++ kernel
for `sm_90a` (`csrc/`), built with `nvcc` at first use. Entry points run on
the card (`device="cuda"`) and raise when CUDA is absent; the CPU is used
only when the caller passes `device="cpu"`, where each kernel wrapper takes
its plain PyTorch version.
"""

__version__ = "0.1.0"

from vila_tpu_torch.media import File, Image, Video  # noqa: F401


def load(model_path: str, **kwargs):
    """`entry.load`: a checkpoint directory -> a ready `GenerationEngine`
    (on the card unless `device="cpu"`)."""
    from vila_tpu_torch.entry import load as _load

    return _load(model_path, **kwargs)
