"""Device selection shared by the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """`torch.device` for an entry point's `device` argument.

    The default is the card. A CUDA device without CUDA raises: nothing in
    the port quietly falls back to the CPU, which is used only when the
    caller asks for it (`device="cpu"`, as the tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def host_to_device(array, device: torch.device) -> torch.Tensor:
    """A host array (or CPU tensor) on `device`: a copy, but a CPU tensor
    stays itself on the CPU. On the card it goes through pinned memory and
    an asynchronous copy, so the host does not wait for the work already
    queued on the stream."""
    t = array if isinstance(array, torch.Tensor) else torch.tensor(np.asarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
