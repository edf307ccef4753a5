"""Host-side image preprocessing for the plain (resize / pad) image path.

The resize and pad modes of `vila_tpu/data/preprocess.py` (capability
parity: llava/mm_utils.py `process_image`, `expand2square`). The host only
decodes and resizes and emits **uint8 HWC arrays**; rescale+normalize run on
the device inside the vision forward.

PIL is imported lazily, only when an image must be opened or resized: a
uint8 `(H, W, 3)` ndarray that is already `image_size` square goes through
untouched, so the served path runs on hosts without PIL (a PIL resize to
the same size is a copy, so the result is the same).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def _pil():
    from PIL import Image as PILImage

    return PILImage


def expand2square(image, background: Tuple[int, int, int]):
    """Pad to square with the processor mean color (mm_utils.py:499-513)."""
    w, h = image.size
    if w == h:
        return image
    side = max(w, h)
    result = _pil().new(image.mode, (side, side), background)
    result.paste(image, ((side - w) // 2, (side - h) // 2))
    return result


def to_uint8(images: Sequence) -> np.ndarray:
    """PIL images -> (N, H, W, 3) uint8."""
    return np.stack([np.asarray(im.convert("RGB"), dtype=np.uint8) for im in images])


def load_image(source):
    """Open an image from a path, PIL image, ndarray or `media.Image`.

    A uint8 `(H, W, 3)` ndarray is returned as it is (no PIL round trip);
    everything else becomes an RGB PIL image."""
    if isinstance(source, np.ndarray):
        if source.dtype == np.uint8 and source.ndim == 3 and source.shape[2] == 3:
            return source
        return _pil().fromarray(source).convert("RGB")
    if isinstance(source, str):
        return _pil().open(source).convert("RGB")
    from vila_tpu_torch.media import Image as MediaImage

    if isinstance(source, MediaImage):
        if source.path:
            return load_image(source.path)
        return load_image(source.data)
    if hasattr(source, "convert"):  # PIL image
        return source.convert("RGB")
    raise TypeError(f"cannot load image from {type(source)}")


def process_image(
    image,
    *,
    image_size: int,
    image_aspect_ratio: str = "resize",
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5),
) -> Tuple[np.ndarray, Optional[Tuple[int, int]]]:
    """One image -> (tiles uint8 (1, S, S, 3), None), as
    `vila_tpu.data.preprocess.process_image` gives it for resize and pad."""
    if image_aspect_ratio not in ("resize", "pad"):
        raise NotImplementedError(
            f"image_aspect_ratio={image_aspect_ratio!r} is not ported yet"
        )
    image = load_image(image)
    if isinstance(image, np.ndarray):
        if image.shape[:2] == (image_size, image_size):
            return image[None].copy(), None
        image = _pil().fromarray(image)
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in image_mean)
        image = expand2square(image, bg)
    image = image.resize((image_size, image_size))
    return to_uint8([image]), None
