"""Host-side image preprocessing: resize, pad, dynamic tiling, as
`vila_tpu/data/preprocess.py` (capability parity: llava/mm_utils.py
`find_closest_aspect_ratio` (:283), `dynamic_preprocess` (:299),
`dynamic_s2_preprocess` (:341), `process_image` (:442-522),
`expand2square`). The host only decodes, resizes and tiles and emits
**uint8 HWC arrays**; rescale+normalize run on the device inside the
vision forward. The resizes are PIL's, called in the JAX module's order, so
the tiles are equal byte for byte.

PIL is imported lazily, only when an image must be opened or resized: a
uint8 `(H, W, 3)` ndarray that is already `image_size` square goes through
untouched in the resize and pad modes, so the served path runs on hosts
without PIL (a PIL resize to the same size is a copy, so the result is the
same).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np


def _pil():
    from PIL import Image as PILImage

    return PILImage


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target_ar = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target_ar)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def _candidate_ratios(min_num: int, max_num: int) -> List[Tuple[int, int]]:
    ratios = {
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    }
    return sorted(ratios, key=lambda x: x[0] * x[1])


def _grid_tiles(resized, tile: int) -> List:
    """Split a resized PIL image into tile x tile crops, row-major."""
    w, h = resized.size
    cols = w // tile
    out = []
    for i in range((w // tile) * (h // tile)):
        box = (
            (i % cols) * tile,
            (i // cols) * tile,
            (i % cols + 1) * tile,
            (i // cols + 1) * tile,
        )
        out.append(resized.crop(box))
    return out


def dynamic_tile(image, min_num: int = 1, max_num: int = 12, image_size: int = 448,
                 use_thumbnail: bool = True) -> List:
    """InternVL-style closest-aspect-ratio tiling + thumbnail (mm_utils.py:299)."""
    ow, oh = image.size
    ratios = _candidate_ratios(min_num, max_num)
    ar = find_closest_aspect_ratio(ow / oh, ratios, ow, oh, image_size)
    resized = image.resize((image_size * ar[0], image_size * ar[1]))
    tiles = _grid_tiles(resized, image_size)
    if use_thumbnail and len(tiles) != 1:
        tiles.append(image.resize((image_size, image_size)))
    return tiles


def dynamic_s2_tile(image, s2_scales: Sequence[int] = (448, 896, 1344), max_num: int = 12,
                    image_size: int = 448) -> Tuple[List, Tuple[int, int]]:
    """NVILA dynamic-S2 tiling (mm_utils.py:341-405): fixed square tiles for
    all but the last scale, aspect-ratio tiles for the last scale. Returns
    (tiles, block_size=(rows, cols)) for the last scale."""
    ow, oh = image.size
    min_num = (s2_scales[-1] // s2_scales[0]) ** 2

    tiles: List = []
    for scale in s2_scales[:-1]:
        n = scale // s2_scales[0]
        resized = image.resize((image_size * n, image_size * n))
        tiles.extend(_grid_tiles(resized, image_size))

    ratios = _candidate_ratios(min_num, max_num)
    ar = find_closest_aspect_ratio(ow / oh, ratios, ow, oh, image_size)
    resized = image.resize((image_size * ar[0], image_size * ar[1]))
    tiles.extend(_grid_tiles(resized, image_size))
    return tiles, (ar[1], ar[0])


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
    min_tiles: int = 1,
    max_tiles: int = 12,
    s2_scales: Sequence[int] = (448, 896, 1344),
    image_mean: Tuple[float, float, float] = (0.5, 0.5, 0.5),
) -> Tuple[np.ndarray, Optional[Tuple[int, int]]]:
    """One image -> (tiles uint8 (N, S, S, 3), block_size or None), as
    `vila_tpu.data.preprocess.process_image` (mm_utils.py:442-522): the
    dynamic_s2, dynamic and longest_edge modes tile or pad as there, pad
    pads to a square, every other mode resizes."""
    image = load_image(image)
    if isinstance(image, np.ndarray):
        if (image_aspect_ratio not in ("dynamic_s2", "dynamic", "longest_edge")
                and image.shape[:2] == (image_size, image_size)):
            return image[None].copy(), None
        image = _pil().fromarray(image)
    if image_aspect_ratio == "dynamic_s2":
        tiles, block_size = dynamic_s2_tile(
            image, s2_scales=s2_scales, max_num=max_tiles, image_size=image_size)
        return to_uint8(tiles), block_size
    if image_aspect_ratio == "dynamic":
        tiles = dynamic_tile(image, min_num=min_tiles, max_num=max_tiles,
                             image_size=image_size)
        return to_uint8(tiles), None
    if image_aspect_ratio == "longest_edge":
        # RADIO-style processor (image_processor.py:219 `_get_preprocess_shape`
        # + `pad_image`): the longest edge to image_size, aspect kept, padded
        # bottom-right to the square
        w, h = image.size
        scale = image_size / max(w, h)
        nw = max(int(w * scale + 0.5), 1)
        nh = max(int(h * scale + 0.5), 1)
        image = image.resize((nw, nh))
        canvas = np.zeros((image_size, image_size, 3), np.uint8)
        canvas[:nh, :nw] = np.asarray(image.convert("RGB"))
        return canvas[None], None
    if image_aspect_ratio == "pad":
        bg = tuple(int(x * 255) for x in image_mean)
        image = expand2square(image, bg)
    image = image.resize((image_size, image_size))
    return to_uint8([image]), None
