"""Video frame loading, as `vila_tpu/utils/media_loader.py`: uniform or
fps-capped sampling (capability parity: `_load_video`,
llava/utils/media.py:39-83, and the frame samplers of
llava/mm_utils.py:35-203).

A `Video` is a pre-extracted frame list, a directory of frame images, or a
file decoded with cv2 when cv2 is importable. Frames are uint8 `(H, W, 3)`
arrays (a frame list's arrays pass as they are) or PIL images (read from a
directory or decoded from a file); `utils.imageproc.resize_pil_batch`
takes both. A video that cannot be read gives black frames, as the
reference does (mm_utils.py:42-54).
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np

from vila_tpu_torch.data.preprocess import load_image
from vila_tpu_torch.media import Video

# the reference's black frame on a decode failure (720 x 720 RGB)
BLACK_FRAME = (720, 720, 3)


def _load_from_dir(path: str, num_frames: int) -> List:
    from PIL import Image as PILImage

    frame_paths = sorted(glob.glob(os.path.join(path, "*")))
    if not frame_paths:
        raise ValueError(f"no frames in directory {path}")
    indices = np.round(np.linspace(0, len(frame_paths) - 1, num_frames)).astype(int)
    return [PILImage.open(frame_paths[i]).convert("RGB") for i in indices]


def _load_from_file(path: str, num_frames: int, fps: float) -> List:
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            "cv2 is required to decode video files; pass a frame directory "
            "or a pre-extracted frame list instead") from e

    vidcap = cv2.VideoCapture(path)
    video_fps = vidcap.get(cv2.CAP_PROP_FPS)
    frame_count = int(vidcap.get(cv2.CAP_PROP_FRAME_COUNT))
    # the last readable frame: counts can overestimate (utils/media.py:51-58)
    while frame_count > 0:
        vidcap.set(cv2.CAP_PROP_POS_FRAMES, frame_count - 1)
        if vidcap.grab():
            break
        frame_count -= 1
    if frame_count <= 0:
        raise ValueError(f"video '{path}' has no frames")

    duration = frame_count / video_fps if video_fps > 0 else 0.0
    if fps > 0:
        timestamps = np.arange(0, duration, 1.0 / fps)[:num_frames]
        indices = [int(t * video_fps) for t in timestamps]
    else:
        indices = np.round(np.linspace(0, frame_count - 1, num_frames)).astype(int)

    frames = {}
    for index in indices:
        if index in frames:
            continue
        vidcap.set(cv2.CAP_PROP_POS_FRAMES, int(index))
        ok, frame = vidcap.read()
        if not ok:
            continue
        frames[index] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
    return [frames[i] for i in indices if i in frames]


def load_video_frames(video, num_frames: int, fps: float = 0.0) -> List:
    """A `Video` (or a path) -> `num_frames` frames sampled uniformly (or
    at `fps` from a file); black frames where the video cannot be read."""
    if isinstance(video, Video) and not video.path:
        frames = video.frames
        indices = np.round(np.linspace(0, len(frames) - 1, num_frames)).astype(int)
        return [load_image(frames[i]) for i in indices]

    path = video.path if isinstance(video, Video) else video
    try:
        if os.path.isdir(path):
            return _load_from_dir(path, num_frames)
        return _load_from_file(path, num_frames, fps)
    except Exception:
        return [np.zeros(BLACK_FRAME, np.uint8)] * num_frames
