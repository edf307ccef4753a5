"""Lightweight media handles passed to `generate_content`.

Capability parity: reference llava/media.py:20-34 (`Image`, `Video`, `File`).
"""

from __future__ import annotations

import os


class File:
    def __init__(self, path: str) -> None:
        self.path = path

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.path!r})"


class Image(File):
    """An image prompt part: filesystem path, URL, PIL.Image, or ndarray."""

    def __init__(self, source) -> None:
        if isinstance(source, str):
            super().__init__(source)
        else:
            super().__init__("")
            self.data = source

    @property
    def is_path(self) -> bool:
        return bool(self.path) and (os.path.exists(self.path) or "://" in self.path)


class Video(File):
    """A video prompt part: filesystem path or pre-extracted frame list."""

    def __init__(self, source) -> None:
        if isinstance(source, str):
            super().__init__(source)
        else:
            super().__init__("")
            self.frames = source
