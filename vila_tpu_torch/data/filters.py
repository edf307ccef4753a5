"""Dataset filtering utilities, as `vila_tpu/data/filters.py`.

Capability parity: `llava/train/short_video_filter.py` — drop video records
whose file is missing or too small (a hardcoded one-off script in the
reference; a reusable CLI here).

Usage:
    python -m vila_tpu_torch.data.filters --input train.json --output out.json \
        --video-dir /data/videos [--min-bytes 102400] [--min-frames 8]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, List, Optional


def video_path_for(record: Dict[str, Any], video_dir: str) -> str:
    """The reference's path convention: `video` field, else `<id>.mp4`."""
    if "video" in record:
        return os.path.join(video_dir, record["video"])
    return os.path.join(video_dir, str(record.get("id", "")) + ".mp4")


def filter_videos(
    records: List[Dict[str, Any]],
    video_dir: str,
    *,
    min_bytes: int = 100 * 1024,
    min_frames: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Keep records whose video exists, is at least `min_bytes`, and (when
    `min_frames` is set and cv2 is importable) has at least that many
    frames."""
    out = []
    for rec in records:
        path = video_path_for(rec, video_dir)
        if not os.path.isfile(path) or os.path.getsize(path) < min_bytes:
            continue
        if min_frames:
            try:
                import cv2

                cap = cv2.VideoCapture(path)
                n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
                cap.release()
                if n < min_frames:
                    continue
            except ImportError:
                pass  # size gate only
        out.append(rec)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vila_tpu_torch.data.filters")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--video-dir", required=True)
    p.add_argument("--min-bytes", type=int, default=100 * 1024)
    p.add_argument("--min-frames", type=int, default=None)
    args = p.parse_args(argv)

    with open(args.input) as f:
        records = json.load(f)
    kept = filter_videos(
        records, args.video_dir,
        min_bytes=args.min_bytes, min_frames=args.min_frames,
    )
    with open(args.output, "w") as f:
        json.dump(kept, f)
    print(f"kept {len(kept)}/{len(records)} records")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
