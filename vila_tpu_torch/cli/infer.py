"""`vila-infer`, as `vila_tpu/cli/infer.py`: load a checkpoint, answer one
prompt of images and text, print the answer.

    python -m vila_tpu_torch.cli.infer --model-path ckpt/ --media photo.jpg \\
        --text "Describe the image." [--vision-int8] [--stream] [--device cuda]

Media types are told apart by extension; video, JSON-constrained output and
time-token decoding (`--json-mode`, `--json-schema`, `--video-duration`)
are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import os

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def sniff_media(path: str):
    from vila_tpu_torch.media import Image

    ext = os.path.splitext(path)[1].lower()
    if ext in IMAGE_EXTS:
        return Image(path)
    if ext in VIDEO_EXTS or os.path.isdir(path):
        raise NotImplementedError(f"video media ({path!r}) is not ported yet")
    raise ValueError(f"cannot infer media type of '{path}'")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vila-torch-infer")
    p.add_argument("--model-path", "-m", required=True)
    p.add_argument("--conv-mode", "-c", default=None)
    p.add_argument("--text", "-t", default=None)
    p.add_argument("--media", "-i", nargs="+", default=[])
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--json-mode", action="store_true", help="not ported yet")
    p.add_argument("--json-schema", default=None, help="not ported yet")
    p.add_argument("--video-duration", type=float, default=0.0, help="not ported yet")
    p.add_argument("--vision-int8", action="store_true",
                   help="deploy the vision tower W8A8 (TinyChat's vision recipe)")
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for flag, value in (("--json-mode", args.json_mode), ("--json-schema", args.json_schema),
                        ("--video-duration", args.video_duration)):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet")

    from vila_tpu_torch import conversation as conv_lib
    from vila_tpu_torch import entry
    from vila_tpu_torch.inference.generate import GenerationConfig

    prompt = [sniff_media(p) for p in args.media]
    if args.text:
        prompt.append(args.text)
    engine = entry.load(args.model_path, device=args.device, vision_int8=args.vision_int8)
    if args.conv_mode:
        conv_lib.default_conversation = conv_lib.conv_templates[args.conv_mode]

    gc = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=args.temperature > 0,
        temperature=max(args.temperature, 1e-4),
        top_p=args.top_p,
    )
    if args.stream:
        for delta in engine.generate_content_stream(prompt, gc):
            print(delta, end="", flush=True)
        print()
    else:
        print(engine.generate_content(prompt, gc))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
