"""`vila-infer`, as `vila_tpu/cli/infer.py`: load a checkpoint, answer one
prompt of images, videos and text, print the answer.

    python -m vila_tpu_torch.cli.infer --model-path ckpt/ --media clip.mp4 \\
        --text "Describe the video." [--video-duration 12.5] [--vision-int8] \\
        [--stream] [--json-mode | --json-schema schema.json] [--device cuda]

Media types are told apart by extension (a directory is a video of frame
images). With `--video-duration`, trained time tokens `<tN>` in the answer
become timestamps (`decode_time_token`). `--json-mode` constrains the
answer to valid JSON and `--json-schema` to a JSON-schema file's object
(`response_format`); `--stream` is ignored when either is given, as in the
JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import re


def decode_time_token(text: str, *, duration: float, num_time_tokens: int,
                      time_token_format: str = "<t{t}>") -> str:
    """Replace trained time tokens with `<seconds>` timestamps
    (llava/cli/infer.py:31); out-of-range tokens clamp to the end."""
    for t in range(num_time_tokens):
        token = time_token_format.format(t=t)
        ts = round(t * duration / max(num_time_tokens - 1, 1), 2)
        text = text.replace(token, f"<{ts}>")
    for match in re.findall(r"<t(\d+)>", text):
        if int(match) >= num_time_tokens:
            text = text.replace(f"<t{match}>", f"<{round(duration, 2)}>")
    return text


IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".gif")
VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def sniff_media(path: str):
    from vila_tpu_torch.media import Image, Video

    ext = os.path.splitext(path)[1].lower()
    if ext in IMAGE_EXTS:
        return Image(path)
    if ext in VIDEO_EXTS or os.path.isdir(path):
        return Video(path)
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
    p.add_argument("--json-mode", action="store_true", help="constrain output to valid JSON")
    p.add_argument("--json-schema", default=None,
                   help="path to a JSON-schema file for structured output")
    p.add_argument("--video-duration", type=float, default=0.0,
                   help="decode <tN> time tokens against this duration (seconds)")
    p.add_argument("--num-time-tokens", type=int, default=100)
    p.add_argument("--vision-int8", action="store_true",
                   help="deploy the vision tower W8A8 (TinyChat's vision recipe)")
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vila_tpu_torch import conversation as conv_lib
    from vila_tpu_torch import entry
    from vila_tpu_torch.inference.generate import GenerationConfig

    prompt = [sniff_media(p) for p in args.media]
    if args.text:
        prompt.append(args.text)
    engine = entry.load(args.model_path, device=args.device, vision_int8=args.vision_int8)
    if args.conv_mode:
        conv_lib.default_conversation = conv_lib.conv_templates[args.conv_mode]

    response_format = None
    if args.json_schema:
        with open(args.json_schema) as f:
            response_format = {"type": "json_schema", "json_schema": json.load(f)}
    elif args.json_mode:
        response_format = {"type": "json_object"}
    gc = GenerationConfig(
        max_new_tokens=args.max_new_tokens,
        do_sample=args.temperature > 0,
        temperature=max(args.temperature, 1e-4),
        top_p=args.top_p,
        response_format=response_format,
    )
    if args.stream and response_format is None:
        for delta in engine.generate_content_stream(prompt, gc):
            print(delta, end="", flush=True)
        print()
    else:
        out = engine.generate_content(prompt, gc)
        if args.video_duration > 0:
            out = decode_time_token(out, duration=args.video_duration,
                                    num_time_tokens=args.num_time_tokens)
        print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
