"""Minimal OpenAI-compatible client for the server, as
`vila_tpu/serving/client.py` (stdlib only).

Usage:
    python -m vila_tpu_torch.serving.client --url http://localhost:8000 \
        --image photo.jpg "describe this image"
    python -m vila_tpu_torch.serving.client --stream "hello"
"""

from __future__ import annotations

import argparse
import base64
import json
import mimetypes
import sys
import urllib.request
from typing import Any, Dict, Iterator, List, Optional


def file_to_data_url(path: str) -> str:
    mime = mimetypes.guess_type(path)[0] or "application/octet-stream"
    with open(path, "rb") as f:
        return f"data:{mime};base64,{base64.b64encode(f.read()).decode()}"


def build_messages(
    text: str, image: Optional[str] = None, video: Optional[str] = None
) -> List[Dict[str, Any]]:
    content: List[Dict[str, Any]] = []
    if image:
        url = image if image.startswith(("http", "data:")) else file_to_data_url(image)
        content.append({"type": "image_url", "image_url": {"url": url}})
    if video:
        url = video if video.startswith(("http", "data:")) else file_to_data_url(video)
        content.append({"type": "video_url", "video_url": {"url": url}})
    content.append({"type": "text", "text": text})
    return [{"role": "user", "content": content}]


def chat(
    base_url: str,
    messages: List[Dict[str, Any]],
    *,
    model: str = "vila-tpu",
    max_tokens: int = 256,
    temperature: float = 0.0,
    stream: bool = False,
    timeout: float = 600.0,
) -> Iterator[str]:
    """Yields text deltas (one final chunk when stream=False). A stream
    that ends before its `[DONE]` event raises ConnectionError."""
    body = json.dumps({
        "model": model,
        "messages": messages,
        "max_tokens": max_tokens,
        "temperature": temperature,
        "stream": stream,
    }).encode()
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/chat/completions",
        data=body,
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not stream:
            out = json.load(resp)
            yield out["choices"][0]["message"]["content"]
            return
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data:"):
                continue
            payload = line[5:].strip()
            if payload == "[DONE]":
                return
            delta = json.loads(payload)["choices"][0].get("delta", {})
            if "content" in delta:
                yield delta["content"]
    raise ConnectionError("the event stream ended before [DONE]")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("vila_tpu_torch.serving.client")
    ap.add_argument("text")
    ap.add_argument("--url", default="http://localhost:8000")
    ap.add_argument("--image", default=None)
    ap.add_argument("--video", default=None)
    ap.add_argument("--model", default="vila-tpu")
    ap.add_argument("--max-tokens", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--stream", action="store_true")
    a = ap.parse_args(argv)
    for delta in chat(
        a.url, build_messages(a.text, a.image, a.video),
        model=a.model, max_tokens=a.max_tokens,
        temperature=a.temperature, stream=a.stream,
    ):
        sys.stdout.write(delta)
        sys.stdout.flush()
    print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
