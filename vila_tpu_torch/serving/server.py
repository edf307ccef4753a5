"""OpenAI-compatible chat server, as `vila_tpu/serving/server.py`.

`/v1/models` and `/v1/chat/completions` (JSON, or chunked server-sent
events with `"stream": true`) on the Python stdlib (`http.server`), with
the reference's request and response schema. The engine is a
`GenerationEngine` or a `serving.batcher.ContinuousBatcher`; `make_server`
binds one to a server object, so a process may run several.

Image parts arrive as data URLs (decoded with PIL, imported only when an
image part arrives) or as paths and URLs for the engine to open. Video
parts are paths, or data URLs that are written to a temporary file for the
engine to decode (removed when the request ends); a 64-frame TSP video
needs a cache of 8192 rows (`--max-len 8192` under batching).

    python -m vila_tpu_torch.serving.server --model-path ckpt/ --port 8000 \
        [--max-batch 8] [--device cuda]

loads the checkpoint (`entry.load`) and serves it, through a
`ContinuousBatcher` when `--max-batch` > 0.
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import tempfile
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List

from vila_tpu_torch.inference.generate import GenerationConfig
from vila_tpu_torch.media import Image as MediaImage
from vila_tpu_torch.media import Video as MediaVideo

MODEL_NAME = "vila-tpu"


def _load_image_part(url: str):
    if url.startswith("data:"):
        from PIL import Image as PILImage

        _, payload = url.split(",", 1)
        data = base64.b64decode(payload)
        return MediaImage(PILImage.open(io.BytesIO(data)).convert("RGB"))
    return MediaImage(url)


def _load_video_part(url: str, temp_files: List[str]):
    """A video part: a path or URL as it is; a data URL's bytes go to a
    temporary file, whose path is added to `temp_files`."""
    if url.startswith("data:"):
        _, payload = url.split(",", 1)
        with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
            f.write(base64.b64decode(payload))
        temp_files.append(f.name)
        return MediaVideo(f.name)
    return MediaVideo(url)


def parse_messages(messages: List[Dict[str, Any]], temp_files=None) -> List[Any]:
    """OpenAI messages -> prompt part list (server.py:171-240); the
    temporary files of data-URL videos are listed in `temp_files`."""
    temp_files = [] if temp_files is None else temp_files
    prompt: List[Any] = []
    for message in messages:
        content = message.get("content")
        if isinstance(content, str):
            prompt.append(content)
            continue
        for part in content or []:
            ptype = part.get("type")
            if ptype == "text":
                prompt.append(part["text"])
            elif ptype == "image_url":
                prompt.append(_load_image_part(part["image_url"]["url"]))
            elif ptype == "video_url":
                prompt.append(_load_video_part(part["video_url"]["url"], temp_files))
            else:
                raise ValueError(f"unsupported content part: {ptype}")
    return prompt


def _gen_config(body: Dict[str, Any]) -> GenerationConfig:
    temperature = float(body.get("temperature", 1.0) or 0.0)
    return GenerationConfig(
        max_new_tokens=int(
            body.get("max_tokens") or body.get("max_completion_tokens") or 256
        ),
        do_sample=temperature > 0 and body.get("do_sample", True),
        temperature=max(temperature, 1e-4),
        top_p=float(body.get("top_p", 1.0) or 1.0),
        seed=int(body.get("seed") or 0),
        response_format=body.get("response_format"),
    )


class Handler(BaseHTTPRequestHandler):
    """Request handler; `make_server` subclasses it with `engine` set."""

    protocol_version = "HTTP/1.1"
    engine = None

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, obj: Dict[str, Any]) -> None:
        payload = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def _chunk(self, data: bytes) -> None:
        self.wfile.write(hex(len(data))[2:].encode() + b"\r\n" + data + b"\r\n")
        self.wfile.flush()

    def do_GET(self):
        if self.path in ("/health", "/v1/models", "/models"):
            self._json(
                200,
                {"object": "list", "data": [{"id": MODEL_NAME, "object": "model"}]},
            )
        else:
            self._json(404, {"error": "not found"})

    def _stream(self, rid: str, prompt, gc: GenerationConfig) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        def event(delta, finish):
            obj = {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": int(time.time()),
                "model": MODEL_NAME,
                "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
            }
            self._chunk(f"data: {json.dumps(obj)}\n\n".encode())

        for delta in self.engine.generate_content_stream(prompt, gc):
            event({"content": delta}, None)
        event({}, "stop")
        self._chunk(b"data: [DONE]\n\n")
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    def do_POST(self):
        if self.path not in ("/chat/completions", "/v1/chat/completions"):
            self._json(404, {"error": "not found"})
            return
        temp_files: List[str] = []
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            prompt = parse_messages(body.get("messages", []), temp_files)
            gc = _gen_config(body)
            rid = f"chatcmpl-{uuid.uuid4().hex[:12]}"
            if body.get("stream"):
                self._stream(rid, prompt, gc)
                return
            text = self.engine.generate_content(prompt, gc)
            self._json(200, {
                "id": rid,
                "object": "chat.completion",
                "created": int(time.time()),
                "model": body.get("model", MODEL_NAME),
                "choices": [{
                    "index": 0,
                    "message": {"role": "assistant", "content": text},
                    "finish_reason": "stop",
                }],
            })
        except Exception as e:  # noqa: BLE001 - the server keeps serving
            self._json(500, {"error": f"{type(e).__name__}: {e}"})
        finally:
            for path in temp_files:
                os.unlink(path)


def make_server(engine, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
    """A threading HTTP server bound to `engine` (port 0 picks a free
    port: read it from `server_address`); the caller runs `serve_forever`
    and `shutdown`."""
    handler = type("BoundHandler", (Handler,), {"engine": engine})
    return ThreadingHTTPServer((host, port), handler)


def serve(engine, host: str = "0.0.0.0", port: int = 8000) -> None:
    server = make_server(engine, host, port)
    print(f"vila_tpu_torch server listening on {host}:{server.server_address[1]}")
    server.serve_forever()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vila-torch-serve")
    p.add_argument("--model-path", required=True)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=0,
                   help="continuous batching with this many decode slots "
                        "(0 = bs=1 serial serving)")
    p.add_argument("--max-len", type=int, default=2048,
                   help="per-request context cap under batching (8192 for a "
                        "64-frame TSP video)")
    p.add_argument("--device", default="cuda", help="cuda, or cpu for the plain versions")
    return p


def load_server(argv=None) -> ThreadingHTTPServer:
    """The bound, not yet serving, server of a command line: the loaded
    engine (`entry.load`), behind a `ContinuousBatcher` when `--max-batch`
    > 0. The caller runs `serve_forever`, then `close_server`."""
    from vila_tpu_torch import entry

    args = build_parser().parse_args(argv)
    engine = entry.load(args.model_path, device=args.device)
    if args.max_batch > 0:
        from vila_tpu_torch.serving.batcher import ContinuousBatcher

        engine = ContinuousBatcher(engine, max_batch=args.max_batch, max_len=args.max_len)
    return make_server(engine, args.host, args.port)


def close_server(server: ThreadingHTTPServer) -> None:
    """Release the socket and stop the batcher's worker, if any."""
    server.server_close()
    shutdown = getattr(server.RequestHandlerClass.engine, "shutdown", None)
    if shutdown is not None:
        shutdown()


def main(argv=None) -> int:
    server = load_server(argv)
    host, port = server.server_address[:2]
    print(f"vila_tpu_torch server listening on {host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        close_server(server)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
