"""The port's OpenAI-compatible server (`vila_tpu_torch.serving.server`)
over the port's `ContinuousBatcher`, on the CPU with the tiny W4 checkpoint
of `tests/test_torch_batcher.py`, bound to 127.0.0.1 on a free port: the
request and response schema of `tests/test_server.py`, server-sent events
ending in `[DONE]`, and the port's client module."""

import base64
import io
import json
import tempfile
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from test_torch_batcher import tiny_vlm
from vila_tpu_torch.inference import generate as tgen
from vila_tpu_torch.media import Video
from vila_tpu_torch.serving import batcher as tbatcher
from vila_tpu_torch.serving import client as C
from vila_tpu_torch.serving import server as srv
from vila_tpu_torch.utils import weights


@pytest.fixture(scope="module")
def served():
    tok, _, p, tcfg = tiny_vlm()
    engine = tgen.GenerationEngine(weights.from_jax_params(p, cfg=tcfg, device="cpu"),
                                   tcfg, tok, device="cpu")
    batcher = tbatcher.ContinuousBatcher(engine, max_batch=2, max_len=256)
    httpd = srv.make_server(batcher, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}", engine
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.shutdown()
        thread.join(timeout=30)
        assert not thread.is_alive()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _greedy(engine, text, n=4):
    return engine.generate_content(text, tgen.GenerationConfig(max_new_tokens=n))


def test_models_endpoint_and_unknown_paths(served):
    url, _ = served
    with urllib.request.urlopen(url + "/v1/models", timeout=30) as r:
        data = json.loads(r.read())
    assert data["object"] == "list" and data["data"][0]["object"] == "model"
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(url + "/nope", timeout=30)
    assert e.value.code == 404


def test_chat_completion_text(served):
    """A greedy completion (temperature 0) is the serial engine's text."""
    url, engine = served
    body = {"messages": [{"role": "user", "content": "hello"}], "max_tokens": 4,
            "temperature": 0}
    with _post(url + "/v1/chat/completions", body) as r:
        assert r.status == 200
        data = json.loads(r.read())
    assert data["object"] == "chat.completion"
    msg = data["choices"][0]["message"]
    assert msg["role"] == "assistant" and data["choices"][0]["finish_reason"] == "stop"
    assert msg["content"] == _greedy(engine, ["hello"])


def test_streaming_ends_with_done(served):
    url, engine = served
    body = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 4,
            "temperature": 0, "stream": True}
    with _post(url + "/v1/chat/completions", body) as r:
        assert r.status == 200 and r.headers["Content-Type"] == "text/event-stream"
        raw = r.read().decode()
    lines = [ln[len("data: "):] for ln in raw.splitlines() if ln.startswith("data: ")]
    assert lines[-1] == "[DONE]"
    events = [json.loads(ln) for ln in lines[:-1]]
    assert events[-1]["choices"][0]["finish_reason"] == "stop"
    text = "".join(e["choices"][0]["delta"].get("content", "") for e in events)
    assert text.strip() == _greedy(engine, ["hi"])


def test_client_module_blocking_and_streamed(served, monkeypatch, tmp_path):
    """The port's client: blocking and streamed completions give the same
    text; a video part reaches the engine through a temporary file, which
    the server removes, and an undecodable one is answered on the
    reference's black frames."""
    url, engine = served
    msgs = C.build_messages("hello")
    assert msgs == [{"role": "user", "content": [{"type": "text", "text": "hello"}]}]
    blocking = "".join(C.chat(url, msgs, max_tokens=4))
    streamed = "".join(C.chat(url, msgs, max_tokens=4, stream=True))
    assert blocking == streamed.strip() == _greedy(engine, ["hello"])
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got = "".join(C.chat(url, C.build_messages("x", video="data:video/mp4;base64,AAAA"),
                         max_tokens=4))
    black = [np.zeros((720, 720, 3), np.uint8)] * engine.cfg.num_video_frames
    assert got == _greedy(engine, [Video(black), "x"])
    assert not list(tmp_path.iterdir())


def test_video_parts(served, tmp_path):
    """A video file sent as a data URL is decoded (cv2) from the server's
    temporary copy: the answer is the engine's on the file itself."""
    cv2 = pytest.importorskip("cv2")
    url, engine = served
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
    for i in range(10):
        writer.write(np.random.default_rng(i).integers(0, 255, (48, 64, 3), np.uint8))
    writer.release()
    msgs = C.build_messages("what happens?", video=path)
    assert msgs[0]["content"][0]["video_url"]["url"].startswith("data:video/")
    got = "".join(C.chat(url, msgs, max_tokens=4))
    assert got == _greedy(engine, [Video(path), "what happens?"])


def test_image_parts(served, tmp_path):
    """A base64 PNG part and the client's file-to-data-URL path both reach
    the engine as an image (PIL decodes them)."""
    pil = pytest.importorskip("PIL.Image")
    url, engine = served
    pixels = np.random.default_rng(0).integers(0, 255, (48, 48, 3), np.uint8)
    buf = io.BytesIO()
    pil.fromarray(pixels).save(buf, format="PNG")
    data_url = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    body = {"messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": data_url}},
        {"type": "text", "text": "what is this?"}]}], "max_tokens": 4, "temperature": 0}
    with _post(url + "/v1/chat/completions", body) as r:
        got = json.loads(r.read())["choices"][0]["message"]["content"]
    assert got == _greedy(engine, [pil.fromarray(pixels), "what is this?"])

    path = tmp_path / "x.png"
    pil.fromarray(pixels).save(path)
    msgs = C.build_messages("what is this?", image=str(path))
    assert msgs[0]["content"][0]["image_url"]["url"] == data_url
    assert "".join(C.chat(url, msgs, max_tokens=4)) == got
