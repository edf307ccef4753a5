"""The port's three command lines on the CPU (`--device cpu`), over the tiny
checkpoint `helpers.save_tiny_checkpoint(seed=0, **FLAVORS["base"])`:

* `serving.server.main` bound to 127.0.0.1 on port 0 answers one chat
  request with the loaded engine's own greedy text, serially
  (`--max-batch 0`) and through the continuous batcher (`--max-batch 2`);
* `cli.infer.main` prints the text of `generate_content` for an image file
  and a question, and for a video file or frame directory (with time
  tokens decoded against `--video-duration`), and refuses what is not
  ported yet;
* `cli.train.main` runs 2 steps of `dummy_mix` from the checkpoint and
  writes a checkpoint.
"""

import json
import os
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import helpers  # noqa: E402
from gen_goldens import FLAVORS  # noqa: E402
from vila_tpu_torch import entry  # noqa: E402
from vila_tpu_torch.cli import infer  # noqa: E402
from vila_tpu_torch.cli import train as train_cli  # noqa: E402
from vila_tpu_torch.inference.generate import GenerationConfig  # noqa: E402
from vila_tpu_torch.media import Image, Video  # noqa: E402
from vila_tpu_torch.serving import server  # noqa: E402
from vila_tpu_torch.train.checkpoint import CheckpointManager  # noqa: E402

NEW_TOKENS = 4


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli") / "base")
    helpers.save_tiny_checkpoint(d, seed=0, **FLAVORS["base"])
    return d


@pytest.fixture(scope="module")
def engine(ckpt):
    return entry.load(ckpt, device="cpu")


def _greedy(engine, prompt):
    return engine.generate_content(prompt, GenerationConfig(max_new_tokens=NEW_TOKENS))


@pytest.mark.parametrize("max_batch", [0, 2])
def test_server_main_answers_with_the_engines_text(ckpt, engine, monkeypatch, max_batch):
    bound = []
    real = server.load_server
    monkeypatch.setattr(server, "load_server",
                        lambda argv: bound.append(real(argv)) or bound[-1])
    argv = ["--model-path", ckpt, "--host", "127.0.0.1", "--port", "0",
            "--max-batch", str(max_batch), "--device", "cpu"]
    rc = []
    thread = threading.Thread(target=lambda: rc.append(server.main(argv)), daemon=True)
    thread.start()
    deadline = time.time() + 120
    while not bound and time.time() < deadline and thread.is_alive():
        time.sleep(0.05)
    assert bound, "the server did not come up"
    httpd = bound[0]
    try:
        body = {"messages": [{"role": "user", "content": "hello there"}],
                "max_tokens": NEW_TOKENS, "temperature": 0}
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/v1/chat/completions",
            data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            data = json.loads(r.read())
    finally:
        httpd.shutdown()
        thread.join(timeout=60)
    assert not thread.is_alive() and rc == [0]
    served = httpd.RequestHandlerClass.engine
    assert (type(served).__name__ == "ContinuousBatcher") == (max_batch > 0)
    assert data["choices"][0]["message"]["content"] == _greedy(engine, ["hello there"])


def test_infer_main_prints_generate_content(ckpt, engine, tmp_path, capsys):
    from PIL import Image as PILImage

    path = str(tmp_path / "photo.png")
    PILImage.fromarray(np.random.default_rng(5).integers(
        0, 256, (40, 60, 3), dtype=np.uint8)).save(path)
    rc = infer.main(["--model-path", ckpt, "--media", path, "--text", "What is it?",
                     "--max-new-tokens", str(NEW_TOKENS), "--device", "cpu"])
    assert rc == 0
    want = _greedy(engine, [Image(path), "What is it?"])
    assert capsys.readouterr().out == want + "\n"


@pytest.mark.parametrize("extra", [["--json-mode"], ["--json-schema", "schema.json"]])
def test_infer_refuses_what_is_not_ported(ckpt, extra):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        infer.main(["--model-path", ckpt, "--text", "hi", "--device", "cpu", *extra])


@pytest.mark.parametrize("as_dir", [False, True])
def test_infer_main_takes_video_media(ckpt, engine, tmp_path, capsys, as_dir):
    """A video by extension (decoded with cv2) or a directory of frames is
    a `Video`; the printed text is `generate_content`'s."""
    frames = [np.random.default_rng(i).integers(0, 256, (48, 64, 3), dtype=np.uint8)
              for i in range(6)]
    if as_dir:
        from PIL import Image as PILImage

        path = str(tmp_path / "frames")
        os.makedirs(path)
        for i, f in enumerate(frames):
            PILImage.fromarray(f).save(os.path.join(path, f"{i:02d}.png"))
    else:
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "clip.avi")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10.0, (64, 48))
        for f in frames:
            writer.write(f)
        writer.release()
    assert isinstance(infer.sniff_media(path), Video)
    rc = infer.main(["--model-path", ckpt, "--media", path, "--text", "What happens?",
                     "--max-new-tokens", str(NEW_TOKENS), "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out == _greedy(engine, [Video(path), "What happens?"]) + "\n"


def test_video_duration_decodes_time_tokens(ckpt, engine, monkeypatch, capsys):
    """`--video-duration` maps the answer's `<tN>` tokens to seconds, as
    the JAX package's `decode_time_token` does."""
    from vila_tpu.cli.infer import decode_time_token as jdecode

    text = "from <t0> to <t5> and <t120> end <t99>"
    for dur, n in ((12.5, 100), (3.0, 10), (60.0, 1)):
        assert (infer.decode_time_token(text, duration=dur, num_time_tokens=n)
                == jdecode(text, duration=dur, num_time_tokens=n))
    monkeypatch.setattr(type(engine), "generate_content", lambda self, p, gc: text)
    monkeypatch.setattr(entry, "load", lambda *a, **k: engine)
    rc = infer.main(["--model-path", ckpt, "--text", "when?", "--video-duration", "12.5",
                     "--num-time-tokens", "10", "--device", "cpu"])
    assert rc == 0
    assert capsys.readouterr().out == jdecode(text, duration=12.5, num_time_tokens=10) + "\n"


def test_train_main_runs_two_steps_and_saves(ckpt, tmp_path):
    out = str(tmp_path / "run")
    rc = train_cli.main([
        "--model-path", ckpt, "--device", "cpu", "--stage", "sft",
        "--data-mixture", "dummy_mix", "--max-steps", "2", "--save-steps", "2",
        "--seq-len", "512", "--logging-steps", "1", "--output-dir", out,
    ])
    assert rc == 0
    mgr = CheckpointManager(os.path.join(out, "checkpoints"))
    assert mgr.latest_step() == 2
    saved = mgr.restore(2)["params"]["llm"]["layers"]["q_proj"]["kernel"]
    cfg = entry.build_config(ckpt, device="cpu")
    start = entry.load_params(ckpt, cfg, device="cpu")["llm"]["layers"]["q_proj"]["kernel"]
    assert saved.dtype == torch.float32 and saved.shape == start.shape
    assert not torch.equal(saved, start)  # the f32 master weights were trained
