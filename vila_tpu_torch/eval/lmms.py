"""lmms-eval model wrapper, as `vila_tpu/eval/lmms.py`: drive the port from
the lmms-eval harness.

Capability parity: `llava/eval/lmms/models/vila_internal.py:20` (`class
VILA(lmms)`) — batch size 1, `generate_until` mapping harness requests to
`generate_content`, optional on-disk response caching keyed by the request
(CACHE_DIR behavior, vila_internal.py:110-147).

lmms-eval is not a baked-in dependency; the class degrades to a standalone
object with the same `generate_until` surface when the harness is absent,
so it is unit-testable here and drop-in usable where lmms-eval exists
(`python -m lmms_eval --model vila_tpu_torch --model_args
model_path=...,device=cuda`). The engine runs on the card unless
`device=cpu`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, List, Optional

try:  # pragma: no cover - exercised only where lmms-eval is installed
    from lmms_eval.api.model import lmms as _LmmsBase
    from lmms_eval.api.registry import register_model as _register_model

    _HAVE_LMMS = True
except Exception:  # harness absent: standalone-compatible base
    _LmmsBase = object

    def _register_model(*names):
        def deco(cls):
            return cls

        return deco

    _HAVE_LMMS = False


@_register_model("vila_tpu_torch")
class VILA(_LmmsBase):
    """bs=1 generate-only wrapper around the port's GenerationEngine."""

    def __init__(
        self,
        model_path: str = "",
        conv_mode: Optional[str] = None,
        num_video_frames: Optional[int] = None,
        max_new_tokens: int = 512,
        cache_dir: Optional[str] = None,
        batch_size: int = 1,
        device: str = "cuda",
        **kwargs: Any,
    ) -> None:
        if _HAVE_LMMS:
            super().__init__()
        assert int(batch_size) == 1, "vila_tpu_torch lmms wrapper runs bs=1"
        import vila_tpu_torch

        self.engine = vila_tpu_torch.load(model_path, device=device)
        if num_video_frames:
            import dataclasses

            self.engine.cfg = dataclasses.replace(
                self.engine.cfg, num_video_frames=num_video_frames
            )
        self.max_new_tokens = max_new_tokens
        self.cache_dir = cache_dir or os.environ.get("VILA_EVAL_CACHE")
        if self.cache_dir:
            os.makedirs(self.cache_dir, exist_ok=True)

    # -- caching (vila_internal.py:110-124) ------------------------------
    def _cache_path(self, key: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        h = hashlib.sha256(key.encode()).hexdigest()[:32]
        return os.path.join(self.cache_dir, f"{h}.json")

    def _cached(self, key: str) -> Optional[str]:
        p = self._cache_path(key)
        if p and os.path.exists(p):
            with open(p) as f:
                return json.load(f)["response"]
        return None

    def _store(self, key: str, response: str) -> None:
        p = self._cache_path(key)
        if p:
            with open(p, "w") as f:
                json.dump({"key": key, "response": response}, f)

    # -- harness surface ---------------------------------------------------
    def generate_until(self, requests: List[Any]) -> List[str]:
        """Each request resolves to (context str, gen kwargs, media list).

        Accepts lmms-eval `Instance`s (args tuple) or plain dicts
        {"context": str, "media": [Image|Video|path], "gen_kwargs": {}}.
        """
        out = []
        for req in requests:
            context, media, gen_kwargs = _unpack_request(req)
            key = json.dumps(
                {"c": context, "m": [str(m) for m in media], "g": gen_kwargs},
                sort_keys=True,
            )
            cached = self._cached(key)
            if cached is not None:
                out.append(cached)
                continue
            response = self._generate(context, media, gen_kwargs)
            self._store(key, response)
            out.append(response)
        return out

    def _generate(self, context, media, gen_kwargs) -> str:
        from vila_tpu_torch.inference.generate import GenerationConfig
        from vila_tpu_torch.media import Image, Video

        prompt: List[Any] = []
        for m in media:
            if isinstance(m, (Image, Video)):
                prompt.append(m)
            elif isinstance(m, str) and m.lower().endswith(
                (".mp4", ".avi", ".mov", ".webm", ".mkv")
            ):
                prompt.append(Video(m))
            else:
                prompt.append(Image(m))
        prompt.append(context)
        gc = GenerationConfig(
            max_new_tokens=int(
                gen_kwargs.get("max_new_tokens", self.max_new_tokens)
            ),
            temperature=float(gen_kwargs.get("temperature", 0.0)),
            top_p=float(gen_kwargs.get("top_p", 1.0)),
        )
        return self.engine.generate_content(prompt, gc)

    def loglikelihood(self, requests):  # pragma: no cover - parity stub
        raise NotImplementedError(
            "vila_tpu_torch lmms wrapper is generate-only "
            "(matches vila_internal.py which only implements generate_until)"
        )

    def generate_until_multi_round(self, requests):  # pragma: no cover
        raise NotImplementedError


def _unpack_request(req):
    """Normalize an lmms-eval Instance or a plain dict."""
    if isinstance(req, dict):
        return (
            req["context"],
            req.get("media", []),
            req.get("gen_kwargs", {}),
        )
    # lmms-eval Instance: .args = (context, gen_kwargs, doc_to_visual,
    # doc_id, task, split); visuals resolved via doc_to_visual(doc)
    context, gen_kwargs, doc_to_visual, doc_id, task, split = req.args
    media = []
    try:
        import lmms_eval  # noqa: F401

        doc = req.doc if hasattr(req, "doc") else None
        if doc is not None and doc_to_visual is not None:
            media = doc_to_visual(doc) or []
    except Exception:
        pass
    return context, media, gen_kwargs or {}
