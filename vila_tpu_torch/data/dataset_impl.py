"""Dataset implementation zoo, as `vila_tpu/data/dataset_impl.py` — the
reference's `llava/data/dataset_impl/` (~2,400 LoC: coyo_qa, coyo_recap,
general_img_text, sam, textocr, hiertext, panda70m, lita, llava, llava_cot,
eagle_wds) rebuilt on the port's BaseDataset / ShardedTarDataset.

Each class turns a raw record format into the framework's conversation
shape and defers tokenization/tiling to `BaseDataset.process`, so every
impl stays host-side numpy. Citations point at
the reference file whose record format and prompt templates each class
reproduces.
"""

from __future__ import annotations

import io
import json
import random
from typing import Any, Dict, List, Sequence

import numpy as np

from vila_tpu_torch.constants import MEDIA_TOKENS
from vila_tpu_torch.data.dataset import BaseDataset
from vila_tpu_torch.utils.io import load as io_load

IMG = MEDIA_TOKENS["image"]
VID = MEDIA_TOKENS["video"]


# ---------------------------------------------------------------------------
# question templates (dataset_impl/coyo_qa.py:36-52 `format2questions`)
# ---------------------------------------------------------------------------

QA_TEMPLATES: Dict[str, List[str]] = {
    "spatial": [
        "Elaborate on the visual and narrative elements of the image in "
        "detail, with a focus on spatial relations.",
        "Describe the image in details, with a focus on spatial relations.",
        "Give a detailed description of the image, focusing on both visual "
        "and narrative elements, and the spatial information.",
    ],
    "ocr": [
        "Describe the textual content in the image.",
        "Identify the text visible in this image.",
        "What words or phrases can you identify in the image?",
    ],
    "bbox_interleaved": [
        "Generate a thorough caption for the image and specify where the "
        "main elements are positioned.",
        "Write a detailed caption for the image and specify the location "
        "of the main objects in [xmin,ymin,xmax,ymax].",
        "Provide a caption for the image, including the coordinates of the "
        "main visual elements.",
    ],
    "caption": [
        "Describe the image briefly.",
        "Write a short caption for the image.",
        "What is shown in this picture?",
    ],
}


def _qa_conversation(question: str, answer: str) -> List[Dict[str, str]]:
    return [
        {"from": "human", "value": f"{IMG}\n{question}"},
        {"from": "gpt", "value": answer},
    ]


class _RecordDataset(BaseDataset):
    """BaseDataset over records converted lazily via `to_instance`."""

    def __init__(self, tokenizer, cfg, records, seed: int = 0, **kw):
        super().__init__(tokenizer, cfg, instances=[], **kw)
        self.records = records
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.records)

    def to_instance(self, record) -> Dict[str, Any]:  # pragma: no cover
        raise NotImplementedError

    def __getitem__(self, i: int) -> Dict[str, Any]:
        try:
            return self.process(self.to_instance(self.records[i]))
        except Exception:
            if not self.resample_on_failure:
                raise
            return self[self.rng.randrange(len(self))]


# ---------------------------------------------------------------------------
# COYO QA / recap (dataset_impl/coyo_qa.py, coyo_recap.py)
# ---------------------------------------------------------------------------


class CoyoQADataset(_RecordDataset):
    """Caption-pair records with format-keyed synthetic QA prompts
    (LazyCoyoWebQADataset, dataset_impl/coyo_qa.py:56). Records:
    {"image": path|bytes, "qa": {"spatial": str, "ocr": str, ...}} —
    one format sampled per visit, its template as the question."""

    def to_instance(self, r):
        formats = [k for k in r.get("qa", {}) if k in QA_TEMPLATES]
        if not formats:
            raise ValueError("record without usable qa formats")
        fmt = self.rng.choice(formats)
        q = self.rng.choice(QA_TEMPLATES[fmt])
        return {
            "image": r["image"],
            "conversations": _qa_conversation(q, r["qa"][fmt]),
        }


class CoyoRecapDataset(_RecordDataset):
    """Recaptioned caption pairs (LazyCoyoWebRecapDataset,
    dataset_impl/coyo_recap.py): prefer the long VILA recaption over the
    alt-text; emitted as a plain captioning conversation."""

    def to_instance(self, r):
        caption = r.get("recap") or r.get("caption") or r.get("text", "")
        q = self.rng.choice(QA_TEMPLATES["caption"])
        return {
            "image": r["image"],
            "conversations": _qa_conversation(q, caption),
        }


class GeneralImageTextDataset(_RecordDataset):
    """Generic (image, text) corpus (dataset_impl/general_img_text.py):
    caption mode emits autoregressive caption text; qa mode wraps it in a
    sampled question."""

    def __init__(self, tokenizer, cfg, records, mode: str = "caption", **kw):
        super().__init__(tokenizer, cfg, records, **kw)
        assert mode in ("caption", "qa")
        self.mode = mode

    def to_instance(self, r):
        text = r.get("text") or r.get("caption", "")
        if self.mode == "qa":
            q = self.rng.choice(QA_TEMPLATES["caption"])
            convo = _qa_conversation(q, text)
        else:
            convo = [
                {"from": "human", "value": IMG},
                {"from": "gpt", "value": text},
            ]
        return {"image": r["image"], "conversations": convo}


# ---------------------------------------------------------------------------
# SAM captions (dataset_impl/sam.py)
# ---------------------------------------------------------------------------


class SAMCaptionDataset(_RecordDataset):
    """SA-1B images + (re)captions (LazySAMWebDataset, dataset_impl/sam.py).
    Records: {"image": path, "caption": str}."""

    def to_instance(self, r):
        q = self.rng.choice(QA_TEMPLATES["spatial"])
        return {
            "image": r["image"],
            "conversations": _qa_conversation(q, r["caption"]),
        }


# ---------------------------------------------------------------------------
# OCR: TextOCR + HierText (dataset_impl/textocr.py, hiertext.py)
# ---------------------------------------------------------------------------


def bbox_str(x0: float, y0: float, x1: float, y1: float) -> str:
    return f"[{x0:.2f},{y0:.2f},{x1:.2f},{y1:.2f}]"


def polygon_to_bbox(points: Sequence[float]) -> tuple:
    xs, ys = points[0::2], points[1::2]
    return min(xs), min(ys), max(xs), max(ys)


class TextOCRDataset(_RecordDataset):
    """TextOCR annotations → "read the text" QA with word boxes
    (dataset_impl/textocr.py). Records: {"image": path, "anns":
    [{"utf8_string": str, "points"|"bbox": [...]}], "width", "height"}."""

    def __init__(self, tokenizer, cfg, records, with_bbox: bool = True, **kw):
        super().__init__(tokenizer, cfg, records, **kw)
        self.with_bbox = with_bbox

    def to_instance(self, r):
        w = float(r.get("width", 1.0)) or 1.0
        h = float(r.get("height", 1.0)) or 1.0
        parts = []
        for a in r["anns"]:
            text = a.get("utf8_string", "").strip()
            if not text or text == ".":
                continue  # TextOCR's illegible marker
            if self.with_bbox:
                if "points" in a:
                    x0, y0, x1, y1 = polygon_to_bbox(a["points"])
                else:
                    x, y, bw, bh = a["bbox"]
                    x0, y0, x1, y1 = x, y, x + bw, y + bh
                parts.append(
                    f"{text} {bbox_str(x0 / w, y0 / h, x1 / w, y1 / h)}"
                )
            else:
                parts.append(text)
        if not parts:
            raise ValueError("no legible text")
        q = self.rng.choice(QA_TEMPLATES["ocr"])
        return {
            "image": r["image"],
            "conversations": _qa_conversation(q, ", ".join(parts)),
        }


class HierTextDataset(_RecordDataset):
    """HierText hierarchical OCR → paragraph-ordered transcription
    (dataset_impl/hiertext.py). Records: {"image": path, "paragraphs":
    [{"lines": [{"words": [{"text": str}]}]}]}."""

    def to_instance(self, r):
        lines_out = []
        for para in r["paragraphs"]:
            for line in para.get("lines", []):
                words = [
                    w["text"] for w in line.get("words", []) if w.get("text")
                ]
                if words:
                    lines_out.append(" ".join(words))
        if not lines_out:
            raise ValueError("no text")
        q = self.rng.choice(QA_TEMPLATES["ocr"])
        return {
            "image": r["image"],
            "conversations": _qa_conversation(q, "\n".join(lines_out)),
        }


# ---------------------------------------------------------------------------
# Video: Panda-70M + LITA dense events (dataset_impl/panda70m.py, lita.py)
# ---------------------------------------------------------------------------


class Panda70MDataset(_RecordDataset):
    """Video-caption pairs (LazyPanda70MDataset, dataset_impl/panda70m.py).
    Records: {"video": path, "caption": str}."""

    def to_instance(self, r):
        return {
            "video": r["video"],
            "conversations": [
                {
                    "from": "human",
                    "value": f"{VID}\nElaborate on the visual and narrative "
                    "elements of the video in detail.",
                },
                {"from": "gpt", "value": r["caption"]},
            ],
        }


class LITADataset(_RecordDataset):
    """Dense video event localization with TIME TOKENS
    (dataset_impl/lita.py): each event's start/end maps to <t{k}> over
    `num_time_tokens` uniform bins; answers interleave time spans and event
    captions. Pairs with soft_cross_entropy training (model/loss.py:11)."""

    def __init__(self, tokenizer, cfg, records, num_time_tokens: int = 100, **kw):
        super().__init__(tokenizer, cfg, records, **kw)
        self.num_time_tokens = num_time_tokens

    def _t(self, t: float, duration: float) -> str:
        k = int(
            np.clip(
                round(t / max(duration, 1e-6) * (self.num_time_tokens - 1)),
                0, self.num_time_tokens - 1,
            )
        )
        return f"<t{k}>"

    def to_instance(self, r):
        dur = float(r.get("duration", 0.0)) or max(
            (e["end"] for e in r["events"]), default=1.0
        )
        spans = [
            f"{self._t(e['start'], dur)} {self._t(e['end'], dur)} "
            f"{e['caption']}"
            for e in r["events"]
        ]
        return {
            "video": r["video"],
            "conversations": [
                {
                    "from": "human",
                    "value": f"{VID}\nProvide a detailed description of the "
                    "given video, with timestamps for each event.",
                },
                {"from": "gpt", "value": " ".join(spans)},
            ],
        }


# ---------------------------------------------------------------------------
# LLaVA-format JSON + CoT (dataset_impl/llava.py, llava_cot.py)
# ---------------------------------------------------------------------------


class LLaVADataset(BaseDataset):
    """Plain LLaVA-158K-format conversation json (dataset_impl/llava.py);
    BaseDataset already speaks this format — the subclass only binds the
    data/media paths."""

    def __init__(self, tokenizer, cfg, data_path, media_dir=None, **kw):
        super().__init__(
            tokenizer, cfg, data_path=data_path, media_dir=media_dir, **kw
        )


class LLaVACoTDataset(_RecordDataset):
    """LLaVA-CoT reasoning traces (dataset_impl/llava_cot.py): answers keep
    the <SUMMARY>/<CAPTION>/<REASONING>/<CONCLUSION> staged structure;
    records may carry them as separate fields or inline."""

    STAGES = ("summary", "caption", "reasoning", "conclusion")

    def to_instance(self, r):
        if "conversations" in r:
            return {
                "image": r.get("image"),
                "conversations": r["conversations"],
            }
        parts = [
            f"<{s.upper()}> {r[s]} </{s.upper()}>"
            for s in self.STAGES
            if r.get(s)
        ]
        return {
            "image": r.get("image"),
            "conversations": _qa_conversation(r["question"], " ".join(parts)),
        }


# ---------------------------------------------------------------------------
# WebDataset-backed wrapper (dataset_impl/eagle_wds.py, coyo tar shards)
# ---------------------------------------------------------------------------


class WDSRecordAdapter:
    """Adapt ShardedTarDataset samples ({name: bytes}) into record dicts for
    the classes above (the VILAWebDataset role,
    data/simple_vila_webdataset.py:195): .jpg/.png -> "image" (PIL),
    .json/.txt -> merged fields."""

    def __init__(self, shard_paths: Sequence[str]) -> None:
        from vila_tpu_torch.data.tario import ShardedTarDataset

        self.tar = ShardedTarDataset(list(shard_paths))

    def __len__(self) -> int:
        return len(self.tar)

    def __getitem__(self, i: int) -> Dict[str, Any]:
        from PIL import Image

        sample = self.tar[i]
        record: Dict[str, Any] = {}
        for ext, blob in sample.items():
            ext = ext.lower().lstrip(".")
            if ext in ("jpg", "jpeg", "png", "webp"):
                record["image"] = Image.open(io.BytesIO(blob)).convert("RGB")
            elif ext == "json":
                record.update(json.loads(blob.decode()))
            elif ext == "txt":
                record.setdefault("caption", blob.decode())
        return record


def load_records(path: str) -> List[Dict[str, Any]]:
    """json / jsonl / pickle record list loader (lru_json_load role,
    dataset_impl/coyo_qa.py:31)."""
    return io_load(path)
