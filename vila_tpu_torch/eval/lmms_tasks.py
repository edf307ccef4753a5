"""Custom lmms-eval task helpers, as `vila_tpu/eval/lmms_tasks.py`:
VideoMME with frame-count and subtitle variants (capability parity: llava/eval/lmms/tasks/videomme.py — the
reference registers a custom videomme task because stock lmms-eval lacks
the with-subtitle prompting used by LongVILA's 65.1% VideoMME number).

Pure functions here (prompt construction, answer parsing) are harness-
independent and unit-tested locally; `register()` wires them into
lmms-eval when the harness is installed.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

MC_PREAMBLE = (
    "Select the best answer to the following multiple-choice question "
    "based on the video. Respond with only the letter (A, B, C, or D) of "
    "the correct option.\n"
)


def doc_to_text(doc: Dict[str, Any]) -> str:
    options = doc.get("options") or doc.get("choices") or []
    lines = [MC_PREAMBLE + str(doc["question"])]
    lines += [str(o) for o in options]
    lines.append("The best answer is:")
    return "\n".join(lines)


def _read_srt(path: str, max_chars: int = 4000) -> str:
    """Subtitle text from an .srt file: strip indices/timestamps/tags."""
    lines: List[str] = []
    with open(path, errors="ignore") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.isdigit() or "-->" in line:
                continue
            line = re.sub(r"<[^>]+>", "", line)
            lines.append(line)
    text = " ".join(lines)
    return text[:max_chars]


def doc_to_text_subtitle(
    doc: Dict[str, Any], subtitle_root: Optional[str] = None
) -> str:
    """With-subtitle prompt: subtitle transcript precedes the MC question
    (videomme_doc_to_text_subtitle parity). Subtitles come from
    doc["subtitles"] or from <subtitle_root>/<videoID>.srt."""
    subs = doc.get("subtitles")
    if subs is None and subtitle_root:
        srt = os.path.join(subtitle_root, str(doc.get("videoID", "")) + ".srt")
        if os.path.exists(srt):
            subs = _read_srt(srt)
    if not subs:
        return doc_to_text(doc)
    if isinstance(subs, list):
        subs = " ".join(str(s) for s in subs)
    return (
        "This video's subtitles are listed below:\n"
        f"{subs}\n"
        + doc_to_text(doc)
    )


def doc_to_visual(doc: Dict[str, Any]) -> List[str]:
    """Resolve the video file for a VideoMME doc from the lmms cache
    (videomme_doc_to_visual behavior: try .mp4 / .MP4 / .mkv)."""
    root = os.environ.get("LMMS_VIDEOMME_ROOT", "")
    base = os.path.join(root, "data", str(doc.get("videoID", "")))
    for ext in (".mp4", ".MP4", ".mkv", ".webm"):
        if os.path.exists(base + ext):
            return [base + ext]
    raise FileNotFoundError(f"video not found: {base}.mp4")


def doc_to_text_subtitle_env(doc: Dict[str, Any]) -> str:
    """Subtitle prompt using LMMS_VIDEOMME_ROOT/subtitle/<id>.srt."""
    root = os.environ.get("LMMS_VIDEOMME_ROOT", "")
    return doc_to_text_subtitle(
        doc, subtitle_root=os.path.join(root, "subtitle") if root else None
    )


def parse_mc_answer(pred: str) -> Optional[str]:
    """Extract the chosen option letter from a free-form answer.

    Case matters: uppercasing the whole prediction would turn the English
    article in "it is a man" into option A, so lowercase letters only count
    when they are unambiguously an option mark ("(a)", "a)", "a.", "a:")
    or a bare one-letter reply."""
    s = pred.strip()
    m = re.search(r"\b([A-D])\b", s)
    if m:
        return m.group(1)
    m = re.search(r"\(([a-d])\)|\b([a-d])[).:]", s)
    if m:
        return (m.group(1) or m.group(2)).upper()
    if len(s) == 1 and s.upper() in "ABCD":
        return s.upper()
    return None


def process_results(doc: Dict[str, Any], results: List[str]) -> Dict[str, Any]:
    pred = parse_mc_answer(results[0] if results else "")
    gold = str(doc.get("answer", "")).strip().upper()[:1]
    return {"videomme_accuracy": float(pred == gold)}


def register():
    """Build an lmms-eval TaskManager that includes the in-repo
    `lmms_yaml/` task dir (videomme / videomme_w_subtitle variants), or
    None when the harness is not installed. The caller passes it to
    `simple_evaluate(task_manager=...)` — lmms-eval discovers tasks only
    through TaskManager include paths, not environment variables."""
    yaml_dir = os.path.join(os.path.dirname(__file__), "lmms_yaml")
    try:
        from lmms_eval.tasks import TaskManager
    except Exception:
        return None
    try:
        return TaskManager(include_path=yaml_dir)
    except TypeError:
        # older harnesses: TaskManager(verbosity, include_path=...)
        return TaskManager("INFO", include_path=yaml_dir)
