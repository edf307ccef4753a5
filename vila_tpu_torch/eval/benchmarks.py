"""Real benchmark evaluators driven end-to-end through GenerationEngine,
as `vila_tpu/eval/benchmarks.py` (pure Python: the scorers, `TASKS`, the
aggregation and the dataset readers are the JAX package's, line for line;
generation goes through the port's `GenerationEngine` or
`ContinuousBatcher` and its `media.Image` / `media.Video`). The committed
mini fixtures are read, as data, from the JAX package's directory
(`FIXTURE_ROOT`, found from this package's location).

Capability parity: the reference's in-repo eval suites + registry
(llava/eval/registry.yaml — 68 tasks; llava/eval/textvqa.py with the m4c
TextVQA accuracy evaluator; MC parsing like llava/eval/mmmu_utils). Five
benchmark families are implemented natively, each loadable from a local
JSON/JSONL file in the benchmark's standard layout:

  textvqa    — open-ended VQA scored with the official VQA-v2 accuracy
               metric: acc = min(#humans-matching/3, 1), with the standard
               answer normalization (articles, punctuation, number words,
               contractions).
  gqa        — open-ended, exact match after normalization.
  scienceqa  — multiple choice (letter accuracy), image optional.
  pope       — binary yes/no object hallucination probe; reports accuracy,
               precision, recall, F1, yes-ratio.
  videomme   — video multiple choice (letter accuracy), VideoMME format.
  refcoco    — referring-expression grounding; the model answers with a
               [x0,y0,x1,y1] box (normalized), scored by IoU@0.5 accuracy
               and mean IoU (llava/eval/refcoco.py semantics).
  mathvista  — numeric/short answer extraction with relative-tolerance
               match (llava/eval/mathvista.py + mathvista_utils).
  docvqa / infovqa — ANLS (average normalized Levenshtein similarity,
               threshold 0.5 — the official DocVQA metric).
  chartqa    — relaxed accuracy: 5% numeric tolerance, exact string
               otherwise (official ChartQA metric).
  mme        — paired yes/no probes per category; reports per-category
               acc, acc+ (both questions of an image right) and
               score = 100*(acc + acc+), summed into mme/total.
  ocrbench   — gold-substring containment (official OCRBench scoring).
  tallyqa    — counting; exact integer match, simple/complex split.
  caption    — image/video captioning scored with corpus-level CIDEr-D
               and BLEU-4 (scicap/youcook2/vatex/widgetcap family).
  mmmu, ai2d, seedbench, realworldqa, mmbench — image multiple choice
               (letter accuracy), same scorer as scienceqa.
  egoschema, cinepile — video multiple choice, same scorer as videomme.
  vizwiz     — VQA-v2 accuracy over 10 human answers (textvqa scorer).

Dataset record formats (jsonl or json list):
  textvqa:   {"image": str, "question": str, "answers": [str x10]}
  gqa:       {"image": str, "question": str, "answer": str}
  scienceqa: {"image": str|null, "question": str, "choices": [str],
              "answer": int (index)}
  pope:      {"image": str, "question": str, "answer": "yes"|"no"}
  videomme:  {"video": str, "question": str, "choices": [str],
              "answer": "A"|"B"|"C"|"D"}
"""

from __future__ import annotations

import argparse
import json
import os
import re
import string
from typing import Any, Callable, Dict, List, Optional

# ---------------------------------------------------------------------------
# VQA-v2 answer normalization (the m4c/official VQA eval algorithm)
# ---------------------------------------------------------------------------

_ARTICLES = {"a", "an", "the"}
_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
# standard contraction repairs from the official VQA evaluator (subset
# covering the frequent cases; the algorithm is public — no code copied)
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hasnt": "hasn't", "havent": "haven't",
    "isnt": "isn't", "shouldnt": "shouldn't", "thats": "that's",
    "theres": "there's", "wasnt": "wasn't", "werent": "weren't",
    "whats": "what's", "wont": "won't", "wouldnt": "wouldn't",
    "youre": "you're", "youll": "you'll", "youve": "you've",
}
_PUNCT_STRIP = re.compile(r"(?<=\d)[,](?=\d)")  # 1,000 -> 1000
_PERIOD_STRIP = re.compile(r"(?<!\d)\.(?!\d)")


def vqa_normalize(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _PUNCT_STRIP.sub("", ans)
    ans = _PERIOD_STRIP.sub("", ans)
    out = []
    for word in ans.split():
        word = word.strip(string.punctuation)
        word = _NUMBER_WORDS.get(word, word)
        if word in _ARTICLES:
            continue
        word = _CONTRACTIONS.get(word, word)
        if word:
            out.append(word)
    return " ".join(out)


def vqa_accuracy(pred: str, human_answers: List[str]) -> float:
    """Official VQA accuracy: min(#matching-humans / 3, 1)."""
    p = vqa_normalize(pred)
    matches = sum(1 for a in human_answers if vqa_normalize(a) == p)
    return min(matches / 3.0, 1.0)


# ---------------------------------------------------------------------------
# Multiple-choice letter parsing (llava/eval/mmmu_utils-style behavior)
# ---------------------------------------------------------------------------

_LETTERS = "ABCDEFGH"


def parse_choice(pred: str, choices: List[str]) -> Optional[str]:
    """Extract the chosen letter from a free-form model answer."""
    text = pred.strip()
    # leading letter, possibly "(A)", "A.", "A)" or bare "A"
    m = re.match(r"^\(?([A-H])\)?[.):\s]", text + " ")
    if m and m.group(1) in _LETTERS[: len(choices)]:
        return m.group(1)
    # "answer is X" pattern
    m = re.search(r"answer\s*(?:is|:)?\s*\(?([A-H])\)?", text, re.IGNORECASE)
    if m and m.group(1).upper() in _LETTERS[: len(choices)]:
        return m.group(1).upper()
    # full choice text match
    tl = text.lower()
    for i, c in enumerate(choices):
        if c.lower().strip() and c.lower().strip() in tl:
            return _LETTERS[i]
    return None


def format_mc_prompt(question: str, choices: List[str]) -> str:
    lines = [question]
    for i, c in enumerate(choices):
        lines.append(f"{_LETTERS[i]}. {c}")
    lines.append(
        "Answer with the option's letter from the given choices directly."
    )
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Task definitions
# ---------------------------------------------------------------------------


def _short_answer_prompt(q: str) -> str:
    return f"{q}\nAnswer the question using a single word or phrase."


def _eval_textvqa(engine, ex, gen, media_root):
    pred = _generate(engine, ex, _short_answer_prompt(ex["question"]),
                     gen, media_root)
    return pred, {"acc": vqa_accuracy(pred, ex["answers"])}


def _eval_gqa(engine, ex, gen, media_root):
    pred = _generate(engine, ex, _short_answer_prompt(ex["question"]),
                     gen, media_root)
    ok = vqa_normalize(pred) == vqa_normalize(ex["answer"])
    return pred, {"acc": float(ok)}


def _gold_letter(answer) -> str:
    """Gold MC answer as a letter — accepts an index or a letter string."""
    if isinstance(answer, int):
        return _LETTERS[answer]
    return str(answer).strip().upper()


def _eval_scienceqa(engine, ex, gen, media_root):
    prompt = format_mc_prompt(ex["question"], ex["choices"])
    pred = _generate(engine, ex, prompt, gen, media_root)
    letter = parse_choice(pred, ex["choices"])
    return pred, {"acc": float(letter == _gold_letter(ex["answer"]))}


def _eval_pope(engine, ex, gen, media_root):
    pred = _generate(
        engine, ex,
        f"{ex['question']}\nAnswer the question with yes or no.",
        gen, media_root,
    )
    p = vqa_normalize(pred)
    yes = p.startswith("yes") or p == "yes"
    no = p.startswith("no") or p == "no"
    pred_label = "yes" if yes and not no else ("no" if no else "other")
    gold = ex["answer"].strip().lower()
    return pred, {
        "acc": float(pred_label == gold),
        "tp": float(pred_label == "yes" and gold == "yes"),
        "fp": float(pred_label == "yes" and gold == "no"),
        "fn": float(pred_label != "yes" and gold == "yes"),
        "yes": float(pred_label == "yes"),
    }


def _eval_videomme(engine, ex, gen, media_root):
    prompt = format_mc_prompt(ex["question"], ex["choices"])
    pred = _generate(engine, ex, prompt, gen, media_root)
    letter = parse_choice(pred, ex["choices"])
    return pred, {"acc": float(letter == _gold_letter(ex["answer"]))}


_BOX_RE = re.compile(
    r"\[?\s*([0-9]*\.?[0-9]+)\s*,\s*([0-9]*\.?[0-9]+)\s*,"
    r"\s*([0-9]*\.?[0-9]+)\s*,\s*([0-9]*\.?[0-9]+)\s*\]?"
)


def parse_box(pred: str) -> Optional[List[float]]:
    m = _BOX_RE.search(pred)
    if not m:
        return None
    box = [float(g) for g in m.groups()]
    if max(box) > 2.0:  # pixel coords: caller normalizes via image size
        return box
    return box


def box_iou(a: List[float], b: List[float]) -> float:
    ix0, iy0 = max(a[0], b[0]), max(a[1], b[1])
    ix1, iy1 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(ix1 - ix0, 0.0) * max(iy1 - iy0, 0.0)
    area_a = max(a[2] - a[0], 0.0) * max(a[3] - a[1], 0.0)
    area_b = max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0


def _eval_refcoco(engine, ex, gen, media_root):
    pred = _generate(
        engine, ex,
        f"{ex['question']}\nAnswer with the bounding box "
        "[x0,y0,x1,y1] in normalized coordinates.",
        gen, media_root,
    )
    box = parse_box(pred)
    gold = [float(v) for v in ex["answer"]]
    iou = box_iou(box, gold) if box is not None else 0.0
    return pred, {"acc": float(iou >= 0.5), "iou": iou}


_NUM_RE = re.compile(r"-?\d+\.?\d*(?:e-?\d+)?")


def extract_number(pred: str) -> Optional[float]:
    """Last number in the answer (mathvista_utils extraction behavior —
    models often restate the question's numbers first)."""
    nums = _NUM_RE.findall(pred.replace(",", ""))
    return float(nums[-1]) if nums else None


def _eval_mathvista(engine, ex, gen, media_root):
    if ex.get("choices"):
        return _eval_scienceqa(engine, ex, gen, media_root)
    pred = _generate(
        engine, ex,
        f"{ex['question']}\nAnswer with a number.",
        gen, media_root,
    )
    n = extract_number(pred)
    gold = float(ex["answer"])
    ok = n is not None and (
        abs(n - gold) <= 1e-3 * max(abs(gold), 1.0)
    )
    return pred, {"acc": float(ok)}


# ---------------------------------------------------------------------------
# ANLS (DocVQA / InfographicVQA official metric)
# ---------------------------------------------------------------------------


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, O(len(a)·len(b)) two-row DP."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls_score(pred: str, golds: List[str], tau: float = 0.5) -> float:
    """Max over golds of 1 - NL(pred, gold), zeroed past the tau threshold."""
    p = " ".join(pred.strip().lower().split())
    best = 0.0
    for g in golds:
        g = " ".join(str(g).strip().lower().split())
        if not p and not g:
            best = max(best, 1.0)
            continue
        d = edit_distance(p, g)
        nl = d / max(len(p), len(g), 1)
        if nl < tau:
            best = max(best, 1.0 - nl)
    return best


def _eval_docvqa(engine, ex, gen, media_root):
    pred = _generate(engine, ex, _short_answer_prompt(ex["question"]),
                     gen, media_root)
    golds = ex["answers"] if "answers" in ex else [ex["answer"]]
    s = anls_score(pred, golds)
    return pred, {"acc": s}


# ---------------------------------------------------------------------------
# ChartQA relaxed accuracy
# ---------------------------------------------------------------------------


def relaxed_match(pred: str, gold: str, tol: float = 0.05) -> bool:
    """Official ChartQA scoring: numeric answers match within 5% relative
    tolerance; everything else is case-insensitive exact match."""
    p, g = pred.strip().rstrip(".").strip(), str(gold).strip()
    try:
        gv = float(g.replace(",", "").rstrip("%"))
        n = extract_number(p)
        if n is None:
            return False
        return abs(n - gv) <= tol * abs(gv) if gv != 0 else n == 0
    except ValueError:
        return p.lower() == g.lower()


def _eval_chartqa(engine, ex, gen, media_root):
    pred = _generate(engine, ex, _short_answer_prompt(ex["question"]),
                     gen, media_root)
    return pred, {"acc": float(relaxed_match(pred, ex["answer"]))}


# ---------------------------------------------------------------------------
# MME (paired yes/no probes, per-category score)
# ---------------------------------------------------------------------------


def _eval_mme(engine, ex, gen, media_root):
    pred = _generate(
        engine, ex,
        f"{ex['question']}\nAnswer the question with yes or no.",
        gen, media_root,
    )
    p = vqa_normalize(pred)
    pred_label = "yes" if p.startswith("yes") else (
        "no" if p.startswith("no") else "other")
    gold = ex["answer"].strip().lower()
    return pred, {
        "acc": float(pred_label == gold),
        # carried through for the paired acc+ aggregation
        "_category": ex.get("category", "all"),
        "_image": ex.get("image", ""),
    }


def _aggregate_mme(rows: List[Dict[str, Any]]) -> Dict[str, float]:
    by_cat: Dict[str, List[Dict[str, Any]]] = {}
    for r in rows:
        by_cat.setdefault(r["_category"], []).append(r)
    metrics: Dict[str, float] = {}
    total = 0.0
    for cat, rs in sorted(by_cat.items()):
        acc = sum(r["acc"] for r in rs) / max(len(rs), 1)
        by_img: Dict[str, List[float]] = {}
        for r in rs:
            by_img.setdefault(r["_image"], []).append(r["acc"])
        plus = sum(all(v) for v in by_img.values()) / max(len(by_img), 1)
        score = 100.0 * (acc + plus)
        metrics[f"mme/{cat}/acc"] = acc
        metrics[f"mme/{cat}/acc_plus"] = plus
        metrics[f"mme/{cat}/score"] = score
        total += score
    metrics["mme/total"] = total
    return metrics


# ---------------------------------------------------------------------------
# OCRBench, TallyQA
# ---------------------------------------------------------------------------


def _eval_ocrbench(engine, ex, gen, media_root):
    pred = _generate(engine, ex, ex["question"], gen, media_root)
    golds = ex["answers"] if "answers" in ex else [ex["answer"]]
    pl = " ".join(pred.lower().split())
    ok = any(" ".join(str(g).lower().split()) in pl for g in golds)
    return pred, {"acc": float(ok)}


def _eval_tallyqa(engine, ex, gen, media_root):
    pred = _generate(
        engine, ex, f"{ex['question']}\nAnswer with a number.",
        gen, media_root,
    )
    n = extract_number(pred)
    ok = n is not None and int(n) == int(ex["answer"]) and n == int(n)
    key = "simple" if ex.get("issimple", True) else "complex"
    return pred, {"acc": float(ok), f"_{key}": float(ok), "_has_" + key: 1.0}


# ---------------------------------------------------------------------------
# Captioning: corpus-level CIDEr-D + BLEU-4 (numpy/stdlib implementations
# of the standard public metrics; scicap/youcook2/vatex/widgetcap family)
# ---------------------------------------------------------------------------


def _cap_tokenize(s: str) -> List[str]:
    s = re.sub(r"[^a-z0-9 ]", " ", s.lower())
    return s.split()


def _ngrams(tokens: List[str], n: int) -> Dict[tuple, int]:
    out: Dict[tuple, int] = {}
    for i in range(len(tokens) - n + 1):
        g = tuple(tokens[i: i + n])
        out[g] = out.get(g, 0) + 1
    return out


def cider_d(
    candidates: List[List[str]], references: List[List[List[str]]],
    n_max: int = 4, sigma: float = 6.0,
) -> float:
    """CIDEr-D: TF-IDF n-gram cosine with length penalty and count
    clipping, averaged over n=1..4, scaled by 10."""
    import math

    # document frequencies over reference sets
    df: List[Dict[tuple, int]] = [dict() for _ in range(n_max)]
    for refs in references:
        for n in range(n_max):
            seen = set()
            for ref in refs:
                seen.update(_ngrams(ref, n + 1).keys())
            for g in seen:
                df[n][g] = df[n].get(g, 0) + 1
    log_m = math.log(max(len(references), 1))

    def tfidf(counts: Dict[tuple, int], n: int):
        vec: Dict[tuple, float] = {}
        norm = 0.0
        total = max(sum(counts.values()), 1)
        for g, c in counts.items():
            idf = log_m - math.log(max(df[n].get(g, 0), 1))
            w = (c / total) * idf
            vec[g] = w
            norm += w * w
        return vec, math.sqrt(norm)

    scores = []
    for cand, refs in zip(candidates, references):
        sc = 0.0
        for n in range(n_max):
            c_counts = _ngrams(cand, n + 1)
            c_vec, c_norm = tfidf(c_counts, n)
            s_n = 0.0
            for ref in refs:
                r_counts = _ngrams(ref, n + 1)
                r_vec, r_norm = tfidf(r_counts, n)
                # clipped dot product (the -D part)
                dot = sum(min(c_vec[g], r_vec.get(g, 0.0)) * r_vec.get(g, 0.0)
                          for g in c_vec)
                delta = len(cand) - len(ref)
                pen = math.exp(-(delta ** 2) / (2 * sigma ** 2))
                if c_norm > 0 and r_norm > 0:
                    s_n += pen * dot / (c_norm * r_norm)
            sc += s_n / max(len(refs), 1)
        scores.append(10.0 * sc / n_max)
    return sum(scores) / max(len(scores), 1)


def bleu4(candidates: List[List[str]],
          references: List[List[List[str]]]) -> float:
    """Corpus BLEU-4 with brevity penalty (uniform weights)."""
    import math

    p_num = [0] * 4
    p_den = [0] * 4
    c_len = r_len = 0
    for cand, refs in zip(candidates, references):
        c_len += len(cand)
        r_len += min((abs(len(r) - len(cand)), len(r)) for r in refs)[1]
        for n in range(4):
            c_counts = _ngrams(cand, n + 1)
            max_ref: Dict[tuple, int] = {}
            for ref in refs:
                for g, c in _ngrams(ref, n + 1).items():
                    max_ref[g] = max(max_ref.get(g, 0), c)
            p_num[n] += sum(min(c, max_ref.get(g, 0))
                            for g, c in c_counts.items())
            p_den[n] += max(sum(c_counts.values()), 0)
    if any(v == 0 for v in p_num):
        return 0.0
    log_p = sum(math.log(p_num[n] / p_den[n]) for n in range(4)) / 4
    bp = 1.0 if c_len > r_len else math.exp(1 - r_len / max(c_len, 1))
    return bp * math.exp(log_p)


def _eval_caption(engine, ex, gen, media_root):
    prompt = ex.get(
        "question", "Provide a one-sentence caption for the provided image."
    )
    pred = _generate(engine, ex, prompt, gen, media_root)
    refs = ex["answers"] if "answers" in ex else [ex["answer"]]
    # exact-match acc is meaningless for captions; corpus metrics are
    # computed in the aggregator from the carried tokens
    return pred, {
        "acc": 0.0,
        "_cand": _cap_tokenize(pred),
        "_refs": [_cap_tokenize(str(r)) for r in refs],
    }


def _aggregate_caption(task: str, rows: List[Dict[str, Any]]):
    cands = [r["_cand"] for r in rows]
    refs = [r["_refs"] for r in rows]
    return {
        f"{task}/cider": cider_d(cands, refs),
        f"{task}/bleu4": bleu4(cands, refs),
        f"{task}/count": float(len(rows)),
    }


def _eval_vizwiz(engine, ex, gen, media_root):
    pred = _generate(
        engine, ex,
        f"{ex['question']}\nWhen the provided information is insufficient, "
        "respond with 'Unanswerable'. Answer the question using a single "
        "word or phrase.",
        gen, media_root,
    )
    return pred, {"acc": vqa_accuracy(pred, ex["answers"])}


# ---------------------------------------------------------------------------
# VideoMME with subtitles, MMMU open-ended, open-ended judged QA, AitZ
# ---------------------------------------------------------------------------


def _eval_videomme_sub(engine, ex, gen, media_root):
    """VideoMME with-subtitles variant (llava/eval/lmms/tasks/videomme.py
    videomme_doc_to_text_subtitle): subtitle text prefixes the MC prompt."""
    subs = ex.get("subtitles") or ""
    if isinstance(subs, list):
        subs = "\n".join(subs)
    prefix = (
        f"This video's subtitles are listed below:\n{subs}\n" if subs else ""
    )
    prompt = prefix + format_mc_prompt(ex["question"], ex["choices"])
    pred = _generate(engine, ex, prompt, gen, media_root)
    letter = parse_choice(pred, ex["choices"])
    return pred, {"acc": float(letter == _gold_letter(ex["answer"]))}


def _eval_mmmu(engine, ex, gen, media_root):
    """MMMU: multiple-choice when options exist, else the open-ended branch
    (llava/eval/mmmu_utils/eval_utils.py) — short answer matched against
    the gold string/number."""
    choices = ex.get("choices") or ex.get("options")
    if choices:
        return _eval_scienceqa(engine, ex, gen, media_root)
    pred = _generate(
        engine, ex, _short_answer_prompt(ex["question"]), gen, media_root
    )
    gold = str(ex["answer"]).strip().lower()
    pl = " ".join(pred.lower().split())
    ok = gold in pl
    gn, pn = extract_number(gold), extract_number(pred)
    if gn is not None and pn is not None:
        ok = ok or abs(gn - pn) < 1e-6
    return pred, {"acc": float(ok)}


def _llm_judge(question: str, gold: str, pred: str) -> Optional[float]:
    """Optional LLM-as-judge for open-ended QA (the reference scores these
    with a GPT judge). Points VILA_JUDGE_URL at any OpenAI-compatible
    /chat/completions endpoint — including our own vila-serve. Returns a
    score in [0, 1], or None when no judge is configured/reachable."""
    url = os.environ.get("VILA_JUDGE_URL")
    if not url:
        return None
    import urllib.request

    body = json.dumps({
        "model": os.environ.get("VILA_JUDGE_MODEL", "judge"),
        "messages": [{
            "role": "user",
            "content": (
                "Rate from 0 to 5 how well the prediction answers the "
                f"question.\nQuestion: {question}\nReference: {gold}\n"
                f"Prediction: {pred}\nReply with only the number."
            ),
        }],
        "max_tokens": 4,
    }).encode()
    req = urllib.request.Request(
        url.rstrip("/") + "/chat/completions", data=body,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.load(r)
        text = out["choices"][0]["message"]["content"]
        n = extract_number(text)
        return None if n is None else max(0.0, min(5.0, n)) / 5.0
    except Exception:
        return None


def _eval_openqa(engine, ex, gen, media_root):
    """Open-ended (video) QA — activitynet-QA / video-chatgpt / nextqa_oe /
    mmvet / llava-bench family. Scored by the configured LLM judge when
    available, else by normalized containment (the judge-free fallback; the
    reference requires an OpenAI key for these — tags them `openai`)."""
    pred = _generate(engine, ex, ex["question"], gen, media_root)
    golds = ex["answers"] if "answers" in ex else [ex["answer"]]
    golds = [str(g) for g in golds]
    score = _llm_judge(ex["question"], golds[0], pred)
    judged = score is not None
    if score is None:
        pl = " ".join(vqa_normalize(pred).split())
        score = float(
            any(" ".join(vqa_normalize(g).split()) in pl for g in golds)
        )
    return pred, {"acc": score, "_judged": float(judged)}


def _eval_aitz(engine, ex, gen, media_root):
    """Android-in-the-Zoo UI action prediction: exact action-type match +
    containment of the target element text."""
    pred = _generate(engine, ex, ex["question"], gen, media_root)
    gold = str(ex["answer"]).strip().lower()
    pl = " ".join(pred.lower().split())
    action = gold.split("(")[0].strip()
    ok = action in pl and all(
        part.strip() in pl for part in re.findall(r"\(([^)]*)\)", gold)
    )
    return pred, {"acc": float(ok)}


TASKS: Dict[str, Callable] = {
    "textvqa": _eval_textvqa,
    "gqa": _eval_gqa,
    "scienceqa": _eval_scienceqa,
    "pope": _eval_pope,
    "videomme": _eval_videomme,
    "refcoco": _eval_refcoco,
    "mathvista": _eval_mathvista,
    "docvqa": _eval_docvqa,
    "infovqa": _eval_docvqa,
    "chartqa": _eval_chartqa,
    "mme": _eval_mme,
    "ocrbench": _eval_ocrbench,
    "tallyqa": _eval_tallyqa,
    "caption": _eval_caption,
    "vizwiz": _eval_vizwiz,
    # image multiple choice — scienceqa scorer handles letter/index golds
    "mmmu": _eval_scienceqa,
    "ai2d": _eval_scienceqa,
    "seedbench": _eval_scienceqa,
    "realworldqa": _eval_scienceqa,
    "mmbench": _eval_scienceqa,
    # video multiple choice
    "egoschema": _eval_videomme,
    "cinepile": _eval_videomme,
    "videomme_sub": _eval_videomme_sub,
    "mvbench": _eval_videomme,
    "longvideobench": _eval_videomme,
    "perceptiontest": _eval_videomme,
    "nextqa_mc": _eval_videomme,
    "eventbench": _eval_videomme,
    "vnbench": _eval_videomme,
    "nuscenes": _eval_videomme,
    "vstar": _eval_scienceqa,
    "4kpro": _eval_scienceqa,
    # MMMU with the open-ended branch (mmmu_utils parity)
    "mmmu_open": _eval_mmmu,
    # open-ended judged QA (LLM judge optional; containment fallback)
    "activitynetqa": _eval_openqa,
    "videochatgpt": _eval_openqa,
    "nextqa_oe": _eval_openqa,
    "mmvet": _eval_openqa,
    "llava_wild": _eval_openqa,
    # VQA-accuracy family
    "pathvqa": _eval_textvqa,
    "pmcvqa": _eval_textvqa,
    # UI action prediction
    "aitz": _eval_aitz,
}


def _generate(engine, ex, question: str, gen, media_root: str) -> str:
    from vila_tpu_torch.media import Image, Video

    prompt: List[Any] = []
    if ex.get("image"):
        prompt.append(Image(os.path.join(media_root, ex["image"])))
    if ex.get("video"):
        prompt.append(Video(os.path.join(media_root, ex["video"])))
    prompt.append(question)
    return engine.generate_content(prompt, gen)


def _aggregate(task: str, rows: List[Dict[str, float]]) -> Dict[str, float]:
    if task == "mme":
        return _aggregate_mme(rows)
    if task == "caption":
        return _aggregate_caption(task, rows)
    n = max(len(rows), 1)
    metrics = {f"{task}/accuracy": sum(r["acc"] for r in rows) / n,
               f"{task}/count": float(len(rows))}
    if task == "refcoco":
        metrics["refcoco/mean_iou"] = sum(r["iou"] for r in rows) / n
    if task == "tallyqa":
        for key in ("simple", "complex"):
            k = sum(r.get("_has_" + key, 0.0) for r in rows)
            if k:
                metrics[f"tallyqa/{key}_accuracy"] = (
                    sum(r.get("_" + key, 0.0) for r in rows) / k
                )
    if task == "pope":
        tp = sum(r["tp"] for r in rows)
        fp = sum(r["fp"] for r in rows)
        fn = sum(r["fn"] for r in rows)
        prec = tp / max(tp + fp, 1e-9)
        rec = tp / max(tp + fn, 1e-9)
        metrics.update({
            "pope/precision": prec,
            "pope/recall": rec,
            "pope/f1": 2 * prec * rec / max(prec + rec, 1e-9),
            "pope/yes_ratio": sum(r["yes"] for r in rows) / n,
        })
    return metrics


# the committed fixtures (mini eval sets, the quant probe), read as data
# from the JAX package's directory beside this package
FIXTURE_ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "vila_tpu", "eval", "fixtures")


def resolve_dataset(path: str) -> str:
    """`fixture:mini/pope.jsonl` -> the committed fixture file
    (`FIXTURE_ROOT`; data_prepare/make_mini_eval_fixture.py made them)."""
    if path.startswith("fixture:"):
        return os.path.join(FIXTURE_ROOT, path[len("fixture:"):])
    return path


def load_dataset(path: str) -> List[Dict[str, Any]]:
    path = resolve_dataset(path)
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def run_benchmark(
    engine,
    task: str,
    dataset: List[Dict[str, Any]],
    *,
    max_new_tokens: int = 32,
    media_root: str = "",
    limit: Optional[int] = None,
    concurrency: int = 1,
) -> Dict[str, Any]:
    """Run one benchmark. concurrency > 1 wraps the engine in the
    continuous batcher and evaluates examples from a thread pool, so
    decode steps batch across in-flight requests."""
    from vila_tpu_torch.inference.generate import GenerationConfig

    if task not in TASKS:
        raise ValueError(f"unknown benchmark: {task} (have {list(TASKS)})")
    gen = GenerationConfig(max_new_tokens=max_new_tokens)
    fn = TASKS[task]
    data = dataset[: limit or len(dataset)]

    if concurrency > 1:
        from concurrent.futures import ThreadPoolExecutor

        from vila_tpu_torch.serving.batcher import ContinuousBatcher

        # size the batcher's KV window off the engine's, not the 2048
        # default — video prompts that fit serially must also fit here
        batcher = ContinuousBatcher(
            engine,
            max_batch=concurrency,
            max_len=getattr(engine, "max_cache_len", 2048),
        )
        try:
            with ThreadPoolExecutor(max_workers=concurrency) as pool:
                outs = list(
                    pool.map(
                        lambda ex: fn(batcher, ex, gen, media_root), data
                    )
                )
        finally:
            batcher.shutdown()
    else:
        outs = [fn(engine, ex, gen, media_root) for ex in data]

    results, rows = [], []
    for ex, (pred, scores) in zip(data, outs):
        rows.append(scores)
        public = {k: v for k, v in scores.items() if not k.startswith("_")}
        results.append({**ex, "prediction": pred, **public})
    return {"results": results, "metrics": _aggregate(task, rows)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("vila_tpu_torch.eval.benchmarks")
    p.add_argument("--task", required=True, choices=sorted(TASKS))
    p.add_argument("--model-path", required=True)
    p.add_argument("--dataset", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--media-root", default="")
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument(
        "--concurrency", type=int, default=1,
        help="route generation through the continuous batcher "
        "with this many in-flight requests",
    )
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    media_root = args.media_root
    if not media_root and args.dataset.startswith("fixture:"):
        media_root = os.path.dirname(resolve_dataset(args.dataset))

    from vila_tpu_torch.entry import load

    engine = load(args.model_path, device=args.device)
    out = run_benchmark(
        engine, args.task, load_dataset(args.dataset),
        max_new_tokens=args.max_new_tokens,
        media_root=media_root, limit=args.limit,
        concurrency=args.concurrency,
    )
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "results.json"), "w") as f:
        json.dump(out["results"], f, indent=2)
    with open(os.path.join(args.output_dir, "metrics.json"), "w") as f:
        json.dump(out["metrics"], f, indent=2)
    print(json.dumps(out["metrics"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
