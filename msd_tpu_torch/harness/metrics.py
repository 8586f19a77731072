"""Benchmark metrics (native re-implementations, no vendored `evaluate`).

Covers the metrics of the tasks in BASELINE.json:
- relaxed_correctness (ChartQA; tasks/chartqa/utils.py relaxed_correctness —
  5% numeric tolerance, exact lowercase match otherwise)
- VQA accuracy with 10-annotator min(1, matches/3) rule + answer
  normalization (TextVQA; tasks/textvqa + vqa_eval processors)
- ANLS (edit-distance based, docvqa-style)
- exact_match / multiple-choice accuracy (AI2D, IconQA, MathVista-lite,
  MathVerse-lite)

The port's own copy of the JAX package's ``harness/metrics.py``.
"""

from __future__ import annotations

import re
import string
from typing import List, Sequence


# ---------------------------------------------------------------------------
# ChartQA relaxed correctness
# ---------------------------------------------------------------------------

def _to_float(text: str):
    try:
        if text.endswith("%"):
            return float(text.rstrip("%")) / 100.0
        return float(text)
    except ValueError:
        return None


def relaxed_correctness(prediction: str, target: str,
                        max_relative_change: float = 0.05) -> bool:
    """5% numeric tolerance (ChartQA, arXiv:2203.10244 §5.1)."""
    prediction = str(prediction).strip()
    target = str(target).strip()
    p, t = _to_float(prediction), _to_float(target)
    if p is not None and t:
        return abs(p - t) / abs(t) <= max_relative_change
    return prediction.lower() == target.lower()


# ---------------------------------------------------------------------------
# VQA accuracy (TextVQA)
# ---------------------------------------------------------------------------

_CONTRACTIONS = {"aint": "ain't", "arent": "aren't", "cant": "can't",
                 "couldve": "could've", "couldnt": "couldn't",
                 "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
                 "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't",
                 "hes": "he's", "im": "i'm", "isnt": "isn't", "its": "it's",
                 "lets": "let's", "shouldnt": "shouldn't", "thats": "that's",
                 "theres": "there's", "theyre": "they're", "wasnt": "wasn't",
                 "werent": "weren't", "whats": "what's", "wheres": "where's",
                 "wont": "won't", "wouldnt": "wouldn't", "youre": "you're"}
_NUM_WORDS = {"none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
              "four": "4", "five": "5", "six": "6", "seven": "7",
              "eight": "8", "nine": "9", "ten": "10"}
_ARTICLES = {"a", "an", "the"}
_PUNCT_RE = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!.]")


def vqa_normalize(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    ans = _PUNCT_RE.sub("", ans)
    ans = ans.replace(":", "")
    words = []
    for w in ans.split():
        w = _NUM_WORDS.get(w, w)
        w = _CONTRACTIONS.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    return " ".join(words)


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """min(1, #matching-annotators / 3) with normalization (VQAv2 rule)."""
    pred = vqa_normalize(prediction)
    norm = [vqa_normalize(a) for a in answers]
    if len(norm) <= 1:
        return float(pred == norm[0]) if norm else 0.0
    accs = []
    for i in range(len(norm)):
        others = norm[:i] + norm[i + 1:]
        matches = sum(1 for o in others if o == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs)


# ---------------------------------------------------------------------------
# ANLS
# ---------------------------------------------------------------------------

def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def anls(prediction: str, answers: Sequence[str],
         threshold: float = 0.5) -> float:
    best = 0.0
    p = str(prediction).strip().lower()
    for gt in answers:
        g = str(gt).strip().lower()
        if not p and not g:
            best = max(best, 1.0)
            continue
        d = _levenshtein(p, g)
        nl = d / max(len(p), len(g), 1)
        s = 1.0 - nl
        best = max(best, s if s >= threshold else 0.0)
    return best


# ---------------------------------------------------------------------------
# exact match / multiple choice
# ---------------------------------------------------------------------------

def normalize_extract(text: str) -> str:
    return str(text).strip().strip(".").strip().lower()


def exact_match(prediction: str, target: str) -> float:
    return float(normalize_extract(prediction) == normalize_extract(target))


_CHOICE_RE = re.compile(r"\b([A-H])\b")


def extract_choice(prediction: str, n_choices: int = 8) -> str:
    """Pull a letter choice out of free-form model output."""
    text = str(prediction).strip()
    if len(text) == 1 and text.upper() in string.ascii_uppercase[:n_choices]:
        return text.upper()
    m = _CHOICE_RE.search(text.upper())
    return m.group(1) if m else text.upper()[:1]


def mc_accuracy(prediction: str, target: str, n_choices: int = 8) -> float:
    return float(extract_choice(prediction, n_choices)
                 == str(target).strip().upper())


# ---------------------------------------------------------------------------
# aggregations
# ---------------------------------------------------------------------------

def mean(xs: List[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def bootstrap_stderr(xs: Sequence[float], iters: int = 1000,
                     seed: int = 1234) -> float:
    """Bootstrap standard error of the mean (the lmms-eval
    api/metrics.py bootstrap_stderr analog, deterministic seed)."""
    import numpy as np
    xs = np.asarray(list(xs), float)
    if len(xs) <= 1:
        return 0.0
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(xs), size=(iters, len(xs)))
    return float(xs[idx].mean(axis=1).std(ddof=1))


# ---------------------------------------------------------------------------
# referring-expression grounding (REC): bbox IoU family
# ---------------------------------------------------------------------------

_BOX_RE = re.compile(
    r"\[\s*(-?\d+(?:\.\d+)?)\s*,\s*(-?\d+(?:\.\d+)?)\s*,"
    r"\s*(-?\d+(?:\.\d+)?)\s*,\s*(-?\d+(?:\.\d+)?)\s*\]")


def parse_box(text: str) -> List[float]:
    """First `[x1, y1, x2, y2]` float sequence in the output, else zeros
    (tasks/refcoco/utils_rec.py parse_float_sequence_within)."""
    m = _BOX_RE.search(str(text))
    return [float(g) for g in m.groups()] if m else [0.0, 0.0, 0.0, 0.0]


def box_iou(box1: Sequence[float], box2: Sequence[float]) -> float:
    """IoU of two [x1, y1, x2, y2] boxes (refcoco/utils_rec.py compute_iou;
    degenerate/empty unions score 0 instead of dividing by zero)."""
    xl, yt = max(box1[0], box2[0]), max(box1[1], box2[1])
    xr, yb = min(box1[2], box2[2]), min(box1[3], box2[3])
    inter = max(0.0, xr - xl) * max(0.0, yb - yt)
    a1 = (box1[2] - box1[0]) * (box1[3] - box1[1])
    a2 = (box2[2] - box2[0]) * (box2[3] - box2[1])
    union = a1 + a2 - inter
    return inter / union if union > 0 else 0.0


def box_center_in(gt: Sequence[float], pred: Sequence[float]) -> float:
    """1.0 iff pred's center lies inside gt
    (refcoco/utils_rec.py compute_center_accuracy)."""
    cx, cy = (pred[0] + pred[2]) / 2, (pred[1] + pred[3]) / 2
    return float(gt[0] <= cx <= gt[2] and gt[1] <= cy <= gt[3])
