"""Corpus captioning metrics: BLEU-1..4, ROUGE-L, CIDEr.

Native rebuilds of the pycocoevalcap scorers the reference's coco_cap task
drives (lmms-eval/lmms_eval/tasks/coco_cap/utils.py:44-99 — Bleu/Rouge/Cider
over PTB-tokenized hypothesis/reference pools). Differences, documented:

- Tokenization: the reference shells out to the Stanford PTBTokenizer jar;
  this rebuild lower-cases, strips punctuation, and splits on whitespace —
  the same normalization family, no JVM. Scores are therefore comparable
  but not digit-identical to pycocoevalcap.
- METEOR and SPICE are omitted (both require external jars/models; the
  reference itself comments SPICE out, utils.py:14).

All scorers are corpus-level: they take parallel lists of hypothesis
strings and reference-list-of-strings.

The port's own copy of the JAX package's ``harness/task_utils/captioning.py``.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

_PUNCT = re.compile(r"[^\w\s]")


def tokenize(s: str) -> List[str]:
    return _PUNCT.sub(" ", str(s).lower()).split()


def _ngrams(toks: Sequence[str], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


# ---------------------------------------------------------------------------
# BLEU (corpus-level, clipped counts, closest-ref brevity penalty)
# ---------------------------------------------------------------------------

def corpus_bleu(hyps: List[str], refs: List[List[str]],
                max_n: int = 4) -> List[float]:
    """Returns [BLEU_1, ..., BLEU_max_n] (cumulative, geometric mean)."""
    match = [0] * max_n
    total = [0] * max_n
    hyp_len = ref_len = 0
    for hyp, rlist in zip(hyps, refs):
        h = tokenize(hyp)
        rs = [tokenize(r) for r in rlist]
        hyp_len += len(h)
        # closest reference length (ties -> shorter), pycocoevalcap bleu
        ref_len += min((abs(len(r) - len(h)), len(r)) for r in rs)[1] \
            if rs else 0
        for n in range(1, max_n + 1):
            hc = _ngrams(h, n)
            if not hc:
                continue
            best = Counter()
            for r in rs:
                rc = _ngrams(r, n)
                for g, c in rc.items():
                    best[g] = max(best[g], c)
            match[n - 1] += sum(min(c, best[g]) for g, c in hc.items())
            total[n - 1] += sum(hc.values())
    bp = 1.0 if hyp_len > ref_len else math.exp(1 - ref_len / max(hyp_len, 1))
    out, log_sum = [], 0.0
    for n in range(max_n):
        p = match[n] / total[n] if total[n] else 0.0
        if p <= 0:
            # no smoothing (pycocoevalcap default): a zero p_n zeroes BLEU_k
            # for every k >= n
            out.extend([0.0] * (max_n - n))
            break
        log_sum += math.log(p)
        out.append(round(bp * math.exp(log_sum / (n + 1)), 6))
    return out


# ---------------------------------------------------------------------------
# ROUGE-L (corpus mean of per-pair max-over-refs LCS F, beta=1.2)
# ---------------------------------------------------------------------------

def _lcs(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(cur[-1], prev[j]))
        prev = cur
    return prev[-1]


def rouge_l(hyps: List[str], refs: List[List[str]],
            beta: float = 1.2) -> float:
    scores = []
    for hyp, rlist in zip(hyps, refs):
        h = tokenize(hyp)
        best = 0.0
        for r in rlist:
            rt = tokenize(r)
            l = _lcs(h, rt)
            if l == 0:
                continue
            prec, rec = l / len(h), l / len(rt)
            best = max(best, ((1 + beta ** 2) * prec * rec)
                       / (rec + beta ** 2 * prec))
        scores.append(best)
    return sum(scores) / len(scores) if scores else 0.0


# ---------------------------------------------------------------------------
# CIDEr (TF-IDF n-gram cosine, n=1..4 averaged, sigma=6 length penalty, x10)
# ---------------------------------------------------------------------------

def cider(hyps: List[str], refs: List[List[str]], max_n: int = 4,
          sigma: float = 6.0) -> float:
    hyp_toks = [tokenize(h) for h in hyps]
    ref_toks = [[tokenize(r) for r in rlist] for rlist in refs]
    # document frequency over reference SETS (one doc = one image's refs)
    df = [defaultdict(float) for _ in range(max_n)]
    for rlist in ref_toks:
        for n in range(1, max_n + 1):
            seen = set()
            for r in rlist:
                seen.update(_ngrams(r, n))
            for g in seen:
                df[n - 1][g] += 1.0
    n_imgs = max(len(ref_toks), 1)
    log_ref = math.log(float(n_imgs))

    def vec(toks):
        out, norms, lengths = [], [], []
        for n in range(1, max_n + 1):
            counts = _ngrams(toks, n)
            v = {}
            for g, c in counts.items():
                idf = max(log_ref - math.log(max(df[n - 1].get(g, 0.0), 1.0)),
                          0.0)
                v[g] = c * idf
            out.append(v)
            norms.append(math.sqrt(sum(x * x for x in v.values())))
            lengths.append(sum(counts.values()))
        return out, norms, lengths[0] if lengths else 0

    scores = []
    for h, rlist in zip(hyp_toks, ref_toks):
        hv, hn, hl = vec(h)
        pair = 0.0
        for r in rlist:
            rv, rn, rl = vec(r)
            sim = 0.0
            for n in range(max_n):
                dot = sum(min(hv[n].get(g, 0.0), w) * w
                          for g, w in rv[n].items())
                if hn[n] > 0 and rn[n] > 0:
                    sim += (dot / (hn[n] * rn[n])) \
                        * math.exp(-((hl - rl) ** 2) / (2 * sigma ** 2))
            pair += sim / max_n
        scores.append(10.0 * pair / max(len(rlist), 1))
    return sum(scores) / len(scores) if scores else 0.0


def caption_scores(rows: List[Dict]) -> Dict[str, float]:
    """aggregate_extra hook: rows carry host-local '_pred'/'_refs' strings
    (dropped by multi-host gather — corpus captioning is single-host)."""
    pairs = [(r["_pred"], r["_refs"]) for r in rows
             if isinstance(r.get("_pred"), str) and r.get("_refs")]
    if not pairs:
        return {}
    hyps = [p for p, _ in pairs]
    refs = [list(rf) for _, rf in pairs]
    bleu = corpus_bleu(hyps, refs)
    return {"coco_Bleu_1": bleu[0], "coco_Bleu_2": bleu[1],
            "coco_Bleu_3": bleu[2], "coco_Bleu_4": bleu[3],
            "coco_ROUGE_L": rouge_l(hyps, refs),
            "coco_CIDEr": cider(hyps, refs)}
