"""Judge-backed pairwise-review tasks: LLaVA-Bench (In-the-Wild / COCO).

The reference scores these with a GPT-4 pairwise review: the judge sees the
image captions as context, the GPT-4 reference answer as Assistant 1 and
the model answer as Assistant 2, and emits 'score1 score2' on a 1-10 scale
(llava-in-the-wild/utils.py:117-160 + rule.json); the reported metric per
category is mean(score2)/mean(score1)*100 (utils.py:180-199
llava_aggregation).

Here the judge seam is pluggable (msd_tpu_torch.harness.judge): with
``--judge endpoint:URL`` the review runs against a local LLM endpoint with
the reference's exact content layout and rubric; offline the fallback is a
deterministic proxy — Assistant 1 (the reference answer) anchors at 10 and
the model answer scores 10 * tokenF1(pred, gpt_answer) — which preserves
the metric's shape (<=100, higher is better) but is NOT comparable to
GPT-judged numbers (documented in PARITY.md).

The port's own copy of the JAX package's ``harness/tasks_judge.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig


def _token_f1(pred: str, ref: str) -> float:
    tp = re.findall(r"\w+", str(pred).lower())
    tr = re.findall(r"\w+", str(ref).lower())
    if not tp or not tr:
        return 0.0
    from collections import Counter
    common = Counter(tp) & Counter(tr)
    n = sum(common.values())
    if n == 0:
        return 0.0
    p, r = n / len(tp), n / len(tr)
    return 2 * p * r / (p + r)


def _synth_image(i: int):
    rng = np.random.default_rng(i + 17)
    return rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8)


_CATS = ("conv", "detail", "complex")


def make_llava_bench(name: str = "llava_in_the_wild",
                     dataset_path=None) -> TaskConfig:
    """name: 'llava_in_the_wild' or 'llava_bench_coco' (same schema/rubric;
    different datasets — llava-in-the-wild.yaml / llava-bench-coco.yaml)."""

    def _text(d):
        return str(d["question"])

    def _vis(d):
        return [d["image"]]

    def _res(d: Dict, r: List[str]) -> Dict:
        from msd_tpu_torch.harness.judge import llava_pairwise_scores
        caps = d.get("caption", [])
        context = "\n".join(caps) if isinstance(caps, list) else str(caps)
        ans1 = str(d.get("gpt_answer", ""))
        ans2 = str(r[0]) if r else ""
        scores = llava_pairwise_scores(context, d.get("question", ""),
                                       ans1, ans2)
        if scores is None:  # offline deterministic proxy
            scores = (10.0, 10.0 * _token_f1(ans2, ans1))
        cat = str(d.get("category", "conv"))
        out = {"_pair_all": (scores[0], scores[1])}
        for c in _CATS:
            out[f"_pair_{c}"] = ((scores[0], scores[1])
                                 if c == cat else None)
        return out

    def _agg_pairs(rows, key):
        pairs = [row[key] for row in rows if row.get(key) is not None]
        if not pairs:
            return 0.0
        s1 = float(np.mean([p[0] for p in pairs]))
        s2 = float(np.mean([p[1] for p in pairs]))
        return round(s2 / max(s1, 1e-9) * 100, 1)

    def _agg(rows):
        out = {"gpt_eval_llava_all": _agg_pairs(rows, "_pair_all")}
        for c in _CATS:
            out[f"gpt_eval_llava_{c}"] = _agg_pairs(rows, f"_pair_{c}")
        return out

    def _synth(n):
        return [{
            "question": f"Describe the scene in image {i}.",
            "gpt_answer": f"A colorful test pattern number {i} with random "
                          "pixels.",
            "caption": [f"a random test pattern, id {i}"],
            "category": _CATS[i % 3],
            "question_id": i,
            "image": _synth_image(i)} for i in range(n)]

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
        # the per-doc values are (score1, score2) pairs under private
        # keys; every reported metric comes from aggregate_extra (the
        # reference reports ratio-of-means, not mean-of-ratios)
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


def register_judge_tasks(p) -> None:
    from msd_tpu_torch.harness.registry import register_task
    register_task("llava_in_the_wild",
                  make_llava_bench("llava_in_the_wild",
                                   p("llava-bench-in-the-wild")))
    register_task("llava_bench_coco",
                  make_llava_bench("llava_bench_coco", p("llava-bench-coco")))
    # multilingual-llava-bench-in-the-wild: the SAME schema, rubric, and
    # pairwise-review pipeline per language (its utils.py is a copy of
    # llava-in-the-wild's with per-language datasets); one registration
    # per language yaml in the reference dir.
    for lang in ("arabic", "bengali", "chinese", "french", "hindi",
                 "japanese", "russian", "spanish", "urdu"):
        register_task(
            f"llava_in_the_wild_{lang}",
            make_llava_bench(f"llava_in_the_wild_{lang}",
                             p(f"multilingual-llava-bench/{lang}")))
