"""MathVerse query construction + offline scoring.

Rebuilds tasks/mathverse/utils.py (doc_to_text via the dataset's
query_wo/query_cot fields, process_results) and the offline parts of
mathverse_evals.py (create_one_query :215-276 format-prompt path,
eval_results :278-320). The reference's GPT extract/match steps are
replaced with the deterministic local extractor shared with MathVista.

The port's own copy of the JAX package's ``harness/task_utils/mathverse.py``.
"""

from __future__ import annotations

import re
from typing import Dict, List

from msd_tpu_torch.harness.task_utils.mathvista import extract_answer, safe_equal


def create_query(problem: Dict, shot_type: str = "format-prompt",
                 query_type: str = "query_wo") -> str:
    """Zero-shot query (mathverse_evals.py:247-276)."""
    if shot_type == "format-prompt":
        return str(problem[query_type]).strip()
    # custom-prompt: hint + bare question
    if problem.get("question_type") == "multi-choice":
        hint = ("Please answer the question and provide the correct option "
                "letter at the end.")
    else:
        hint = ("Please answer the question and provide the final answer at "
                "the end.")
    return f"{hint}\nQuestion: {problem['question']}".strip()


def doc_to_text(doc: Dict, query_type: str = "query_wo") -> str:
    return create_query({
        "question": doc.get("question", ""),
        "question_type": doc.get("question_type", "free-form"),
        "query_wo": doc.get("query_wo", doc.get("question", "")),
        "query_cot": doc.get("query_cot", doc.get("question", "")),
    }, query_type=query_type)


def doc_to_visual(doc: Dict) -> List:
    img = doc.get("image")
    if img is None or (isinstance(img, str) and not img.strip()):
        return []
    return [img.convert("RGB") if hasattr(img, "convert") else img]


def score_answer(question: str, answer, extraction) -> bool:
    """Offline analog of mathverse_evals.score_answer: exact match after
    normalization; for multi-choice-looking answers fall back to closest-
    choice matching on single letters."""
    if answer is None:
        return False
    if safe_equal(extraction, answer):
        return True
    a, e = str(answer).strip(), str(extraction).strip()
    if len(a) == 1 and a.isalpha() and e:
        # option-letter answers: accept "(B)", "B.", "B) ..." forms by
        # extracting the LEADING letter (anchored + delimited — an
        # unanchored scan matched the 'h' in "The ...")
        m = re.match(r"\(?([A-Ha-h])\)?(?:[.):\s]|$)", e)
        return bool(m) and m.group(1).upper() == a.upper()
    try:
        return abs(float(e) - float(a)) < 1e-6
    except (TypeError, ValueError):
        return False


def process_results(doc: Dict, results: List[str]) -> Dict[str, float]:
    problem = {
        "question_type": doc.get("question_type", "free-form"),
        "answer_type": "text",
        "choices": [],
    }
    extraction = extract_answer(results[0].strip(), problem)
    ok = score_answer(doc.get("question", ""), doc.get("answer"), extraction)
    return {"gpt_eval_score": 1.0 if ok else 0.0}
