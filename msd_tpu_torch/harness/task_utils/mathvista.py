"""MathVista answer extraction / normalization / scoring.

Rebuilds the offline parts of
lmms-eval/lmms_eval/tasks/mathvista/mathvista_evals.py (extract_answer
:232-279, normalize_extracted_answer :289-337, safe_equal :339-349,
create_one_query :364-430) and tasks/mathvista/utils.py (doc_to_text /
process_results).

The reference falls back to a GPT API call for free-form extraction; this
rebuild substitutes a deterministic local extractor (answer-phrase regexes,
then last-number / option-letter heuristics) — no network, reproducible.

The port's own copy of the JAX package's ``harness/task_utils/mathvista.py``:
the same rules, and the same judge call where they settle nothing.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional

from msd_tpu_torch.harness.metrics import _levenshtein


def get_most_similar(prediction: str, choices: List[str]) -> str:
    """Pick the edit-distance-closest choice (mathvista_evals.py:281-287)."""
    distances = [_levenshtein(str(prediction), str(c)) for c in choices]
    return choices[distances.index(min(distances))]


_ANSWER_PATTERNS = [
    re.compile(r'[Tt]he answer is "(.*?)"\.?'),   # quick_extract pattern
    re.compile(r"[Tt]he answer is:?\s*([^\n.]+)"),
    re.compile(r"[Aa]nswer:\s*([^\n.]+)"),
]
_NUMBER_RE = re.compile(r"-?\d+(?:\.\d+)?")
_LETTER_RE = re.compile(r"\(([a-zA-Z])\)|(?:^|\s)([A-H])(?:[.)\s]|$)")


def extract_answer(response: str, problem: Dict,
                   quick_extract: bool = False) -> str:
    """mathvista_evals.py:232-279 with a local fallback in place of GPT."""
    question_type = problem.get("question_type", "free_form")
    answer_type = problem.get("answer_type", "text")
    choices = problem.get("choices") or []
    if not response:
        return ""
    response = str(response).strip()

    if question_type == "multi_choice" and response in choices:
        return response
    if answer_type == "integer":
        try:
            return str(int(response))
        except ValueError:
            pass
    if answer_type == "float":
        try:
            return str(float(response))
        except ValueError:
            pass

    # answer-phrase extraction (covers quick_extract and the common
    # free-form phrasings the reference sends to GPT)
    for pat in _ANSWER_PATTERNS:
        m = pat.search(response)
        if m:
            return m.group(1).strip().strip('"')

    # judge-backed general extraction (mathvista_evals.py:262-280): only
    # consulted when the rules above did not settle it and a judge is
    # installed (harness --judge endpoint:URL); failure falls through
    from msd_tpu_torch.harness.judge import mathvista_judge_extract
    ext = mathvista_judge_extract(problem.get("query", ""), response)
    if ext:
        return ext

    if question_type == "multi_choice":
        m = _LETTER_RE.search(response)
        if m:
            return (m.group(1) or m.group(2)).upper()
        return response
    if answer_type in ("integer", "float"):
        nums = _NUMBER_RE.findall(response)
        if nums:
            return nums[-1]
    return response


def normalize_extracted_answer(extraction, choices: List[str],
                               question_type: str, answer_type: str,
                               precision) -> Optional[str]:
    """mathvista_evals.py:289-337 — letter->choice, numeric rounding."""
    if question_type == "multi_choice":
        extraction = str(extraction).strip() if extraction is not None else ""
        letter = re.findall(r"\(([a-zA-Z])\)", extraction)
        if letter:
            extraction = letter[0].upper()
        options = [chr(ord("A") + i) for i in range(len(choices))]
        if extraction in options:
            extraction = choices[options.index(extraction)]
        elif choices:
            extraction = get_most_similar(extraction, choices)
        return extraction
    if answer_type == "integer":
        try:
            return str(int(float(extraction)))
        except (TypeError, ValueError):
            return None
    if answer_type == "float":
        try:
            return str(round(float(extraction), int(precision or 0)))
        except (TypeError, ValueError):
            return None
    if answer_type == "list":
        try:
            return str(extraction)
        except Exception:
            return None
    return str(extraction) if extraction is not None else None


def safe_equal(prediction, answer) -> bool:
    try:
        return str(prediction).strip() == str(answer).strip()
    except Exception:
        return False


def create_query(problem: Dict, shot_type: str = "solution") -> str:
    """Zero-shot query construction (mathvista_evals.py create_one_query,
    shot_num=0 path): Question + Choices + unit/precision hints + the
    answer-format instruction per question/answer type."""
    question = problem["question"]
    unit = problem.get("unit") or ""
    choices = problem.get("choices") or []
    precision = problem.get("precision")
    question_type = problem.get("question_type", "free_form")
    answer_type = problem.get("answer_type", "text")

    q = f"Question: {question}"
    if unit:
        q += f" (Unit: {unit})"
    body = [q]
    if choices:
        texts = ["Choices:"]
        for i, c in enumerate(choices):
            texts.append(f"({chr(ord('A') + i)}) {c}")
        body.append("\n".join(texts))

    if shot_type == "solution":
        if question_type == "multi_choice":
            hint = ("Please answer the question and provide the correct "
                    "option letter, e.g., A, B, C, D, at the end.")
        elif answer_type == "integer":
            hint = ("Please answer the question requiring an integer answer "
                    "and provide the final value, e.g., 1, 2, 3, at the end.")
        elif answer_type == "float" and precision == 1:
            hint = ("Please answer the question requiring a floating-point "
                    "number with one decimal place and provide the final "
                    "value, e.g., 1.2, 1.3, 1.4, at the end.")
        elif answer_type == "float" and precision == 2:
            hint = ("Please answer the question requiring a floating-point "
                    "number with two decimal places and provide the final "
                    "value, e.g., 1.23, 1.34, 1.45, at the end.")
        else:
            hint = ("Please answer the question requiring an answer and "
                    "provide the final value at the end.")
        return f"{hint}\n{chr(10).join(body)}\nSolution: "
    body.append("Answer: ")
    return "\n".join(body)


# ---------------------------------------------------------------------------
# task hooks (tasks/mathvista/utils.py)
# ---------------------------------------------------------------------------

def doc_to_text(doc: Dict) -> str:
    problem = {
        "question_type": doc.get("question_type", "free_form"),
        "answer_type": doc.get("answer_type", "text"),
        "question": doc["question"],
        "unit": doc.get("unit", ""),
        "choices": doc.get("choices"),
        "precision": doc.get("precision", 0),
    }
    return create_query(problem)


def doc_to_visual(doc: Dict) -> List:
    img = doc.get("decoded_image", doc.get("image"))
    if img is None:
        return []
    return [img.convert("RGB") if hasattr(img, "convert") else img]


def process_results(doc: Dict, results: List[str]) -> Dict[str, float]:
    problem = {
        "question_type": doc.get("question_type", "free_form"),
        "answer_type": doc.get("answer_type", "text"),
        "query": doc.get("query", doc.get("question", "")),
        "choices": doc.get("choices") or [],
        "answer": doc.get("answer"),
        "precision": doc.get("precision", 0),
    }
    extraction = extract_answer(results[0].strip(), problem)
    prediction = normalize_extracted_answer(
        extraction, problem["choices"], problem["question_type"],
        problem["answer_type"], problem["precision"])
    ok = (safe_equal(prediction, problem["answer"])
          if problem["answer"] is not None else False)
    return {"gpt_eval_score": 1.0 if ok else 0.0}
