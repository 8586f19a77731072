"""MMMU prompt construction / answer parsing / scoring.

Rebuilds the offline scoring pipeline of
lmms-eval/lmms_eval/tasks/mmmu/utils.py (construct_prompt :44-53,
parse_multi_choice_response :273-330, parse_open_response :397-466,
normalize_str :373-394, extract_numbers :333-355, eval_multi_choice
:200-215, eval_open :218-240, mmmu_aggregate_results :108-144) as a
deterministic local module.

One documented deviation: when no option letter can be parsed from a
multiple-choice response the reference picks random.choice(all_choices)
(utils.py:308); this rebuild deterministically returns the FIRST choice so
results are reproducible run-to-run.

The port's own copy of the JAX package's ``harness/task_utils/mmmu.py``.
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from typing import Dict, List, Sequence

MULTI_CHOICE_PROMPT = ("Answer with the option's letter from the given "
                       "choices directly.")
OPEN_ENDED_PROMPT = "Answer the question using a single word or phrase."


def _options_list(options) -> List[str]:
    """MMMU stores options as a stringified python list (utils.py:48)."""
    if isinstance(options, str):
        try:
            options = ast.literal_eval(options)
        except (ValueError, SyntaxError):
            options = [options]
    return [str(o) for o in options]


def parse_options(options: Sequence[str]) -> str:
    letters = [chr(ord("A") + i) for i in range(len(options))]
    return "\n".join(f"{l}. {o}" for l, o in zip(letters, options))


def construct_prompt(doc: Dict) -> str:
    question = str(doc["question"])
    if doc.get("question_type") == "multiple-choice":
        question = (f"{question}\n{parse_options(_options_list(doc['options']))}"
                    f"\n\n{MULTI_CHOICE_PROMPT}")
    else:
        question = f"{question}\n\n{OPEN_ENDED_PROMPT}"
    # collapse the interleaved <image i> markers to the single-image token
    # convention the LLaVA prompt builder uses (utils.py:29-35)
    return re.sub(r"<image \d+>", "", question).strip()


def get_multi_choice_info(options: Sequence[str]):
    index2ans = {chr(ord("A") + i): str(o) for i, o in enumerate(options)}
    return index2ans, list(index2ans)


def parse_multi_choice_response(response: str, all_choices: List[str],
                                index2ans: Dict[str, str]) -> str:
    """Extract the predicted option letter (utils.py:273-330)."""
    for ch in [",", ".", "!", "?", ";", ":", "'"]:
        response = response.strip(ch)
    response = f" {response} "

    index_ans, ans_with_brack = True, False
    candidates: List[str] = []
    for choice in all_choices:                       # "(A)"
        if f"({choice})" in response:
            candidates.append(choice)
            ans_with_brack = True
    if not candidates:
        for choice in all_choices:                   # "A "
            if f"{choice} " in response:
                candidates.append(choice)
    if not candidates:
        for choice in all_choices:                   # "A."
            if f"{choice}." in response:
                candidates.append(choice)
    if not candidates and len(response.split()) > 5:
        for index, ans in index2ans.items():         # content match
            if ans.lower() in response.lower():
                candidates.append(index)
                index_ans = False
    if not candidates:
        return all_choices[0]  # deterministic stand-in for random.choice
    if len(candidates) == 1:
        return candidates[0]
    # several hits: keep the LAST-mentioned candidate (utils.py:311-327)
    starts = []
    for can in candidates:
        if index_ans and ans_with_brack:
            starts.append(response.rfind(f"({can})"))
        elif index_ans:
            starts.append(response.rfind(f" {can} "))
        else:
            starts.append(response.lower().rfind(index2ans[can].lower()))
    return candidates[max(range(len(starts)), key=starts.__getitem__)]


_NUM_COMMAS = re.compile(r"-?\b\d{1,3}(?:,\d{3})+\b")
_NUM_SCI = re.compile(r"-?\d+(?:\.\d+)?[eE][+-]?\d+")
_NUM_SIMPLE = re.compile(r"-?(?:\d+\.\d+|\.\d+|\d+\b)(?![eE][+-]?\d+)(?![,\d])")


def extract_numbers(s: str) -> List[str]:
    return (_NUM_COMMAS.findall(s) + _NUM_SCI.findall(s)
            + _NUM_SIMPLE.findall(s))


def _is_number(s: str) -> bool:
    try:
        float(s.replace(",", ""))
        return True
    except ValueError:
        return False


def normalize_str(s: str) -> List:
    """Lower-case strings; round numbers to 2 decimals (utils.py:373-394)."""
    s = str(s).strip()
    if _is_number(s):
        return [round(float(s.replace(",", "")), 2)]
    s = s.lower()
    if len(s) == 1:
        return [f" {s}", f"{s} "]  # pad 1-char answers to avoid substrings
    return [s]


_KEY_INDICATORS = ["could be ", "so ", "is ", "thus ", "therefore ",
                   "final ", "answer ", "result "]


def parse_open_response(response: str) -> List:
    """Candidate answers from a free-form response (utils.py:397-466)."""
    resp = str(response).strip().strip(".").lower()
    subs = re.split(r"\.\s(?=[A-Z])|\n", resp)
    keys: List[str] = []
    for i, sub in enumerate(subs):
        inds = _KEY_INDICATORS + (["="] if i == len(subs) - 1 else [])
        shortest = None
        for ind in inds:
            if ind in sub:
                tail = sub.split(ind)[-1].strip()
                if shortest is None or len(tail) < len(shortest):
                    shortest = tail
        if shortest and shortest.strip() not in list(",.!?;:'"):
            keys.append(shortest)
    if not keys:
        keys = [resp]
    preds = list(keys)
    for k in keys:
        preds.extend(extract_numbers(k))
    out: List = []
    for p in preds:
        out.extend(normalize_str(p))
    return list(dict.fromkeys(out))  # dedup, order-stable


def eval_multi_choice(gold, pred: str) -> bool:
    golds = gold if isinstance(gold, list) else [gold]
    return any(str(g) == pred for g in golds)


def eval_open(gold, pred_list: List) -> bool:
    norm_answers: List = []
    for g in (gold if isinstance(gold, list) else [gold]):
        norm_answers.extend(normalize_str(g))
    for pred in pred_list:
        if isinstance(pred, str):
            if any(isinstance(a, str) and a in pred for a in norm_answers):
                return True
        elif pred in norm_answers:
            return True
    return False


def extract_subset_name(doc_id: str) -> str:
    """'validation_Art_3' -> 'Art' (utils.py:89-96)."""
    m = re.search(r"^[^_]+_(.+?)_\d+$", str(doc_id))
    return m.group(1) if m else str(doc_id)


# numeric subdomain ids: per-doc metric values must stay float so multi-host
# _gather_metrics can allgather them (see the mme _pair_id note in tasks.py);
# the id->name table is host-local and only used for pretty aggregate keys.
_SUBDOMAIN_NAMES: Dict[float, str] = {}


def _subdomain_id(name: str) -> float:
    import zlib
    sid = float(zlib.crc32(name.encode()))
    _SUBDOMAIN_NAMES[sid] = name
    return sid


def process_results(doc: Dict, results: List[str]) -> Dict:
    pred = results[0]
    if doc.get("question_type") == "multiple-choice":
        index2ans, all_choices = get_multi_choice_info(
            _options_list(doc["options"]))
        parsed = parse_multi_choice_response(pred, all_choices, index2ans)
        correct = eval_multi_choice(doc["answer"], parsed)
    else:
        correct = eval_open(doc["answer"], parse_open_response(pred))
    return {"mmmu_acc": float(correct),
            "_subdomain_id": _subdomain_id(
                extract_subset_name(doc.get("id", "x"))),
            "_ok": float(correct)}


def aggregate_subdomains(rows: List[Dict]) -> Dict[str, float]:
    """Instruction-level per-subdomain accuracies (utils.py:108-144,
    calculate_ins_level_acc) — returned as extra metrics. The overall
    mmmu_acc mean equals the reference's instruction-level Overall acc
    because every instance carries unit weight."""
    buckets: Dict[float, List[float]] = defaultdict(list)
    for row in rows:
        sid = row.get("_subdomain_id")
        if sid is not None:
            buckets[sid].append(row.get("_ok", 0.0))
    out = {}
    for sid, vs in buckets.items():
        name = _SUBDOMAIN_NAMES.get(sid, f"id{int(sid)}")
        out[f"mmmu_acc_{name}"] = sum(vs) / len(vs)
    return dict(sorted(out.items()))
