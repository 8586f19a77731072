"""MM-UPD (Unsolvable Problem Detection): mmaad / mmiasd / mmivqd in
base / option / instruction variants.

Reference: lmms_eval/tasks/mmupd/utils.py + mmupd_evals.py. Each question
appears as a `standard` row (answerable — the gold option is present) and
an `upd` row (unsolvable — for AAD the gold option is removed, for IASD the
options are swapped to an irrelevant set, for IVQD the image is
incompatible). Rows pair via ``index % 1e6`` (mmbench circular-eval
convention, mmupd_evals.py:536-566). The reported metric is **dual
accuracy** (calculate_dual_acc, :600-618): a question scores only when its
standard row is answered with the gold option AND its upd row abstains.

Grading (offline analog of mmupd_evals.py:464-495 eval_sub_data): the
prediction letter is inferred with the mmbench can_infer rules; a upd row
is correct when the inferred letter maps to no real option and the text
matches an abstention form, or (instruction variant) the model answers
'F. None of the above' (build_option_str_w_gt answer_option semantics,
:154-258). The reference resolves un-inferrable predictions with a GPT
call (extract_answer_from_item); offline those score 0 — documented in
PARITY.md.

The port's own copy of the JAX package's ``harness/tasks_mmupd.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image
from msd_tpu_torch.harness.registry import register_task
from msd_tpu_torch.harness.tasks_mmbench import can_infer

_POST = {
    "base": "\n",
    "option": "\nAnswer with the option's letter from the given choices "
              "directly.",
    "inst": '\nIf all the options are incorrect, answer "F. None of the '
            'above".',
}

# abstention phrasings accepted for upd rows (build_option_str_w_gt's
# injected none-options, mmupd_evals.py:160-258, collapsed to their text)
_ABSTAIN = re.compile(
    r"none of the above|no answer|cannot answer|can not answer|"
    r"all (?:provided )?options are (?:incorrect|irrelevant)|"
    r"image is incompatible|question are irrelevant|i cannot",
    re.IGNORECASE)


def _is_none_opt(v) -> bool:
    s = str(v).strip().lower()
    return s in ("", "nan", "none", "n/a") or v is None


def _choices(d: Dict) -> Dict[str, str]:
    return {c: str(d[c]) for c in "ABCDE"
            if c in d and not _is_none_opt(d.get(c))}


def mmupd_grade_row(d: Dict, pred: str, question_type: str) -> float:
    """1.0 when this row is answered acceptably (standard: gold letter;
    upd: abstention / 'F' under the instruction variant)."""
    ch = _choices(d)
    letter = can_infer(pred, ch)
    gold = str(d.get("answer", "")).strip().upper()
    if str(d.get("type", "standard")) == "standard":
        return 1.0 if letter and letter == gold else 0.0
    # upd row: correct = abstain. A confident pick of a REAL option is
    # wrong; 'F' counts under inst (the prompt offers F. None of the
    # above); otherwise look for an abstention phrase.
    if letter and letter in ch:
        return 0.0
    if question_type == "inst" and (letter == "F"
                                    or can_infer(pred, {"F": "None of the "
                                                        "above"}) == "F"):
        return 1.0
    return 1.0 if _ABSTAIN.search(str(pred)) else 0.0


def make_mmupd(upd_type: str, question_type: str,
               dataset_path=None) -> TaskConfig:
    name = {"aad": "mmaad", "iasd": "mmiasd", "ivqd": "mmivqd"}[upd_type] \
        + "_" + {"base": "base", "option": "option",
                 "inst": "instruction"}[question_type]

    def _text(d):
        opts = "".join(f"\n{c}. {v}" for c, v in _choices(d).items())
        hint = d.get("hint")
        q = (f"{hint}\n{d['question']}{opts}"
             if hint and str(hint) != "nan" else f"{d['question']}{opts}")
        return q + _POST[question_type]

    def _res(d, r):
        ok = mmupd_grade_row(d, str(r[0]).strip(), question_type)
        return {"_row_ok": ok,
                "_idx": int(d.get("index", 0)),
                "_type": str(d.get("type", "standard")),
                "_cat": str(d.get("category", ""))}

    def _agg(rows):
        # circular grouping: every row of a pair-group must be acceptable
        def _hit_by_group(kind):
            groups: Dict[int, bool] = {}
            for row in rows:
                if row["_type"] != kind:
                    continue
                g = row["_idx"] % int(1e6)
                groups[g] = groups.get(g, True) and row["_row_ok"] >= 1.0
            return groups
        std, upd = _hit_by_group("standard"), _hit_by_group("upd")
        if not std and not upd:
            return {"gpt_eval_score": 0.0}
        acc_std = float(np.mean([1.0 if v else 0.0 for v in std.values()])
                        ) if std else 0.0
        acc_upd = float(np.mean([1.0 if v else 0.0 for v in upd.values()])
                        ) if upd else 0.0
        both = [g for g in std if g in upd]
        dual = float(np.mean([1.0 if std[g] and upd[g] else 0.0
                              for g in both])) if both else 0.0
        return {"gpt_eval_score": 100.0 * dual,
                "overall_acc_standard": acc_std,
                "overall_acc_upd": acc_upd}

    def _synth(n):
        docs = []
        for i in range(n // 2 + 1):
            base = {"question": f"What color is object {i}?",
                    "hint": "", "category": ("color", "shape")[i % 2],
                    "A": "red", "B": "green", "C": "blue", "D": "nan",
                    "E": "nan", "image": _synth_image(i)}
            gold = "ABC"[i % 3]
            docs.append(dict(base, index=i, type="standard",
                             answer=gold, masked_answer=""))
            # upd twin: the gold option is removed (AAD semantics; IASD/
            # IVQD real data swaps options / the image instead — the
            # grading path is identical)
            docs.append(dict(base, index=i + int(1e6), type="upd",
                             answer="F", masked_answer=base[gold],
                             **{gold: "nan"}))
        return docs[:max(n, 2)]

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


def register_mmupd_tasks(p) -> None:
    for upd in ("aad", "iasd", "ivqd"):
        for qt in ("base", "option", "inst"):
            t = make_mmupd(upd, qt, p("MMUPD"))
            register_task(t.name, t)
