"""Round-4b task tier: temporalbench, vitatecs, jmmmu, mmworld, youcook2,
video_detail_description, olympiadbench.

Each maker rebuilds the reference task's prompt + scoring semantics with
file:line citations. Judge-backed scorers route through the pluggable judge
(msd_tpu_torch.harness.judge) with deterministic offline fallbacks;
deviations are documented in PARITY.md.

The port's own copy of the JAX package's ``harness/tasks_ext3.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import ast
import random
import re
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image
from msd_tpu_torch.harness.registry import register_task


def _synth_video(i: int) -> np.ndarray:
    rng = np.random.default_rng(i + 31)
    return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)


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


# ---------------------------------------------------------------------------
# TemporalBench (temporalbench/utils.py)
# ---------------------------------------------------------------------------

def make_temporalbench(kind: str = "short_qa",
                       dataset_path=None) -> TaskConfig:
    """temporalbench/utils.py:106-152: binary accuracy compares the gold's
    first letter against the prediction's first character
    (``gt.lower() == pred[0].lower()``), and Multiple Binary Accuracy groups
    by video_name — a video counts only when ALL its QA pairs are correct.
    Per-dataset accuracies are attached the same way (:121-131). The
    short_caption variant's SentenceTransformer similarity (:54-87) is out
    of scope (needs a GPU embedding model); qa variants carry the full
    reference scoring."""
    def _res(d, r):
        pred = str(r[0]).strip()
        gt = str(d.get("GT", d.get("answer", ""))).strip()
        ok = 1.0 if pred and gt and pred[0].lower() == gt[0].lower() else 0.0
        return {"accuracy": ok,
                "_video": str(d.get("video_name", d.get("idx", ""))),
                "_dataset": str(d.get("dataset", ""))}

    def _agg(rows):
        per_video: Dict[str, bool] = {}
        per_ds: Dict[str, List[float]] = {}
        for row in rows:
            v = row["_video"]
            per_video[v] = per_video.get(v, True) and row["accuracy"] >= 1.0
            per_ds.setdefault(row["_dataset"], []).append(row["accuracy"])
        out = {"multiple_binary_accuracy":
               float(np.mean([1.0 if ok else 0.0
                              for ok in per_video.values()]))
               if per_video else 0.0}
        for ds, xs in sorted(per_ds.items()):
            if ds:
                out[f"binary_acc_{ds}"] = float(np.mean(xs))
        return out

    return TaskConfig(
        name=f"temporalbench_{kind}",
        doc_to_text=lambda d: str(d["question"]),
        doc_to_visual=lambda d: [d.get("video",
                                       d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16 if kind == "short_qa" else 64,
                    "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "idx": i,
            "question": f"Did event {i % 2} happen first? Answer A or B.\n"
                        "A. yes\nB. no",
            "GT": "AB"[i % 2],
            "video_name": f"vid{i // 2}",
            "dataset": ("somethingsomething", "charades")[i % 2],
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# VITATECS (vitatecs/utils.py)
# ---------------------------------------------------------------------------

def _vitatecs_qa(doc: Dict):
    """vitatecs/utils.py:91-105 format_question_and_answer: the A/B order is
    a deterministic function of the caption text (random seeded with
    sum(ord(c)) % 100) — a behavioral constant reproduced exactly."""
    cap = str(doc["caption"])
    cf = str(doc["counterfactual"])
    rng = random.Random()
    rng.seed(sum(ord(c) for c in cap + cf) % 100)

    def _q(s):  # process_option_for_question (:79-82)
        return s.strip(". ").capitalize()

    def _m(s):  # process_option_for_matching (:85-88)
        return s.strip(". ").lower()

    if rng.random() > 0.5:
        a, b, answer = _q(cap), _q(cf), None
        answer = "(A) " + a
    else:
        a, b = _q(cf), _q(cap)
        answer = "(B) " + b
    options = [_m(cap), _m(cf)]
    question = ("Which of the following best describes the content of the "
                f"video: \n(A) {a} \n(B) {b}")
    return question, answer, options


def make_vitatecs(aspect: str, dataset_path=None) -> TaskConfig:
    """vitatecs/utils.py:114-171 hand-crafted matching rules: full-option
    substring containment first, then bare/dotted/parenthesised letter
    forms; an unmatched prediction goes to the judge with the reference's
    caption-matching rubric (:138-143), offline scoring 0 (documented
    deviation — the reference cannot score it offline either)."""
    from msd_tpu_torch.harness import judge as J

    def _res(d, r):
        pred = str(r[0]).strip()
        question, answer, options = _vitatecs_qa(d)
        pl = pred.lower()
        rating = None
        if options[0] in pl and options[1] not in pl:
            rating = 1.0
        elif options[1] in pl and options[0] not in pl:
            rating = 0.0
        elif pred in ("A", "B"):
            rating = 1.0 if pred == answer[1] else 0.0
        elif pred[:2] in ("A.", "B."):
            rating = 1.0 if pred[0] == answer[1] else 0.0
        elif pred[:2] in ("A)", "B)"):
            rating = 1.0 if pred[0] == answer[1] else 0.0
        elif pred[:3] in ("(A)", "(B)"):
            rating = 1.0 if pred[1] == answer[1] else 0.0
        if rating is None:
            j = J.get_judge()
            out = None
            if j is not None:
                prompt = (
                    "You will receive a caption matching question, the "
                    "ground-truth answer and the prediction from a question "
                    "answering (QA) model. Your task is to determine whether "
                    "QA model prediction is correct, based on the question "
                    "and ground-truth answer. If the prediction is correct, "
                    'respond "Correct". If the prediction is incorrect, '
                    'respond "Incorrect". \n\n'
                    f"Caption Matching Question: {question}\n\n"
                    f"Ground-Truth Answer: {answer}\n\n"
                    f"Model Prediction: {pred}")
                out = j.complete(prompt, max_tokens=16)
            rating = 1.0 if out and "incorrect" not in out.lower() \
                and "correct" in out.lower() else 0.0
        return {"accuracy": rating}

    def _text(d):
        q, _, _ = _vitatecs_qa(d)
        return (q + "\nPlease only output the corresponding option and do "
                    "not output other irrelevant content.")

    return TaskConfig(
        name=f"vitatecs_{aspect.lower()}",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "caption": f"a person opens door {i}",
            "counterfactual": f"a person closes door {i}",
            "video_name": f"v{i}.mp4", "src_dataset": "synthetic",
            "aspect": aspect, "video": _synth_video(i)}
            for i in range(n)])


# ---------------------------------------------------------------------------
# JMMMU (jmmmu/utils.py — Japanese MMMU; reuses the MMMU parse pipeline)
# ---------------------------------------------------------------------------

def make_jmmmu(dataset_path=None) -> TaskConfig:
    """jmmmu/utils.py:45-90: MMMU construct_prompt with Japanese
    instruction strings (:15-16), the shared parse_multi_choice_response /
    parse_open_response pipeline, and per-subdomain aggregates keyed off
    the id prefix (extract_subset_name, :92-101)."""
    from msd_tpu_torch.harness.task_utils import mmmu as MU

    MC = "与えられた選択肢の中から最も適切な回答のアルファベットを直接記入してください。"
    OPEN = "質問に対する回答を単語や短いフレーズで記入してください。"

    def _opts(d) -> List[str]:
        o = d.get("options")
        if isinstance(o, str):
            o = ast.literal_eval(o)
        return [str(x) for x in (o or [])]

    def _text(d):
        q = str(d["question"]).replace("<image1>", "<image 1>")
        if d.get("question_type") == "multiple-choice":
            return f"{q}\n{MU.parse_options(_opts(d))}\n\n{MC}"
        return f"{q}\n\n{OPEN}"

    def _vis(d):
        toks = sorted(set(re.findall(r"<image \d+>", _text(d))))
        keys = [t.strip("<>").replace(" ", "_") for t in toks]
        return [d[k] for k in keys if d.get(k) is not None] \
            or [v for k, v in d.items()
                if k.startswith("image") and v is not None][:1]

    def _res(d, r):
        if d.get("question_type") == "multiple-choice":
            index2ans, all_choices = MU.get_multi_choice_info(_opts(d))
            pred = MU.parse_multi_choice_response(str(r[0]), all_choices,
                                                  index2ans)
            ok = MU.eval_multi_choice(d.get("answer"), pred)
        else:
            ok = MU.eval_open(d.get("answer"),
                              MU.parse_open_response(str(r[0])))
        sub = MU.extract_subset_name(str(d.get("id", "validation_misc_0")))
        return {"accuracy": 1.0 if ok else 0.0, f"_sub_{sub}": 1.0 if ok
                else 0.0}

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_sub_")}
        return {k[len("_sub_"):]: float(np.mean([r[k] for r in rows
                                                 if k in r]))
                for k in sorted(keys)}

    return TaskConfig(
        name="jmmmu",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "id": f"validation_Physics_{i}",
            "question": f"<image 1> 選択肢 {i % 4} はどれですか？",
            "options": str([f"選択肢 {j}" for j in range(4)]),
            "answer": "ABCD"[i % 4],
            "question_type": "multiple-choice",
            "image_1": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# MMWorld (mmworld/utils.py)
# ---------------------------------------------------------------------------

def make_mmworld(dataset_path=None) -> TaskConfig:
    """mmworld/utils.py:85-132: fixed option_prompt + str(options), answer
    prefixes stripped then first standalone [ABCD]
    (extract_characters_regex, :95-114), per-discipline accuracies
    (:135-170)."""
    _PREFIXES = ("The best answer is", "The correct answer is",
                 "The answer is", "The answer",
                 "The best option isThe correct option is",
                 "Best answer:Best option:")

    def _letter(s: str) -> str:
        s = str(s).strip()
        for p in _PREFIXES:
            s = s.replace(p, "")
        if len(s.split()) > 10 and not re.search("[ABCD]", s):
            return ""
        m = re.search(r"[ABCD]", s)
        return m[0] if m else ""

    def _text(d):
        return ("Select the best answer to the following multiple-choice "
                "question based on the video and the subtitles. Respond "
                "with only the letter (A, B, C, or D) of the correct "
                "option.\n" + str(d["question"]) + "\n"
                + str(d.get("options", "")) + "\nThe best answer is:")

    def _res(d, r):
        gold = str(d.get("correct_answer_label", d.get("answer", ""))
                   ).upper()
        ok = 1.0 if _letter(r[0]) == gold and gold else 0.0
        disc = str(d.get("discipline", ""))
        out = {"accuracy": ok}
        if disc:
            out[f"_disc_{disc}"] = ok
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_disc_")}
        return {k[len("_disc_"):]: float(np.mean([r[k] for r in rows
                                                  if k in r]))
                for k in sorted(keys)}

    return TaskConfig(
        name="mmworld",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d.get("video", d.get("video_id", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "options": str([f"{c}. option {j}"
                            for j, c in enumerate("ABCD")]),
            "correct_answer_label": "abcd"[i % 4],
            "discipline": ("Science", "Tech & Engineering", "Sports "
                           "& Arts")[i % 3],
            "video_id": f"v{i}", "video": _synth_video(i)}
            for i in range(n)])


# ---------------------------------------------------------------------------
# YouCook2 (youcook2/utils.py — video captioning, COCO metric family)
# ---------------------------------------------------------------------------

def make_youcook2(dataset_path=None) -> TaskConfig:
    """youcook2/utils.py:46-130: fixed one-sentence caption prompt; refs
    from doc['sentence'] with non-ASCII stripped (:20-22); corpus
    BLEU-1..4 / ROUGE-L / CIDEr via the native captioning stack (METEOR /
    SPICE need external jars — documented deviation, PARITY.md)."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    def _ascii(t: str) -> str:
        return "".join(c for c in str(t) if ord(c) < 128)

    def _res(d, r):
        return {"_pred": _ascii(r[0] if r else ""),
                "_refs": [_ascii(d.get("sentence", ""))]}

    return TaskConfig(
        name="youcook2_val",
        doc_to_text=lambda d: ("Provide a one-sentence caption for the "
                               "provided video."),
        doc_to_visual=lambda d: [d.get("video", d.get("video_path", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=C.caption_scores,
        synthetic_docs=lambda n: [{
            "youtube_id": f"y{i}", "segment": [0, 5],
            "sentence": f"a cook stirs ingredient {i} in a pan",
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# Video detail description (video_detail_description/utils.py)
# ---------------------------------------------------------------------------

def make_video_detail_description(dataset_path=None) -> TaskConfig:
    """video_detail_description/utils.py:86-220: the GPT detail-orientation
    rubric returns {'score': 0..5}; reported metric is the mean score.
    Offline fallback: 5 * tokenF1(pred, gold caption) — same range,
    documented deviation."""
    from msd_tpu_torch.harness import judge as J

    _SYS = (
        "You are an intelligent chatbot designed for evaluating the detail "
        "orientation of generative outputs for video-based question-answer "
        "pairs. Your task is to compare the predicted answer with the "
        "correct answer and determine its level of detail, considering "
        "both completeness and specificity. Here's how you can accomplish "
        "the task:------##INSTRUCTIONS: - Check if the predicted answer "
        "covers all major points from the video. The response should not "
        "leave out any key aspects.\n- Evaluate whether the predicted "
        "answer includes specific details rather than just generic points. "
        "It should provide comprehensive information that is tied to "
        "specific elements of the video.\n- Consider synonyms or "
        "paraphrases as valid matches.\n- Provide a single evaluation "
        "score that reflects the level of detail orientation of the "
        "prediction, considering both completeness and specificity.")

    def _res(d, r):
        q = str(d.get("question",
                      "Describe the video in detail."))
        gold = str(d.get("answer", d.get("caption", "")))
        pred = str(r[0]) if r else ""
        j = J.get_judge()
        score = None
        if j is not None:
            user = ("Please evaluate the following video-based "
                    "question-answer pair:\n\n"
                    f"Question: {q}\nCorrect Answer: {gold}\n"
                    f"Predicted Answer: {pred}\n\n"
                    "Provide your evaluation only as a detail orientation "
                    "score where the detail orientation score is an integer "
                    "value between 0 and 5, with 5 indicating the highest "
                    "level of detail orientation. Please generate the "
                    "response in the form of a Python dictionary string "
                    "with keys 'score', where its value is the detail "
                    "orientation score in INTEGER, not STRING."
                    "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. "
                    "Only provide the Python dictionary string. For "
                    "example, your response should look like this: "
                    "{'score': 4.8}.")
            out = j.complete(user, max_tokens=64, system=_SYS)
            if out:
                m = re.search(r"['\"]score['\"]\s*:\s*([0-9.]+)", out)
                if m:
                    try:
                        score = min(5.0, float(m.group(1)))
                    except ValueError:
                        score = None
        if score is None:
            score = 5.0 * _token_f1(pred, gold)
        return {"gpt_eval_score": score}

    return TaskConfig(
        name="video_detail_description",
        doc_to_text=lambda d: str(d.get(
            "question", "Describe the video in detail.")),
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        synthetic_docs=lambda n: [{
            "question": "Describe the video in detail.",
            "answer": f"a person walks through scene {i} holding a red "
                      "umbrella while rain falls",
            "video_name": f"v{i}", "video": _synth_video(i)}
            for i in range(n)])


# ---------------------------------------------------------------------------
# OlympiadBench (olympiadbench/en_utils.py + olympiadbench_evals.py)
# ---------------------------------------------------------------------------

def _math_equal(pred: str, gold: str, precision: float) -> bool:
    """Native analog of olympiadbench_evals.MathJudger.judge (:72-200):
    strip LaTeX wrappers, compare numerically within the per-doc precision
    when both sides parse as numbers, else sympy-simplify the difference.
    Multiple comma-joined answers must all match (order-insensitive)."""
    def _clean(s: str) -> str:
        s = str(s).strip().strip("$").replace("\\left", "").replace(
            "\\right", "")
        s = s.replace("\\,", "").replace("\\!", "").replace("°", "")
        s = re.sub(r"\\text\{[^}]*\}", "", s)
        s = re.sub(r"\\mathrm\{[^}]*\}", "", s)
        return s.strip().rstrip(".")

    def _one(p: str, g: str) -> bool:
        p, g = _clean(p), _clean(g)
        if not p or not g:
            return p == g
        if p == g:
            return True
        eps = max(float(precision or 0.0), 1e-8)
        try:
            pv, gv = float(p), float(g)
            return abs(pv - gv) <= eps * max(1.0, abs(gv))
        except ValueError:
            pass
        def _delatex(s: str) -> str:
            # sympy's parse_latex needs antlr4 (absent here); cover the
            # common competition-answer forms by rewriting to sympy syntax
            for _ in range(4):  # nested fractions
                s = re.sub(r"\\[dt]?frac\{([^{}]*)\}\{([^{}]*)\}",
                           r"((\1)/(\2))", s)
            s = re.sub(r"\\sqrt\{([^{}]*)\}", r"sqrt(\1)", s)
            s = re.sub(r"\^\{([^{}]*)\}", r"**(\1)", s)
            s = s.replace("\\pi", "pi").replace("\\cdot", "*")
            s = s.replace("\\times", "*").replace("^", "**")
            s = s.replace("{", "(").replace("}", ")").replace("\\", "")
            return s

        try:
            import sympy

            def _expr(s):
                try:
                    return sympy.sympify(s)
                except Exception:
                    return sympy.sympify(_delatex(s))
            diff = sympy.simplify(_expr(p) - _expr(g))
            if diff == 0:
                return True
            try:
                return abs(float(diff)) <= eps
            except (TypeError, ValueError):
                return False
        except Exception:
            return False

    ps = [x for x in re.split(r"[,，]", str(pred)) if x.strip()]
    gs = [x for x in re.split(r"[,，]", str(gold)) if x.strip()]
    if len(ps) != len(gs):
        return _one(pred, gold)
    used = [False] * len(gs)
    for p in ps:
        hit = next((j for j, g in enumerate(gs)
                    if not used[j] and _one(p, g)), None)
        if hit is None:
            return False
        used[hit] = True
    return True


def make_olympiadbench(dataset_path=None) -> TaskConfig:
    """olympiadbench/en_utils.py:22-65: competition prompt with
    subfield/answer_type framing and the '\\boxed{answer}' ending; the
    prediction is the text after 'final answer is' with spaces/quotes
    stripped (:60-62), judged by math equivalence within doc['error']
    precision. Proof questions ('TP' sources) are excluded from accuracy —
    the reference only dumps them to a submission file (:58-59)."""
    def _text(d):
        sub = d.get("subfield", "Math")
        mul = bool(d.get("is_multiple_answer"))
        at = d.get("answer_type") or "a numeric value"
        if at == "Need_human_evaluate":
            at = "proof based"
        post = (f"The question has multiple answers, each of them should "
                f"be {at}.\n" if mul
                else f"The answer of the question should be {at}.\n")
        post += ("Please calculate the answer according to the given "
                 "requirements and the information provided. Please use "
                 "LaTeX format to represent the variables and formulas "
                 "used in the solution process and results. Please end "
                 "your solution with ")
        post += ('"So the final answer is \\boxed{multiple answers '
                 'connected with commas}.".\n' if mul
                 else '"So the final answer is \\boxed{answer}."\n')
        return (f"The following is a question from an International {sub} "
                f"competition.\n{d['question']}\n{post}")

    def _res(d, r):
        if "TP" in str(d.get("source", "")):
            return {"_proof": 1.0}
        pred = str(r[0]).strip().split("final answer is")[-1]
        pred = pred.replace('"', "").replace("\n", "").replace(" ", "")
        pred = pred.strip(".").strip("。")
        pred = re.sub(r"^\\boxed\{(.*)\}$", r"\1", pred)
        gold = d.get("final_answer")
        gold = gold[0] if isinstance(gold, (list, tuple)) and gold else gold
        ok = _math_equal(pred, str(gold or ""), d.get("error") or 0)
        return {"exact_match": 1.0 if ok else 0.0}

    def _vis(d):
        imgs = d.get("images") or ([d["image"]] if d.get("image") is not None
                                   else [])
        return list(imgs)

    return TaskConfig(
        name="olympiadbench_test_en",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
        metric_names=("exact_match",),
        synthetic_docs=lambda n: [{
            "question": f"What is {i} + {i + 1}? <image 1>",
            "final_answer": [str(2 * i + 1)],
            "subfield": "Math", "answer_type": "a numeric value",
            "is_multiple_answer": False, "error": 0,
            "source": "OE_synth",
            "images": [_synth_image(i)]} for i in range(n)])


# ---------------------------------------------------------------------------
# IFEval (ifeval/utils.py + instructions.py — text-only instruction following)
# ---------------------------------------------------------------------------

def make_ifeval(dataset_path=None) -> TaskConfig:
    """ifeval/utils.py:112-152: strict grading on the raw response, loose
    grading over the 8 first/last-line- and asterisk-stripped variants
    (:62-80); prompt-level accuracy requires ALL of a doc's instructions
    followed, instruction-level averages over every instruction. Checkers:
    task_utils/ifeval.py (25 instruction types, instructions.py parity)."""
    from msd_tpu_torch.harness.task_utils import ifeval as IF

    def _res(d, r):
        ids = list(d.get("instruction_id_list") or [])
        kws = list(d.get("kwargs") or [{}] * len(ids))
        strict, loose = IF.evaluate(ids, kws, str(r[0]) if r else "",
                                    prompt=str(d.get("prompt", "")))
        return {"prompt_level_strict_acc": 1.0 if all(strict) else 0.0,
                "prompt_level_loose_acc": 1.0 if all(loose) else 0.0,
                "_inst_strict": [1.0 if b else 0.0 for b in strict],
                "_inst_loose": [1.0 if b else 0.0 for b in loose]}

    def _agg(rows):
        s = [x for row in rows for x in row.get("_inst_strict", [])]
        l = [x for row in rows for x in row.get("_inst_loose", [])]
        return {"inst_level_strict_acc": float(np.mean(s)) if s else 0.0,
                "inst_level_loose_acc": float(np.mean(l)) if l else 0.0}

    return TaskConfig(
        name="ifeval",
        doc_to_text=lambda d: str(d.get("prompt", "")),
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 1280, "temperature": 0.0},
        metric_names=("prompt_level_strict_acc", "prompt_level_loose_acc"),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "key": i,
            "prompt": f"Write about topic {i} without using commas.",
            "instruction_id_list": ["punctuation:no_comma",
                                    "length_constraints:number_words"],
            "kwargs": [{}, {"num_words": 3, "relation": "at least"}],
        } for i in range(n)])


_VITATECS_ASPECTS = ("Direction", "Intensity", "Sequence", "Localization",
                     "Compositionality", "Type")


def register_ext3_tasks(p) -> None:
    register_task("temporalbench_short_qa",
                  make_temporalbench("short_qa", p("TemporalBench")))
    register_task("temporalbench_long_qa",
                  make_temporalbench("long_qa", p("TemporalBench")))
    for a in _VITATECS_ASPECTS:
        register_task(f"vitatecs_{a.lower()}",
                      make_vitatecs(a, p("VITATECS")))
    register_task("jmmmu", make_jmmmu(p("JMMMU")))
    register_task("mmworld", make_mmworld(p("MMWorld")))
    register_task("youcook2_val", make_youcook2(p("YouCook2")))
    register_task("video_detail_description",
                  make_video_detail_description(p("VideoDetailCaption")))
    register_task("olympiadbench_test_en",
                  make_olympiadbench(p("OlympiadBench")))
    register_task("ifeval", make_ifeval(p("IFEval")))
