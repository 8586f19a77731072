"""Extended task library (round 3b): the next tier of lmms-eval tasks.

Each maker rebuilds the reference task's prompt format and offline scoring
semantics (reference file:line cited per maker); GPT-judge tasks are out of
scope by design (SURVEY §7.8). Registered via ``register_ext_tasks`` from
``tasks.register_builtin_tasks``.

The port's own copy of the JAX package's ``harness/tasks_ext.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import json
import re
import zlib
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness import metrics as M
from msd_tpu_torch.harness.registry import register_task
from msd_tpu_torch.harness.tasks import (TaskConfig, _synth_image,
                                         make_caption_task)

# ---------------------------------------------------------------------------
# shared extraction helpers
# ---------------------------------------------------------------------------

_ANSWER_PREFIXES = (
    "The best answer is", "The correct answer is", "The answer is",
    "The answer", "The best option is", "The correct option is",
    "Best answer:", "Best option:",
)


def strip_answer_prefixes(s: str) -> str:
    for p in _ANSWER_PREFIXES:
        s = s.replace(p, "")
    return s.strip()


def extract_letter(s: str, letters: str = "ABCDE",
                   choices=None) -> str:
    """mme_realworld/utils.py:91-118 extract_characters_regex: strip the
    known answer prefixes, then the first standalone capital in range; long
    answers with no letter score empty. When ``choices`` (option strings
    like '(A) text') are given, a regex miss falls back to substring
    matching the answer against each option and returning its letter
    (utils.py:112-116) — guarded against empty predictions, which the
    reference would spuriously map to the first option."""
    s = strip_answer_prefixes(str(s))
    if len(s.split()) > 10 and not re.search(f"[{letters}]", s):
        return ""
    m = re.search(f"[{letters}]", s)
    if m:
        return m[0]
    if s and choices:
        for choice in choices:
            c = str(choice)
            if len(c) > 1 and s.lower() in c.lower():
                return c[1]
    return ""


def _options_from_numbered(d: Dict, n: int, key: str = "option") -> List[str]:
    """qbench/longvideobench store options as option0..optionN with 'N/A'
    padding (qbench/utils.py:9-15, longvideobench/utils.py:114-121)."""
    out = []
    for i in range(n):
        c = d.get(f"{key}{i}")
        if c is not None and c != "N/A":
            out.append(str(c))
    return out


def _lettered(opts: List[str]) -> str:
    return "\n".join(f"{chr(ord('A') + i)}. {o}" for i, o in enumerate(opts))


def _gold_letter(ans) -> str:
    if isinstance(ans, (int, np.integer)):
        return "ABCDEFGHIJ"[int(ans)]
    a = str(ans).strip()
    if a.isdigit():
        return "ABCDEFGHIJ"[int(a)]
    return a.upper()[:1]


# ---------------------------------------------------------------------------
# MME-RealWorld
# ---------------------------------------------------------------------------

def make_mme_realworld(dataset_path=None,
                       name="mme_realworld") -> TaskConfig:
    """MME-RealWorld (mme_realworld/utils.py:52-57 prompt, :91-118 letter
    extraction, :137-160 per-(task, subtask) aggregation): five '(A) ...'
    options under 'multi-choice options', answers A-E; reports overall
    accuracy plus Perception/Reasoning and l2-category accuracies."""
    def _text(d):
        opts = d.get("multi-choice options") or d.get("options") or []
        return (d["question"] + " The choices are listed below:\n"
                + "\n".join(str(o) for o in opts)
                + "\nSelect the best answer to the above multiple-choice "
                "question based on the image. Respond with only the letter "
                "(A, B, C, D, or E) of the correct option.\n"
                "The best answer is: ")

    def _res(d, r):
        pred = extract_letter(r[0], "ABCDE",
                              d.get("multi-choice options")
                              or d.get("options"))
        gold = _gold_letter(d.get("answer", ""))
        cat = str(d.get("category", ""))
        task = "Perception" if "perception" in cat.lower() else "Reasoning"
        sub = str(d.get("l2-category", d.get("l2_category", "")))
        acc = 1.0 if pred and pred == gold else 0.0
        out = {"accuracy": acc, f"_{task}": acc}
        if sub:
            out[f"_sub_{sub}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_")}
        return {k.lstrip("_"): float(np.mean([row[k] for row in rows
                                              if k in row]))
                for k in sorted(keys)}

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 5}?",
            "multi-choice options": [f"({c}) option {j}" for j, c
                                     in enumerate("ABCDE")],
            "answer": "ABCDE"[i % 5],
            "category": "Perception" if i % 2 == 0 else "Reasoning/X",
            "l2-category": "Monitoring",
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# MuirBench (multi-image MC)
# ---------------------------------------------------------------------------

def make_muirbench(dataset_path=None) -> TaskConfig:
    """MuirBench (muirbench/utils.py:9-63): multi-image MC over
    doc['image_list'], lettered options, exact normalized answer match,
    per-task accuracies via aggregate_extra (muir_aggregation)."""
    def _text(d):
        opts = [str(o) for o in d.get("options", [])]
        return (d["question"] + "\n" + _lettered(opts)
                + "\nAnswer with the option's letter from the given "
                "choices directly.")

    def _res(d, r):
        pred = extract_letter(r[0], "ABCDEFGHIJ")
        gold = _gold_letter(d.get("answer", ""))
        acc = 1.0 if pred and pred == gold else 0.0
        task = str(d.get("task", ""))
        out = {"accuracy": acc}
        if task:
            out[f"_task_{task}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_task_")}
        return {k[len("_task_"):]: float(np.mean([row[k] for row in rows
                                                  if k in row]))
                for k in sorted(keys)}

    def _vis(d):
        imgs = d.get("image_list")
        if imgs is None:
            imgs = [d["image"]]
        return list(imgs)

    return TaskConfig(
        name="muirbench",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"Across the two images, which option is {i % 4}?",
            "options": [f"option {j}" for j in range(4)],
            "answer": "ABCD"[i % 4],
            "task": "Ordering" if i % 2 == 0 else "Counting",
            "image_list": [_synth_image(2 * i), _synth_image(2 * i + 1)],
        } for i in range(n)])


# ---------------------------------------------------------------------------
# WebSRC (squad-style token-set F1)
# ---------------------------------------------------------------------------

def websrc_f1(pred: str, answer: str) -> float:
    """websrc/utils.py:120-153 _compute_f1: lowercase, tokenize into words
    + punctuation, set precision/recall F1."""
    pat = r"\w+|[^\w\s]"
    sa = set(re.findall(pat, str(answer).lower().strip()))
    sb = set(re.findall(pat, str(pred).lower().strip()))
    if not sa or not sb:
        return 0.0
    comm = sa & sb
    prec, rec = len(comm) / len(sb), len(comm) / len(sa)
    return 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0


def make_websrc(dataset_path=None) -> TaskConfig:
    """WebSRC val (websrc/utils.py:16-49): screenshot QA scored with
    squad-style token-set F1; per-domain F1s via aggregate_extra
    (:70-99 weighted overall is the mean over docs here — equal weights)."""
    def _res(d, r):
        f1 = websrc_f1(r[0], d.get("answer", ""))
        out = {"squad_f1": f1}
        dom = str(d.get("domain", ""))
        if dom:
            out[f"_dom_{dom}"] = f1
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_dom_")}
        return {k[len("_dom_"):]: float(np.mean([row[k] for row in rows
                                                 if k in row]))
                for k in sorted(keys)}

    return TaskConfig(
        name="websrc_val",
        doc_to_text=lambda d: ("Based on the screenshot of the web page, "
                               "answer the question with a single word or "
                               f"phrase.\n{d['question']}"),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("squad_f1",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"What is the price of item {i}?",
            "answer": f"{i} dollars",
            "domain": "shopping",
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# Q-Bench (option0..3, one or two images)
# ---------------------------------------------------------------------------

def make_qbench(dataset_path=None, name="qbench_dev") -> TaskConfig:
    """Q-Bench dev (qbench/utils.py:8-25): options stored as option0..3
    with 'N/A' padding, image or an (image1, image2) pair; MC letter
    accuracy."""
    def _text(d):
        opts = (_options_from_numbered(d, 4)
                or [str(o) for o in d.get("options", [])])
        return (d["question"] + "\n" + _lettered(opts)
                + "\nAnswer with the option's letter from the given "
                "choices directly.")

    def _vis(d):
        if d.get("image2") is not None:
            return [d["image1"], d["image2"]]
        return [d.get("image", d.get("image1"))]

    def _res(d, r):
        opts = (_options_from_numbered(d, 4)
                or [str(o) for o in d.get("options", [])])
        gold = d.get("correct_choice", d.get("answer"))
        if not (isinstance(gold, (int, np.integer))
                or str(gold).strip().isdigit()
                or len(str(gold).strip()) == 1):
            # gold given as the full option text: map to its letter; an
            # unmappable gold (normalization mismatch, truncated option)
            # scores 0 rather than silently treating option A as correct
            golds = [j for j, o in enumerate(opts)
                     if M.normalize_extract(o) ==
                     M.normalize_extract(str(gold))]
            if not golds:
                import logging
                logging.getLogger("msd_tpu_torch.harness").warning(
                    "qbench: gold answer %r matches no option %r; "
                    "scoring 0", gold, opts)
                return {"accuracy": 0.0}
            gold = golds[0]
        pred = extract_letter(r[0], "ABCD")
        return {"accuracy": 1.0 if pred and pred == _gold_letter(gold)
                else 0.0}

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"How is the clarity of region {i % 3}?",
            "option0": "Good", "option1": "Bad", "option2": "Fair",
            "option3": "N/A",
            "correct_choice": i % 3,
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# LongVideoBench / MLVU (video MC with dataset-specific option layout)
# ---------------------------------------------------------------------------

def make_longvideobench(dataset_path=None) -> TaskConfig:
    """LongVideoBench val_v (longvideobench/utils.py:114-125): option0..4
    with 'N/A' padding over a video input, int 'correct_choice' gold."""
    def _text(d):
        opts = _options_from_numbered(d, 5)
        return (d["question"] + "\n" + _lettered(opts)
                + "\nAnswer with the option's letter from the given "
                "choices directly.")

    def _vis(d):
        if d.get("video_path"):
            return [d["video_path"]]
        return [d["video"]]

    def _res(d, r):
        pred = extract_letter(r[0], "ABCDE")
        gold = _gold_letter(d.get("correct_choice", d.get("answer", 0)))
        return {"accuracy": 1.0 if pred and pred == gold else 0.0}

    def _synth_video(i):
        rng = np.random.default_rng(i)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    return TaskConfig(
        name="longvideobench_val_v",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "option0": "option 0", "option1": "option 1",
            "option2": "option 2", "option3": "option 3", "option4": "N/A",
            "correct_choice": i % 4,
            "video": _synth_video(i)} for i in range(n)])


def make_mlvu(dataset_path=None) -> TaskConfig:
    """MLVU (mlvu/utils.py:44-49 prompt 'Best option: (', :52-120): the
    options are embedded in doc['question'], the gold is a letter; per
    task_type accuracies via aggregate_extra (mlvu_aggregate_results)."""
    def _res(d, r):
        pred = extract_letter(r[0], "ABCD")
        gold = _gold_letter(d.get("answer", ""))
        acc = 1.0 if pred and pred == gold else 0.0
        tt = str(d.get("task_type", ""))
        out = {"accuracy": acc}
        if tt:
            out[f"_tt_{tt}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_tt_")}
        return {k[len("_tt_"):]: float(np.mean([row[k] for row in rows
                                                if k in row]))
                for k in sorted(keys)}

    def _vis(d):
        if d.get("video_name"):
            return [d["video_name"]]
        return [d["video"]]

    def _synth_video(i):
        rng = np.random.default_rng(i + 7)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    return TaskConfig(
        name="mlvu",
        doc_to_text=lambda d: ("\n" + d["question"]
                               + "\nOnly give the best option.\n"
                               + "\nBest option: ("),
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": (f"Which option is number {i % 4}?\n"
                         + "\n".join(f"({c}) option {j}"
                                     for j, c in enumerate("ABCD"))),
            "answer": "ABCD"[i % 4],
            "task_type": "plotQA" if i % 2 == 0 else "needle",
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# text-only: MMLU (ppl-choice), MMLU-Pro (generative), GPQA (ppl-choice)
# ---------------------------------------------------------------------------

def make_mmlu(dataset_path=None) -> TaskConfig:
    """MMLU continuation variant (mmlu/default + lm-eval): subject header,
    lettered options, one loglikelihood request per ' A'-style letter
    continuation; per-subject accuracies via aggregate_extra."""
    def _query(d):
        subj = str(d.get("subject", "")).replace("_", " ").strip()
        head = (f"The following are multiple choice questions (with "
                f"answers) about {subj}.\n\n") if subj else ""
        return (head + d["question"].strip() + "\n"
                + _lettered([str(c) for c in d["choices"]]) + "\nAnswer:")

    def _choices(d):
        return [f" {c}" for c in "ABCD"[:len(d["choices"])]]

    def _res(d, results):
        lps = [lp for lp, _ in results]
        gold = int(d["answer"]) if not isinstance(d["answer"], str) \
            else ("ABCD".index(d["answer"].strip().upper()[0])
                  if not d["answer"].strip().isdigit()
                  else int(d["answer"]))
        acc = 1.0 if int(np.argmax(lps)) == gold else 0.0
        out = {"accuracy": acc}
        subj = str(d.get("subject", ""))
        if subj:
            out[f"_subj_{subj}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_subj_")}
        return {k[len("_subj_"):]: float(np.mean([row[k] for row in rows
                                                  if k in row]))
                for k in sorted(keys)}

    return TaskConfig(
        name="mmlu",
        doc_to_text=_query,
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_choice=_choices,
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "choices": [f"option {j}" for j in range(4)],
            "answer": i % 4,
            "subject": "abstract_algebra" if i % 2 == 0 else "astronomy",
        } for i in range(n)])


_MMLU_PRO_RE = re.compile(r"answer is \(?([ABCDEFGHIJ])\)?")


def make_mmlu_pro(dataset_path=None) -> TaskConfig:
    """MMLU-Pro (mmlu_pro/_default_template_yaml): up to 10 options, CoT
    prompt ending in 'the answer is (X)', extracted with the template's
    regex (fallback: first standalone A-J); answer_index int gold."""
    def _text(d):
        opts = [str(o) for o in d.get("options", d.get("choices", []))]
        return ("Question: " + d["question"].strip() + "\nOptions:\n"
                + _lettered(opts)
                + "\nAnswer: Let's think step by step. Finish your answer "
                "with 'the answer is (X)' where X is the correct letter "
                "choice.")

    def _res(d, r):
        m = _MMLU_PRO_RE.search(str(r[0]))
        pred = m.group(1) if m else extract_letter(r[0], "ABCDEFGHIJ")
        gold = d.get("answer_index", d.get("answer"))
        return {"exact_match": 1.0 if pred and pred == _gold_letter(gold)
                else 0.0}

    return TaskConfig(
        name="mmlu_pro",
        doc_to_text=_text,
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0,
                    "until": ["Q:", "Question:"]},
        metric_names=("exact_match",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 10}?",
            "options": [f"option {j}" for j in range(10)],
            "answer_index": i % 10,
        } for i in range(n)])


def make_gpqa(dataset_path=None) -> TaskConfig:
    """GPQA main zeroshot (gpqa/zeroshot/_gpqa_zeroshot_yaml): ppl-choice
    over the '(A)'..'(D)' labels with the 'What is the correct answer to
    this question:' prompt; docs carry choice1..choice4 + int answer."""
    def _choices_txt(d):
        if d.get("choices"):
            return [str(c) for c in d["choices"]]
        return [str(d[f"choice{i}"]) for i in range(1, 5) if f"choice{i}" in d]

    def _query(d):
        ch = _choices_txt(d)
        lines = "\n".join(f"({c}) {o}" for c, o in zip("ABCD", ch))
        return (f"What is the correct answer to this question:"
                f"{d['question']}\nChoices:\n{lines}\nAnswer:")

    def _res(d, results):
        lps = [lp for lp, _ in results]
        gold = d.get("answer")
        gold = int(gold) if not isinstance(gold, str) else \
            "ABCD".index(gold.strip().upper().strip("()")[0])
        lens = np.array([len(f"({c})") for c in "ABCD"[:len(lps)]], float)
        pred = int(np.argmax(lps))
        pred_n = int(np.argmax(np.asarray(lps) / lens))
        return {"acc": 1.0 if pred == gold else 0.0,
                "acc_norm": 1.0 if pred_n == gold else 0.0}

    return TaskConfig(
        name="gpqa_main_zeroshot",
        doc_to_text=_query,
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_choice=lambda d: [f" ({c})" for c in
                                 "ABCD"[:len(_choices_txt(d))]],
        metric_names=("acc", "acc_norm"),
        synthetic_docs=lambda n: [{
            "question": f" Which option is number {i % 4}?",
            "choice1": "option 0", "choice2": "option 1",
            "choice3": "option 2", "choice4": "option 3",
            "answer": i % 4,
        } for i in range(n)])


# ---------------------------------------------------------------------------
# SynthDoG (OCR, normalized edit-distance accuracy)
# ---------------------------------------------------------------------------

def edit_distance_accuracy(pred: str, gt: str) -> float:
    """donut_evaluator.JSONParseEvaluator.cal_acc for SynthDoG's flat
    {'text_sequence': ...} ground truth: the zss tree has a single leaf, so
    the tree edit distance reduces to string edit distance over the
    sequence; accuracy = max(0, 1 - ED / len(gt))."""
    from msd_tpu_torch.harness.metrics import _levenshtein
    gt = str(gt)
    if not gt:
        return 0.0
    d = _levenshtein(str(pred), gt)
    return max(0.0, 1.0 - d / len(gt))


def make_synthdog(dataset_path=None, name="synthdog_en") -> TaskConfig:
    """SynthDoG-en (synthdog/utils.py:17-39): read all text in the synthetic
    document image; ground_truth is a JSON string with gt_parse.text_sequence;
    scored with donut's normalized edit-distance accuracy."""
    def _gt(d) -> str:
        raw = d.get("ground_truth", "")
        if isinstance(raw, str) and raw.lstrip().startswith("{"):
            try:
                return str(json.loads(raw)["gt_parse"]["text_sequence"])
            except (ValueError, KeyError):
                return raw
        if isinstance(raw, dict):
            return str(raw.get("gt_parse", {}).get("text_sequence", ""))
        return str(raw or d.get("answer", ""))

    return TaskConfig(
        name=name,
        doc_to_text=lambda d: "Read all the text in the image.",
        doc_to_visual=lambda d: [d["image"]],
        process_results=lambda d, r: {
            "edit_distance_acc": edit_distance_accuracy(
                str(r[0]).lower().strip(), _gt(d).lower().strip())},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("edit_distance_acc",),
        synthetic_docs=lambda n: [{
            "ground_truth": json.dumps(
                {"gt_parse": {"text_sequence": f"sample text {i}"}}),
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# VATEX (video captioning) + DetailCaps
# ---------------------------------------------------------------------------

def make_vatex(dataset_path=None) -> TaskConfig:
    """VATEX test (vatex/utils.py): video captioning against the 10 'enCap'
    references, scored with the shared corpus BLEU/ROUGE-L/CIDEr pipeline
    (task_utils/captioning.py)."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    def _res(d, r):
        refs = d.get("enCap") or d.get("answer") or []
        if isinstance(refs, str):
            refs = [refs]
        return {"_pred": r[0], "_refs": [str(a) for a in refs]}

    def _vis(d):
        if d.get("video_path"):
            return [d["video_path"]]
        return [d["video"]]

    def _synth_video(i):
        rng = np.random.default_rng(i + 13)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    return TaskConfig(
        name="vatex_test",
        doc_to_text=lambda d: ("Provide a one-sentence caption for the "
                               "provided video."),
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=C.caption_scores,
        synthetic_docs=lambda n: [{
            "enCap": [f"a video of object {i}", f"a clip of object {i}"],
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# NaturalBench (grouped vision-centric binary/MC probes)
# ---------------------------------------------------------------------------

def make_naturalbench(dataset_path=None) -> TaskConfig:
    """NaturalBench (naturalbench/utils.py:13-115): each group of 4
    consecutive docs is (q0,i0) (q0,i1) (q1,i0) (q1,i1) over two paired
    images; per-sample yes/no (or letter) accuracy plus the grouped
    metrics — Q_Acc (both images right for a question), I_Acc (both
    questions right for an image), G_Acc (all four right)."""
    def _text(d):
        suffix = ("Please answer Yes or No."
                  if str(d.get("question_type", "yes_no")) == "yes_no"
                  else "Please output the letter corresponding to the "
                       "correct option.")
        return f"{d['question']} {suffix}"

    def _res(d, r):
        pred = str(r[0]).strip().lower()
        idx = int(d.get("Index", d.get("index", d.get("id", 0))))
        qtype = str(d.get("question_type", "yes_no"))
        gold = str(d.get("answer", "")).strip().lower()
        if not gold:
            # the reference dataset carries NO answer field: correctness is
            # implicit in the fixed slot pattern keyed off doc['Index'] —
            # q0_i0=yes, q0_i1=no, q1_i0=no, q1_i1=yes (A/B for the
            # multiple_choice variant); naturalbench/utils.py get_scores
            gold = (("yes" if idx % 4 in (0, 3) else "no")
                    if qtype == "yes_no"
                    else ("a" if idx % 4 in (0, 3) else "b"))
        if qtype == "yes_no":
            p = "yes" if pred.startswith("yes") else (
                "no" if pred.startswith("no") else "")
            acc = 1.0 if p and gold.startswith(p) else 0.0
        else:
            pl = extract_letter(r[0], "ABCD").lower()
            acc = 1.0 if pl and gold.startswith(pl) else 0.0
        return {"accuracy": acc, "_group": float(idx // 4),
                "_slot": float(idx % 4)}

    def _agg(rows):
        groups: Dict[float, Dict[int, float]] = {}
        for row in rows:
            groups.setdefault(row["_group"], {})[int(row["_slot"])] = \
                row["accuracy"]
        full = [g for g in groups.values() if len(g) == 4]
        if not full:
            return {"Q_Acc": 0.0, "I_Acc": 0.0, "G_Acc": 0.0}
        q = i = g = 0.0
        for gr in full:
            # slots: 0=q0_i0 1=q0_i1 2=q1_i0 3=q1_i1 (utils.py:45-71)
            q += (gr[0] and gr[1]) + (gr[2] and gr[3])
            i += (gr[0] and gr[2]) + (gr[1] and gr[3])
            g += all(gr[s] for s in range(4))
        n = len(full)
        return {"Q_Acc": q / (2 * n), "I_Acc": i / (2 * n), "G_Acc": g / n}

    return TaskConfig(
        name="naturalbench",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "index": i,
            "question": f"Is there a shape in region {(i // 4) % 3}?",
            "question_type": "yes_no",
            # q0 answers yes on i0, no on i1; q1 the reverse
            "answer": "yes" if i % 4 in (0, 3) else "no",
            "image": _synth_image(i // 2)} for i in range(n)])


# ---------------------------------------------------------------------------
# MMT-Bench (A..I option columns) + II-Bench (6-option, most-common letter)
# ---------------------------------------------------------------------------

def make_mmt(dataset_path=None, name="mmt_val") -> TaskConfig:
    """MMT-Bench (mmt/utils.py:61-109): options live in per-letter columns
    A..I ('' = absent), 'Question: <image>\\n' header, answer is the letter;
    per l2-category accuracies via aggregate_extra."""
    _LETTERS = "ABCDEFGHI"

    def _opts(d) -> List[str]:
        return [c for c in _LETTERS
                if d.get(c) and str(d[c]).strip()]

    def _text(d):
        lines = [f"{c}: {str(d[c]).strip()}" for c in _opts(d)]
        return ("Question: " + d["question"].strip() + "\n"
                + "\n".join(lines)
                + "\nAnswer with the option letter from the given choices "
                "directly.")

    def _res(d, r):
        pred = extract_letter(r[0], _LETTERS)
        acc = 1.0 if pred and pred == str(d.get("answer", "")).strip() \
            else 0.0
        out = {"accuracy": acc}
        l2 = str(d.get("l2-category", d.get("l2_category", "")))
        if l2:
            out[f"_l2_{l2}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_l2_")}
        return {k[len("_l2_"):]: float(np.mean([row[k] for row in rows
                                                if k in row]))
                for k in sorted(keys)}

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [dict(
            {"question": f"Which option is number {i % 4}?",
             "answer": "ABCD"[i % 4], "l2-category": "ocr",
             "image": _synth_image(i)},
            **{c: f"option {j}" for j, c in enumerate("ABCD")})
            for i in range(n)])


def ii_bench_extract(text: str) -> str:
    """ii_bench/utils.py:29-47 extract_option_labels: prefer '(X)' matches,
    fall back to standalone capitals; the MOST COMMON letter wins, ties to
    the last-listed candidate."""
    from collections import Counter
    matches = re.findall(r"\(([A-F])\)", str(text))
    if not matches:
        matches = re.findall(r"\b([A-F])\b", str(text))
    if not matches:
        return ""
    counts = Counter(matches).most_common()
    top = [m for m in counts if m[1] == counts[0][1]]
    return top[-1][0]


def make_ii_bench(dataset_path=None) -> TaskConfig:
    """II-Bench (ii_bench/utils.py:10-27): image-implication MC over
    option1..option6 rendered as '(A) ...' lines."""
    def _text(d):
        lines = [f"({c}) {d[f'option{j + 1}']}"
                 for j, c in enumerate("ABCDEF") if d.get(f"option{j + 1}")]
        return ("Question: " + d["question"] + "\n" + "\n".join(lines)
                + "\nAnswer with the option's letter from the given "
                "choices directly.")

    def _res(d, r):
        pred = ii_bench_extract(r[0])
        gold = _gold_letter(d.get("answer", ""))
        return {"accuracy": 1.0 if pred and pred == gold else 0.0}

    return TaskConfig(
        name="ii_bench",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [dict(
            {"question": f"Which option is number {i % 6}?",
             "answer": "ABCDEF"[i % 6], "image": _synth_image(i)},
            **{f"option{j + 1}": f"option {j}" for j in range(6)})
            for i in range(n)])


# ---------------------------------------------------------------------------
# MIRB (multi-image reasoning, per-subset instructions)
# ---------------------------------------------------------------------------

_MIRB_INSTR = {
    **dict.fromkeys(("analogy", "attribute", "plot_code", "visual_chain",
                     "sightseeing"), "Answer with a single word."),
    **dict.fromkeys(("codeu", "food", "image_jigsaw"),
                    "Answer with the option symbol."),
    "arxiv": "Answer with the paper title.",
    "count": "Answer with a single number.",
    "3d_scene": ("The following images are different views of the same 3D "
                 "scene. Answer with a single number."),
}


def make_mirb(dataset_path=None) -> TaskConfig:
    """MIRB (mirb/utils.py:12-41): multi-image reasoning over
    doc['image_list'], per-subset task instruction, normalized exact match
    (numeric answers compared as numbers); per-subset accuracies."""
    def _text(d):
        sub = str(d.get("subset", ""))
        return _MIRB_INSTR.get(sub, "") + str(d.get("questions",
                                                    d.get("question", "")))

    def _norm(s: str) -> str:
        return M.normalize_extract(str(s))

    def _match(pred: str, gold: str) -> float:
        p, g = _norm(pred), _norm(gold)
        try:
            return float(abs(float(p.replace(",", ""))
                             - float(g.replace(",", ""))) < 1e-6)
        except ValueError:
            return float(p == g or (g and g in p.split()))

    def _res(d, r):
        gold = d.get("answers", d.get("answer", ""))
        acc = _match(r[0], str(gold))
        out = {"accuracy": acc}
        sub = str(d.get("subset", ""))
        if sub:
            out[f"_sub_{sub}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_sub_")}
        return {k[len("_sub_"):]: float(np.mean([row[k] for row in rows
                                                 if k in row]))
                for k in sorted(keys)}

    return TaskConfig(
        name="mirb",
        doc_to_text=_text,
        doc_to_visual=lambda d: list(d.get("image_list") or [d["image"]]),
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "questions": f" How many squares are in image {i % 3}?",
            "answers": str(i % 5), "subset": "count",
            "image_list": [_synth_image(2 * i), _synth_image(2 * i + 1)],
        } for i in range(n)])


# ---------------------------------------------------------------------------
# ConBench (consistency across 3 question fields per image)
# ---------------------------------------------------------------------------

def make_conbench(dataset_path=None) -> TaskConfig:
    """ConBench (conbench/utils.py:26-95): each image is probed by three
    question fields — N/Y (yes/no prefix parse), Choices (first non-space
    char), Q/A (near-exact: NLS >= 0.95). Per-doc score plus ConScore_D =
    fraction of images where ALL THREE are right."""
    def _res(d, r):
        pred = str(r[0]).replace("\n", "").lower()
        gt = str(d.get("answer", "")).lower()
        field = str(d.get("question_field", "Q/A"))
        if field == "N/Y":
            head = pred[:4] if pred not in ("yes", "no") else pred
            p = "yes" if "yes" in head else ("no" if "no" in head
                                             else "other")
            score = 1.0 if p == gt else 0.0
        elif field == "Choices":
            p = pred.replace(" ", "")[:1]
            score = 1.0 if p == gt else 0.0
        else:  # Q/A: anls_score(threshold=0.95) >= 0.4 <=> NLS >= 0.95
            from msd_tpu_torch.harness.metrics import _levenshtein
            p, g = pred.strip(), gt.strip()
            nls = 1.0 - _levenshtein(p, g) / max(1, max(len(p), len(g)))
            score = 1.0 if (nls >= 0.95 or p == g) else 0.0
        return {"accuracy": score,
                "_img": float(zlib.crc32(str(d.get("image_id",
                                                   "")).encode()))}

    def _agg(rows):
        per_img: Dict[float, List[float]] = {}
        for row in rows:
            per_img.setdefault(row["_img"], []).append(row["accuracy"])
        full = [v for v in per_img.values() if len(v) >= 3]
        if not full:
            return {"ConScore_D": 0.0}
        return {"ConScore_D": float(np.mean([all(v) for v in full]))}

    return TaskConfig(
        name="conbench",
        doc_to_text=lambda d: str(d["question"]).strip(),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": ("Is there a shape? Answer yes or no."
                         if i % 3 == 0 else
                         ("Pick A or B." if i % 3 == 1
                          else "What is shown?")),
            "question_field": ("N/Y", "Choices", "Q/A")[i % 3],
            "answer": ("yes", "a", "a shape")[i % 3],
            "image_id": str(i // 3),
            "image": _synth_image(i // 3)} for i in range(n)])


# ---------------------------------------------------------------------------
# TempCompass (video; rule-matched MC / yes-no / caption-matching)
# ---------------------------------------------------------------------------

def _tempcompass_mc_rating(pred: str, answer: str) -> float:
    """tempcompass/utils.py:127-143 hand-crafted matching rules; the
    ChatGPT fallback for unmatched answers is out of scope (offline
    harness) — unmatched predictions score 0."""
    pred, answer = str(pred).strip(), str(answer)
    if pred == answer:
        return 1.0
    if pred in ("A", "B", "C", "D"):
        return 1.0 if answer.startswith(pred) else 0.0
    for sep in (".", ")"):
        if any(pred.startswith(f"{c}{sep}") for c in "ABCD"):
            return 1.0 if answer.startswith(pred.split(sep)[0]) else 0.0
    return 0.0


def _tempcompass_caption_rating(pred: str, question: str,
                                answer: str) -> float:
    """tempcompass/utils.py:438-458 caption_matching eval_rule: match the
    raw output against the complete option lines parsed from the question
    ('Caption A: <text>'), the option sentences, or the option indices
    ('Caption A' / 'Option 1' / bare 'A'), then compare the matched form
    against the answer's equivalent forms. Unmatched outputs (the
    reference's 'fail', later ChatGPT-judged) score 0 offline."""
    pred, answer = str(pred).strip(), str(answer)
    option_strs = [ln for ln in str(question).split("\n")[1:] if ln.strip()]
    with_sep = [o for o in option_strs if ": " in o]
    option_sents = [o.split(": ", 1)[1] for o in with_sep]
    option_inds = [o.split(": ", 1)[0] for o in with_sep]
    option_inds += [i.replace("Sentence ", "").replace("Option ", "")
                    .replace("Caption ", "") for i in option_inds]
    matched = None
    for o in option_strs:
        if o == pred:
            matched = o
    for sent in option_sents:
        if sent == pred or (") " in pred
                            and sent == pred.split(") ", 1)[1]):
            matched = sent
    for ind in option_inds:
        if ind == pred or ind == pred.replace(".", ""):
            matched = ind
    if matched is None:
        return 0.0
    forms = {answer}
    if ": " in answer:
        head, sent = answer.split(": ", 1)
        forms |= {head, sent}
        hw = head.split()
        if len(hw) > 1:
            forms.add(hw[1])
    return 1.0 if matched in forms else 0.0


def make_tempcompass(dataset_path=None, kind="multi-choice") -> TaskConfig:
    """TempCompass (tempcompass/_default_template_yaml post_prompts +
    utils.py process_results): the question text already carries the
    options; per-dim accuracies via aggregate_extra."""
    post = {"multi-choice": "\nPlease directly give the best option:",
            "yes_no": "\nPlease answer yes or no:",
            "caption_matching": "\nPlease directly give the best option:"}
    name = {"multi-choice": "tempcompass_mc",
            "yes_no": "tempcompass_yes_no",
            "caption_matching": "tempcompass_caption_matching"}[kind]

    def _rate(d, r) -> float:
        if kind == "yes_no":
            pred = str(r[0]).strip().lower()
            p = "yes" if pred.startswith("yes") else (
                "no" if pred.startswith("no") else "")
            return 1.0 if p and p == str(d["answer"]).strip().lower() \
                else 0.0
        if kind == "caption_matching":
            return _tempcompass_caption_rating(r[0], d["question"],
                                               d["answer"])
        return _tempcompass_mc_rating(r[0], d["answer"])

    def _res(d, r):
        acc = _rate(d, r)
        out = {"avg_accuracy": acc}
        dim = str(d.get("dim", ""))
        if dim:
            out[f"_dim_{dim}"] = acc
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_dim_")}
        return {k[len("_dim_"):] + "_accuracy":
                float(np.mean([row[k] for row in rows if k in row]))
                for k in sorted(keys)}

    def _vis(d):
        if d.get("video_path"):
            return [d["video_path"]]
        return [d["video"]]

    def _synth_video(i):
        rng = np.random.default_rng(i + 29)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    def _synth(n):
        docs = []
        for i in range(n):
            if kind == "yes_no":
                docs.append({"question": f"Is the clip playing forward "
                                         f"({i % 2})?",
                             "answer": "yes" if i % 2 == 0 else "no",
                             "dim": "direction", "video_id": str(i),
                             "video": _synth_video(i)})
            elif kind == "caption_matching":
                docs.append({"question": (
                    "Which caption matches the video?\n"
                    + "\n".join(f"Caption {c}: clip {j}" for j, c
                                in enumerate("AB"))),
                    "answer": f"Caption {'AB'[i % 2]}: clip {i % 2}",
                    "dim": "order", "video_id": str(i),
                    "video": _synth_video(i)})
            else:
                docs.append({"question": (f"Which option is {i % 4}?\n"
                                          + "\n".join(
                                              f"{c}. option {j}" for j, c
                                              in enumerate("ABCD"))),
                             "answer": f"{'ABCD'[i % 4]}. option {i % 4}",
                             "dim": "order", "video_id": str(i),
                             "video": _synth_video(i)})
        return docs

    return TaskConfig(
        name=name,
        doc_to_text=lambda d: str(d["question"]) + post[kind],
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("avg_accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register_ext_tasks(p) -> None:
    """Called from tasks.register_builtin_tasks with its dataset-path
    resolver ``p``."""
    register_task("mme_realworld", make_mme_realworld(p("MME-RealWorld")))
    register_task("muirbench", make_muirbench(p("MuirBench")))
    register_task("websrc_val", make_websrc(p("WebSRC")))
    register_task("qbench_dev", make_qbench(p("Q-Bench")))
    register_task("longvideobench_val_v",
                  make_longvideobench(p("LongVideoBench")))
    register_task("mlvu", make_mlvu(p("MLVU")))
    register_task("mmlu", make_mmlu(p("MMLU")))
    register_task("mmlu_pro", make_mmlu_pro(p("MMLU-Pro")))
    register_task("gpqa_main_zeroshot", make_gpqa(p("GPQA")))
    register_task("synthdog_en", make_synthdog(p("SynthDoG")))
    register_task("vatex_test", make_vatex(p("VATEX")))
    register_task("detailcaps", make_caption_task(
        "detailcaps", p("DetailCaps"),
        prompt=("Describe this image in detail. Provide a detailed "
                "description of the image.")))
    register_task("naturalbench", make_naturalbench(p("NaturalBench")))
    register_task("mmt_val", make_mmt(p("MMT-Bench")))
    register_task("ii_bench", make_ii_bench(p("II-Bench")))
    register_task("mirb", make_mirb(p("MIRB")))
    register_task("conbench", make_conbench(p("ConBench")))
    register_task("tempcompass_mc",
                  make_tempcompass(p("TempCompass"), "multi-choice"))
    register_task("tempcompass_yes_no",
                  make_tempcompass(p("TempCompass"), "yes_no"))
    register_task("tempcompass_caption_matching",
                  make_tempcompass(p("TempCompass"), "caption_matching"))
    # cheap dataset variants over the same makers (reference yaml-only
    # forks: qbench/qbench2_dev.yaml + abench_dev.yaml share utils.py;
    # mme_realworld_lite.yaml shares mme_realworld/utils.py)
    register_task("qbench2_dev", make_qbench(p("Q-Bench2"), "qbench2_dev"))
    register_task("abench_dev", make_qbench(p("A-Bench"), "abench_dev"))
    register_task("mme_realworld_lite",
                  make_mme_realworld(p("MME-RealWorld-Lite"),
                                     "mme_realworld_lite"))
