"""Judge-backed round-4 tasks: wild_vision_bench, vibe_eval, mia_bench.

All three are GPT-judged in the reference; here the judge seam is pluggable
(msd_tpu_torch.harness.judge) with deterministic offline fallbacks. Offline
numbers are pipeline checks, NOT comparable to GPT-judged scores
(documented in PARITY.md).

The port's own copy of the JAX package's ``harness/tasks_judge2.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image
from msd_tpu_torch.harness.registry import register_task
from msd_tpu_torch.harness.tasks_judge import _token_f1
from msd_tpu_torch.harness import judge as J


# ---------------------------------------------------------------------------
# WildVision-Bench (wild_vision_bench/utils.py)
# ---------------------------------------------------------------------------

_WV_SYSTEM = (
    "Please act as an impartial judge and evaluate the quality of the "
    "responses provided by two AI assistants to the user prompt displayed "
    "below. You will be given assistant A's answer and assistant B's "
    "answer. Your job is to evaluate which assistant's answer is better. "
    "After providing your explanation, you must output only one of the "
    "following choices as your final verdict with a label:\n\n"
    "1. Assistant A is significantly better: [[A>>B]]\n"
    "2. Assistant A is slightly better: [[A>B]]\n"
    "3. Tie, relatively the same: [[A=B]]\n"
    "4. Assistant B is slightly better: [[B>A]]\n"
    "5. Assistant B is significantly better: [[B>>A]]")

_WV_TEMPLATE = ("<|User Prompt|>\n{question_1}\n\n<|The Start of Assistant "
                "A's Answer|>\n{answer_1}\n<|The End of Assistant A's "
                "Answer|>\n\n<|The Start of Assistant B's Answer|>\n"
                "{answer_2}\n<|The End of Assistant B's Answer|>")


def wild_vision_judgement_to_score(score: str):
    """wild_vision_bench/utils.py:162-185 verdict mapping (A = baseline,
    B = the evaluated model). NOTE the reference checks 'A>B' BEFORE
    'A>>B', so a strict 'A>>B' verdict also matches the substring 'A>B'
    in ITS order; the canonical map below is ordered longest-first, which
    matches the judge contract ([[A>>B]] labels)."""
    for pat, (raw, winner) in (("A>>B", (-2, "model_a")),
                               ("B>>A", (2, "model_b")),
                               ("A>B", (-1, "model_a")),
                               ("B>A", (1, "model_b")),
                               ("A=B", (0, "tie"))):
        if pat in score:
            return raw, winner
    return 0, "tie"


def make_wild_vision(dataset_path=None) -> TaskConfig:
    """Pairwise judge vs the dataset's baseline-model answer
    (claude-3-sonnet column, utils.py:31,152-199). Metrics: mean raw score
    in [-2, 2] and win rate vs the baseline. Offline fallback: tie when the
    prediction token-F1-agrees with the baseline answer (>= 0.5), else
    'worse' — a pipeline check only."""
    def _baseline(d) -> str:
        for k in ("claude-3-sonnet-20240229", "baseline_answer", "answer"):
            if d.get(k):
                return str(d[k])
        return ""

    def _res(d, r):
        pred = str(r[0]) if r else ""
        base = _baseline(d)
        j = J.get_judge()
        raw = None
        if j is not None:
            out = j.complete(
                _WV_TEMPLATE.format(question_1=d.get("instruction", ""),
                                    answer_1=base, answer_2=pred),
                max_tokens=1024, system=_WV_SYSTEM)
            if out:
                m = re.search(r"\[\[([AB<>=]+)\]\]", out)
                raw, _ = wild_vision_judgement_to_score(
                    m.group(1) if m else out)
        if raw is None:
            raw = 0 if _token_f1(pred, base) >= 0.5 else -1
        return {"raw_score": float(raw),
                "win": 1.0 if raw > 0 else 0.0}

    return TaskConfig(
        name="wildvision_0617",
        doc_to_text=lambda d: str(d.get("instruction", "")),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 512, "temperature": 0.0},
        metric_names=("raw_score", "win"),
        synthetic_docs=lambda n: [{
            "instruction": f"Describe object {i} in the image.",
            "claude-3-sonnet-20240229": f"object {i} is a red cube",
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# Vibe-Eval (vibe_eval/utils.py)
# ---------------------------------------------------------------------------

def make_vibe_eval(dataset_path=None) -> TaskConfig:
    """vibe_eval/utils.py:41-141: the judge rates the generation against
    the ground-truth reference 1-5 ('Rating: (int)'); aggregate is
    25*(score-1) averaged — a 0-100 scale (:186-189) — reported overall
    and for the 'hard' subset. Offline fallback: rating = 1 + round(4 *
    tokenF1(pred, reference))."""
    _T = ("[Question]\n{prompt}\n\n[Assistant Response]\n{generation}\n\n"
          "[Ground Truth Response]\n{reference}\n\n[System]\nRate whether "
          "the assistant response correctly matches the ground truth, in "
          "regards to the image above.\nThe rating should be 1-5, where 1 "
          "is incorrect and 5 is correct.\nYour response should be in the "
          "format:\nExplanation: (your explanation)\nRating: (int)")

    def _res(d, r):
        pred = str(r[0]) if r else ""
        ref = str(d.get("reference", ""))
        j = J.get_judge()
        score = None
        if j is not None:
            out = j.complete(_T.format(prompt=d.get("prompt", ""),
                                       generation=pred, reference=ref),
                             max_tokens=512)
            if out:
                m = re.search(r"Rating:\s*([1-5])", out)
                score = int(m.group(1)) if m else 0
        if score is None:
            score = 1 + round(4 * _token_f1(pred, ref))
        row = {"score100": 25.0 * (score - 1)}
        if "hard" in str(d.get("category", "")):
            row["_hard"] = row["score100"]
        return row

    def _agg(rows):
        hard = [r["_hard"] for r in rows if "_hard" in r]
        return {"hard": float(np.mean(hard))} if hard else {}

    return TaskConfig(
        name="vibe_eval",
        doc_to_text=lambda d: str(d.get("prompt", "")).strip(),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 512, "temperature": 0.0},
        metric_names=("score100",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "prompt": f"What is in image {i}?",
            "reference": f"a red cube numbered {i}",
            "category": ("normal", "hard")[i % 2],
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# MIA-Bench (mia_bench/utils.py)
# ---------------------------------------------------------------------------

def make_mia_bench(dataset_path=None) -> TaskConfig:
    """mia_bench/utils.py:97-167: the judge scores each instruction
    component against its weight and reports 'total score: z/10'; the
    metric is the mean total in [0, 1]. Offline fallback:
    tokenF1(pred, instruction) as the total — pipeline check only."""
    def _res(d, r):
        pred = str(r[0]) if r else ""
        instr = str(d.get("instruction", ""))
        comps = d.get("components") or []
        j = J.get_judge()
        total = None
        if j is not None:
            comp_lines = "".join(f"\ncomponent {i + 1}: {c}"
                                 for i, c in enumerate(comps))
            prompt = (
                f"Here is an instruction for a multimodal LLM: '{instr}'. "
                f"You need to grade if the response from the model follows "
                f"each component of the instruction.{comp_lines}\n"
                f"The response is: '{pred}' You need to score the response "
                "and be strict. The total score ranges from 0 to 10, "
                "depending on if the response follows the instruction. "
                "List scores of each component, and the total score in one "
                "sentence in this format: score of component 1: x/2, score "
                "of component 2: y/8, total score: z/10. Then explain your "
                "reasons.")
            out = j.complete(prompt, max_tokens=512)
            if out:
                m = re.search(r"total score:\s*(\d+(?:\.\d+)?)\s*/\s*(\d+)",
                              out, re.IGNORECASE)
                if m and float(m.group(2)) > 0:
                    total = min(1.0, float(m.group(1)) / float(m.group(2)))
        if total is None:
            total = _token_f1(pred, instr)
        return {"total_score": total}

    return TaskConfig(
        name="mia_bench",
        doc_to_text=lambda d: str(d.get("instruction", "")),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 512, "temperature": 0.0},
        metric_names=("total_score",),
        synthetic_docs=lambda n: [{
            "instruction": f"Describe image {i} in exactly two sentences.",
            "components": ["describe the image", "use two sentences"],
            "image": _synth_image(i)} for i in range(n)])


def register_judge2_tasks(p) -> None:
    register_task("wildvision_0617", make_wild_vision(p("WildVision")))
    register_task("vibe_eval", make_vibe_eval(p("VibeEval")))
    register_task("mia_bench", make_mia_bench(p("MIA-Bench")))
    register_task("cvrr", make_cvrr(p("CVRR-ES")))
    register_task("moviechat_global", make_moviechat("global",
                                                     p("MovieChat")))
    register_task("moviechat_breakpoint",
                  make_moviechat("breakpoint", p("MovieChat")))
    register_task("cuva", make_cuva(p("CUVA")))
    register_task("llava_interleave_bench",
                  make_llava_interleave(p("LLaVA-Interleave")))
    for kind in ("mc", "freeform"):
        register_task(f"mix_evals_video2text_{kind}",
                      make_mix_evals_video2text(kind, p("MixEvals")))
        register_task(
            f"mix_evals_video2text_{kind}_hard",
            make_mix_evals_video2text(
                kind, p("MixEvals-hard"),
                name=f"mix_evals_video2text_{kind}_hard"))


# ---------------------------------------------------------------------------
# CVRR-ES (cvrr/utils.py)
# ---------------------------------------------------------------------------

def make_cvrr(dataset_path=None) -> TaskConfig:
    """cvrr/utils.py:100-180: the judge returns {'pred':
    'correct'|'incorrect', 'score': 0-5}; accuracy per DimensionName plus
    mean score. Offline: the activitynetqa containment proxy
    (tasks_ext2._videoqa_offline), documented in PARITY.md."""
    from msd_tpu_torch.harness.tasks_ext2 import _videoqa_offline

    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        verdict = None
        if j is not None:
            user = ("Please evaluate the following video-based "
                    "question-answer pair:\n\n"
                    f"Question: {d.get('question', '')}\n"
                    f"Correct Answer: {gold}\n"
                    f"Predicted Answer: {pred}\n\n"
                    "Provide your evaluation as a correct/incorrect "
                    "prediction along with the score where the score is an "
                    "integer value between 0 (fully wrong) and 5 (fully "
                    "correct). The middle score provides the percentage of "
                    "correctness. Please generate the response in the form "
                    "of a Python dictionary string with keys 'pred', "
                    "'score' and 'reason'. DO NOT PROVIDE ANY OTHER OUTPUT "
                    "TEXT OR EXPLANATION. For example: "
                    '{"pred": "correct", "score": 4.8, "reason": reason}.')
            out = j.complete(user, max_tokens=128)
            if out:
                m = re.search(r"['\"]pred['\"]\s*:\s*['\"]"
                              r"(correct|incorrect)", out, re.I)
                s = re.search(r"['\"]score['\"]\s*:\s*([0-9.]+)", out)
                if m and s:
                    verdict = (m.group(1).lower() == "correct",
                               float(s.group(1)))
        if verdict is None:
            yn, sc = _videoqa_offline(gold, pred)
            verdict = (yn == "yes", sc)
        dim = str(d.get("DimensionName", ""))
        row = {"accuracy": 1.0 if verdict[0] else 0.0,
               "score": min(5.0, verdict[1])}
        if dim:
            row[f"_dim_{dim}"] = row["accuracy"]
        return row

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_dim_")}
        return {k[len("_dim_"):]: float(np.mean([r[k] for r in rows
                                                 if k in r]))
                for k in sorted(keys)}

    def _synth_video(i):
        rng = np.random.default_rng(i + 53)
        return rng.integers(0, 255, size=(4, 32, 32, 3), dtype=np.uint8)

    return TaskConfig(
        name="cvrr",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=("accuracy", "score"),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"what happens in clip {i}",
            "answer": f"pattern {i}",
            "DimensionName": ("Partial actions",
                              "Time order understanding")[i % 2],
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# MovieChat (moviechat/utils.py — global / breakpoint modes)
# ---------------------------------------------------------------------------

def make_moviechat(mode: str = "global", dataset_path=None) -> TaskConfig:
    """moviechat/utils.py:83-260: long-video QA; the judge returns yes/no +
    0-5 score (same rubric family as activitynetqa). The breakpoint
    variant anchors the question at doc['time'] (:67-80); with array
    inputs the adapters sample frames uniformly, so the distinction lives
    in the dataset, not the pipeline. Offline containment proxy."""
    from msd_tpu_torch.harness.judge import videoqa_judge_score
    from msd_tpu_torch.harness.tasks_ext2 import _videoqa_offline

    def _res(d, r):
        js = videoqa_judge_score(d.get("question", ""),
                                 str(d.get("answer", "")),
                                 str(r[0]) if r else "")
        if js is None:
            js = _videoqa_offline(d.get("answer", ""),
                                  str(r[0]) if r else "")
        return {"accuracy": 1.0 if js[0] == "yes" else 0.0,
                "score": float(js[1])}

    def _synth_video(i):
        rng = np.random.default_rng(i + 67)
        return rng.integers(0, 255, size=(4, 32, 32, 3), dtype=np.uint8)

    return TaskConfig(
        name=f"moviechat_{mode}",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=("accuracy", "score"),
        synthetic_docs=lambda n: [{
            "question": f"what is shown around minute {i}",
            "answer": f"scene {i}", "time": 60 * i,
            "video_name": f"m{i}", "video": _synth_video(i)}
            for i in range(n)])


# ---------------------------------------------------------------------------
# CUVA (cuva/utils.py — anomaly description/cause/result, caption metrics)
# ---------------------------------------------------------------------------

def make_cuva(dataset_path=None) -> TaskConfig:
    """cuva/utils.py:108-160: three fixed anomaly questions keyed by
    doc['task'] (Description/Cause/Result); reported metrics are corpus
    BLEU/ROUGE over pred-vs-answer (the reference's BLEURT column needs a
    torch checkpoint — omitted, PARITY.md)."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    _Q = {
        "Description": ("Watch the video and describe any anomaly events "
                        "you see in the order they happen. Focus on what "
                        "is different from normal, like who or what is "
                        "involved and their actions."),
        "Cause": ("Explain why the anomaly in the video are happening. Use "
                  "what you see in the video to make logical reasoning "
                  "about the root reasons behind these anomalies."),
        "Result": ("Figure out what results and effect these anomalies "
                   "have. Link the anomaly directly to their outcomes."),
    }

    def _res(d, r):
        return {"_pred": str(r[0]) if r else "",
                "_refs": [str(d.get("answer", ""))]}

    def _synth_video(i):
        rng = np.random.default_rng(i + 71)
        return rng.integers(0, 255, size=(4, 32, 32, 3), dtype=np.uint8)

    return TaskConfig(
        name="cuva",
        doc_to_text=lambda d: _Q.get(str(d.get("task", "Description")),
                                     _Q["Description"]),
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=C.caption_scores,
        synthetic_docs=lambda n: [{
            "task": ("Description", "Cause", "Result")[i % 3],
            "answer": f"an anomaly involving object {i} occurs",
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# LLaVA-Interleave Bench (llava_interleave_bench/utils.py)
# ---------------------------------------------------------------------------

def interleave_mcq_acc(answer: str, pred: str) -> float:
    """llava_interleave_bench/utils.py:122-171 mcq_acc: option-prefix or
    standalone-letter extraction after punctuation stripping, exact match
    on the processed forms."""
    period = re.compile(r"(?!<=\d)(\.)(?!\d)")
    comma = re.compile(r"(\d)(\,)(\d)")
    punct = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\",
             "_", "-", ">", "<", "@", "`", ",", "?", "!"]

    def process(a: str) -> str:
        m = re.match(r"^([A-E])\.\s*(.+)$", a.strip(), re.IGNORECASE)
        if m:
            return m.group(1).upper()
        a = a.replace("\n", " ").replace("\t", " ").strip()
        out = a
        for p in punct:
            if (p + " " in a or " " + p in a) or comma.search(a):
                out = out.replace(p, "")
            else:
                out = out.replace(p, " ")
        out = period.sub("", out)
        out = out.strip("'").strip('"').strip(")").strip("(").strip().lower()
        lm = re.search(r"\b([A-E])\b", out, re.IGNORECASE)
        return lm.group(1).upper() if lm else out

    return 1.0 if process(pred) == process(answer) else 0.0


def make_llava_interleave(dataset_path=None) -> TaskConfig:
    """llava_interleave_bench/utils.py:104-235: multi-choice scored by
    mcq_acc, open-ended by ROUGE-L F (per-prediction vs answer); the
    overall score averages per-category means (:186-233). Images arrive as
    image_0..image_15 columns."""
    from msd_tpu_torch.harness.task_utils.captioning import rouge_l

    def _vis(d):
        out = []
        for i in range(16):
            v = d.get(f"image_{i}")
            if v is not None:
                out.append(v)
        return out or [v for k, v in d.items()
                       if k.startswith("image") and v is not None][:1]

    def _res(d, r):
        pred = str(r[0]) if r else ""
        if d.get("question_type") == "multi-choice":
            score = interleave_mcq_acc(str(d.get("answer", "")), pred)
        else:
            score = rouge_l([pred[:512]] if pred else [""],
                            [[str(d.get("answer", ""))]])
        return {"overall_score": float(score),
                "_sub": str(d.get("sub_task", ""))}

    def _agg(rows):
        per: Dict[str, List[float]] = {}
        for row in rows:
            per.setdefault(row["_sub"], []).append(row["overall_score"])
        out = {f"sub_{k}": float(np.mean(v)) for k, v in sorted(per.items())
               if k}
        if out:
            out["category_mean"] = float(np.mean(list(out.values())))
        return out

    return TaskConfig(
        name="llava_interleave_bench",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("overall_score",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "sample_id": i,
            "question": f"Which option matches image pair {i}?\n"
                        "A. first\nB. second\nYour answer is:",
            "answer": "AB"[i % 2],
            "question_type": ("multi-choice", "open-ended")[i % 2],
            "sub_task": ("Spot-the-Diff", "Multi-Image-VQA")[i % 2],
            "image_0": _synth_image(i), "image_1": _synth_image(i + 1)}
            for i in range(n)])


# ---------------------------------------------------------------------------
# MixEvals video2text (mix_evals/video2text/utils.py)
# ---------------------------------------------------------------------------

def make_mix_evals_video2text(kind: str = "mc", dataset_path=None,
                              name: str = None) -> TaskConfig:
    """mix_evals/video2text: `mc` lettered options appended to the query
    (utils.py:176-204) scored by regex-filtered exact match
    (mix_evals_video2text_mc.yaml metric_list); `freeform` judged with the
    [[score]] 0.0-1.0 correctness rubric (utils.py:49-101), offline
    tokenF1 proxy. `hard` variants are the same pipeline on harder
    datasets."""
    def _text(d):
        q = str(d.get("query", ""))
        opts = d.get("options") or []
        if len(opts) > 1:
            lines = "\n".join(f"{chr(ord('A') + i)}. {str(o).strip()}"
                              for i, o in enumerate(opts))
            q = f"{q}\nHere are the options:\n{lines}"
        if kind == "mc":
            q += ("\nAnswer the question with the letter of the correct "
                  "option.")
        return q

    def _res_mc(d, r):
        pred = str(r[0]) if r else ""
        m = re.search(r"\b([A-J])\b", pred.strip().upper())
        letter = m.group(1) if m else ""
        gold = str(d.get("answer", d.get("target", ""))).strip().upper()
        if gold and gold not in "ABCDEFGHIJ":
            # gold as option text: map to its letter
            for i, o in enumerate(d.get("options") or []):
                if str(o).strip().lower() == gold.lower():
                    gold = chr(ord("A") + i)
                    break
        return {"exact_match": 1.0 if letter and letter == gold else 0.0}

    def _res_ff(d, r):
        pred = str(r[0]) if r else ""
        refs = d.get("reference_answer") or []
        if isinstance(refs, str):
            refs = [refs]
        j = J.get_judge()
        score = None
        if j is not None:
            gold = "[" + ", ".join(f'"{g}"' for g in refs) + "]"
            user = (
                "You will be provided with a question, its golden "
                "answer(s), and the model's answer, while the context of "
                "the question, which is one or more videos, is not given "
                "here. Your task is to judge how correct the model's "
                "answer is based on the golden answer(s), without seeing "
                "the input videos of the question, and then give a "
                "correctness score. The correctness score should be one "
                "of the below numbers: 0.0 (totally wrong), 0.1, 0.2, "
                "0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally "
                "right). The correctness score must strictly follow this "
                'format: "[[score]]", e.g., "The correctness score: '
                '[[0.5]]".\n\n'
                f"Question: {d.get('query', '')}\n"
                f"Golden Answer(s): {gold}\n"
                f"Model's Answer: {pred}")
            out = j.complete(user, max_tokens=256,
                             system="In this task, I want you to act as "
                                    "a judge.")
            if out:
                m = re.search(r"\[\[([01](?:\.\d+)?)\]\]", out)
                if m:
                    score = min(1.0, float(m.group(1)))
        if score is None:
            score = max((_token_f1(pred, str(g)) for g in refs),
                        default=0.0)
        return {"gpt_eval": score}

    def _synth_video(i):
        rng = np.random.default_rng(i + 83)
        return rng.integers(0, 255, size=(4, 32, 32, 3), dtype=np.uint8)

    if kind == "mc":
        synth = lambda n: [{
            "query": f"Which option is number {i % 3}?",
            "options": [f"option {j}" for j in range(3)],
            "answer": "ABC"[i % 3],
            "video": _synth_video(i)} for i in range(n)]
    else:
        synth = lambda n: [{
            "id": i, "query": f"what happens in clip {i}",
            "reference_answer": [f"pattern {i} appears"],
            "video": _synth_video(i)} for i in range(n)]

    return TaskConfig(
        name=name or f"mix_evals_video2text_{kind}",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d.get("video", d.get("video_path", ""))],
        process_results=_res_mc if kind == "mc" else _res_ff,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16 if kind == "mc" else 128,
                    "temperature": 0.0},
        metric_names=("exact_match",) if kind == "mc" else ("gpt_eval",),
        synthetic_docs=synth)
