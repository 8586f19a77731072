"""Final round-4 tier: av_odyssey, vinoground, openhermes, funqa,
live_bench, ferret, vdc x5 — the last reference task dirs outside the
agentic mmsearch pipeline (documented in PARITY.md).

The port's own copy of the JAX package's ``harness/tasks_ext4.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image
from msd_tpu_torch.harness.registry import register_task
from msd_tpu_torch.harness.tasks_judge import _token_f1
from msd_tpu_torch.harness import judge as J


def _synth_video(i: int) -> np.ndarray:
    rng = np.random.default_rng(i + 113)
    return rng.integers(0, 255, size=(4, 32, 32, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# AV-Odyssey (av_odyssey/utils.py:197-250)
# ---------------------------------------------------------------------------

def make_av_odyssey(dataset_path=None) -> TaskConfig:
    """A-D multiple choice over 'A. text' options with the MMMU response
    parser; aggregate = mean over per-subfield (category) means of
    per-question means."""
    from msd_tpu_torch.harness.task_utils import mmmu as MU

    def _res(d, r):
        opts = [str(o) for o in (d.get("options") or [])]
        option_list = {c: o[3:] if len(o) > 3 else o
                       for c, o in zip("ABCD", opts)}
        pred = MU.parse_multi_choice_response(str(r[0]) if r else "",
                                              list("ABCD"[:len(opts)]),
                                              option_list)
        ok = 1.0 if pred == str(d.get("answer", "")) else 0.0
        return {"accuracy": ok,
                "_qid": str(d.get("question_id", "")),
                "_cat": str(d.get("subfield", ""))}

    def _agg(rows):
        per_q: Dict[tuple, List[float]] = defaultdict(list)
        for row in rows:
            per_q[(row["_cat"], row["_qid"])].append(row["accuracy"])
        per_cat: Dict[str, List[float]] = defaultdict(list)
        for (cat, _), scores in per_q.items():
            per_cat[cat].append(float(np.mean(scores)))
        return {cat: float(np.mean(v)) for cat, v in sorted(per_cat.items())
                if cat}

    return TaskConfig(
        name="av_odyssey",
        doc_to_text=lambda d: (str(d.get("question", "")) + "\n"
                               + "\n".join(str(o) for o in
                                           (d.get("options") or []))
                               + "\nAnswer with the option's letter."),
        doc_to_visual=lambda d: [d.get("video", d.get("image"))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "options": [f"{c}. option {j}"
                        for j, c in enumerate("ABCD")],
            "answer": "ABCD"[i % 4], "question_id": str(i),
            "subfield": ("timbre", "tone")[i % 2],
            "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# Vinoground (vinoground/utils.py:61-140)
# ---------------------------------------------------------------------------

def make_vinoground(dataset_path=None) -> TaskConfig:
    """Counterfactual text/video matching: each base index has pos/neg
    rows per question_type; text score requires BOTH text rows right,
    video score both video rows, group score all four (the matrix AND
    logic, :92-101). GT per row is the expected letter; per-category
    extras from major/minor tags. The reference reads GT from sidecar
    jsons — here each doc carries its 'GT' (same values), documented."""
    def _res(d, r):
        pred = str(r[0]).strip() if r else ""
        gt = str(d.get("GT", "")).strip()
        ok = 1.0 if pred and gt and pred[0].lower() == gt[0].lower() else 0.0
        idx = str(d.get("index", "0_pos_text"))
        parts = idx.split("_")
        return {"_ok": ok, "_base": parts[0],
                "_pol": parts[1] if len(parts) > 1 else "pos",
                "_qt": parts[2] if len(parts) > 2 else "text",
                "_cats": ["all", str(d.get("major", ""))]
                + (str(d["minor"]).split(";") if d.get("minor") else [])}

    def _agg(rows):
        cell: Dict[tuple, float] = {}
        cats: Dict[str, List[str]] = {}
        for row in rows:
            cell[(row["_base"], row["_qt"], row["_pol"])] = row["_ok"]
            cats.setdefault(row["_base"], row["_cats"])
        text_w, video_w, group_w = {}, {}, {}
        for b in cats:
            t = cell.get((b, "text", "pos"), 0) * cell.get(
                (b, "text", "neg"), 0)
            v = cell.get((b, "video", "pos"), 0) * cell.get(
                (b, "video", "neg"), 0)
            text_w[b], video_w[b], group_w[b] = t, v, t * v
        out = {}
        for name, w in (("text_score", text_w), ("video_score", video_w),
                        ("group_score", group_w)):
            out[name] = float(np.mean(list(w.values()))) if w else 0.0
        return out

    def _synth(n):
        docs = []
        for b in range(max(n // 4, 1)):
            for qt in ("text", "video"):
                for pol in ("pos", "neg"):
                    docs.append({
                        "index": f"{b}_{pol}_{qt}",
                        "question": f"Does caption {b} match? A or B.",
                        "GT": "A" if pol == "pos" else "B",
                        "major": "object", "minor": None,
                        "video": _synth_video(b)})
        return docs[:max(n, 4)]

    return TaskConfig(
        name="vinoground",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [d.get("video", "")],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# OpenHermes (openhermes/utils.py:58-124) + FunQA (funqa/utils.py:249-260)
# ---------------------------------------------------------------------------

def make_openhermes(dataset_path=None) -> TaskConfig:
    """Spoken-instruction following judged 0-5 against the reference
    answer (:58-75 rubric); offline 5 * tokenF1."""
    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        score = None
        if j is not None:
            out = j.complete(
                f"[Question]\n{d.get('speech_instruction', '')}\n\n"
                f"[Reference Answer]\n{gold}\n\n[Model Answer]\n{pred}\n\n"
                "[Task]\nRate the model's answer based on its alignment "
                "with the reference answer, focusing on accuracy and "
                "relevance to the reference provided. Please be critical "
                "on the details. Respond 'Rating: (int 0-5)'.",
                max_tokens=256)
            if out:
                m = re.search(r"Rating:\s*([0-5])", out)
                if m:
                    score = float(m.group(1))
        if score is None:
            score = 5.0 * _token_f1(pred, gold)
        return {"gpt_eval": score}

    return TaskConfig(
        name="openhermes",
        doc_to_text=lambda d: "Follow the spoken instruction.",
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("gpt_eval",),
        synthetic_docs=lambda n: [{
            "speech_instruction": f"explain item {i}",
            "answer": f"item {i} is a widget",
            "audio": {"array": np.zeros(160, np.float32),
                      "sampling_rate": 16000}} for i in range(n)])


def make_funqa(dataset_path=None) -> TaskConfig:
    """Counter-intuitive video QA: corpus BLEU/ROUGE rows (funqa_BLEU /
    funqa_ROUGE, :256-258) + the 0-100 detail-match judge rubric
    (:68-79), offline 100 * tokenF1."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        gpt = None
        if j is not None:
            out = j.complete(
                "You will be given two text segments in the format "
                f"[text1][text2]: [{gold}][{pred}]. text2 describes a "
                "counterintuitive (humorous, creative, or magical) video; "
                "score it out of 100 against text1 for content and "
                "details. Output only the number.", max_tokens=16)
            if out:
                m = re.search(r"(\d{1,3})", out)
                if m:
                    gpt = min(100.0, float(m.group(1)))
        if gpt is None:
            gpt = 100.0 * _token_f1(pred, gold)
        return {"funqa_gpt": gpt, "_pred": pred, "_refs": [gold]}

    def _agg(rows):
        return C.caption_scores(rows)

    return TaskConfig(
        name="funqa",
        doc_to_text=lambda d: str(d.get(
            "prompt", d.get("question", "Describe the counterintuitive "
                                        "part of the video."))),
        doc_to_visual=lambda d: [d.get("video", "")],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=("funqa_gpt",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "prompt": f"Describe what is funny in clip {i}.",
            "answer": f"a cat wearing hat {i} jumps",
            "task": "H2", "video": _synth_video(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# LiveBench (live_bench/utils.py:63-180)
# ---------------------------------------------------------------------------

_LIVEBENCH_SUBTASKS = ("Basic Understanding", "Contextual Analysis",
                       "Deeper Implications", "Broader Implications",
                       "Further Insights")


def make_live_bench(dataset_path=None) -> TaskConfig:
    """News-image QA judged 0-10 against ground truth + per-doc criteria;
    per-subtask means; empty responses rate 0 (:168-169). Offline
    10 * tokenF1."""
    def _res(d, r):
        pred = str(r[0]) if r else ""
        sub = str(d.get("subtask", ""))
        if sub not in _LIVEBENCH_SUBTASKS:
            sub = "further insights"
        if not pred:
            return {"gpt4_eval_score": 0.0, "_sub": sub}
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        rating = None
        if j is not None:
            out = j.complete(
                f"Question: {d.get('question', '')}\n"
                f"Ground truth: {gold}\nCriteria: {d.get('criteria', '')}\n"
                f"Answer: {pred}\nThe rating should be 0-10, where 0 is "
                "incorrect and 10 is correct. Respond as JSON "
                '{"Rating": n, "Explanation": "..."}.', max_tokens=256)
            if out:
                m = re.search(r"[\"']Rating[\"']\s*:\s*(\d+(?:\.\d+)?)",
                              out)
                if m:
                    rating = min(10.0, float(m.group(1)))
        if rating is None:
            rating = 10.0 * _token_f1(pred, gold)
        return {"gpt4_eval_score": rating, "_sub": sub}

    def _agg(rows):
        per: Dict[str, List[float]] = defaultdict(list)
        for row in rows:
            per[row["_sub"]].append(row["gpt4_eval_score"])
        return {k: float(np.mean(v)) for k, v in sorted(per.items())}

    return TaskConfig(
        name="live_bench",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [d["image"]] if d.get("image") is not None
        else [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("gpt4_eval_score",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"What does headline {i} imply?",
            "answer": f"event {i} occurred",
            "criteria": "accuracy of the stated event",
            "subtask": _LIVEBENCH_SUBTASKS[i % 5],
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# Ferret (ferret/utils.py:117-180 — llava-bench pairwise with rule.json)
# ---------------------------------------------------------------------------

def make_ferret(dataset_path=None) -> TaskConfig:
    """Refer-and-ground pairwise review: GPT answer as Assistant 1, the
    model as Assistant 2, category rule prompt; metric per category =
    mean(score2)/mean(score1)*100 (the llava-bench aggregation). Offline:
    the tokenF1 proxy used by llava_in_the_wild (PARITY.md)."""
    def _res(d, r):
        pred = str(r[0]) if r else ""
        gpt_ans = str(d.get("gpt_answer", ""))
        ctx = d.get("context", [])
        ctx = "\n".join(ctx) if isinstance(ctx, list) else str(ctx)
        scores = J.llava_pairwise_scores(ctx, str(d.get("question", "")),
                                         gpt_ans, pred)
        if scores is None:
            scores = (10.0, 10.0 * _token_f1(pred, gpt_ans))
        cat = str(d.get("category", "refer_desc"))
        return {"_s1": scores[0], "_s2": scores[1], "_cat": cat}

    def _agg(rows):
        per: Dict[str, List] = defaultdict(lambda: ([], []))
        for row in rows:
            per[row["_cat"]][0].append(row["_s1"])
            per[row["_cat"]][1].append(row["_s2"])
        out = {}
        alls1, alls2 = [], []
        for cat, (s1, s2) in sorted(per.items()):
            out[f"gpt_eval_ferret_{cat}"] = round(
                100.0 * np.mean(s2) / max(np.mean(s1), 1e-9), 1)
            alls1 += s1
            alls2 += s2
        out["gpt_eval_ferret_all"] = round(
            100.0 * np.mean(alls2) / max(np.mean(alls1), 1e-9), 1) \
            if alls1 else 0.0
        return out

    return TaskConfig(
        name="ferret",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"What is at region [{i}, {i}, {i + 8}, {i + 8}]?",
            "gpt_answer": f"a red marker {i}",
            "context": [f"image {i} shows markers"],
            "category": ("refer_desc", "refer_reason",
                         "ground_conv")[i % 3],
            "image": _synth_image(i)} for i in range(n)])


def register_ext4_tasks(p) -> None:
    register_task("av_odyssey", make_av_odyssey(p("AV-Odyssey")))
    register_task("vinoground", make_vinoground(p("Vinoground")))
    register_task("openhermes", make_openhermes(p("OpenHermes")))
    register_task("funqa", make_funqa(p("FunQA")))
    register_task("live_bench", make_live_bench(p("LiveBench")))
    register_task("ferret", make_ferret(p("Ferret")))
    for kind in ("detailed", "camera", "background", "main_object",
                 "short"):
        register_task(f"vdc_{kind}_test", make_vdc(kind, p("VDC")))


# ---------------------------------------------------------------------------
# VDC — Video Detailed Captioning (vdc/utils.py)
# ---------------------------------------------------------------------------

_VDC_PROMPTS = {
    "detailed": ("Please imagine the video based on the sequence of "
                 "frames, and provide a faithfully detailed description "
                 "of this video in more than three sentences."),
    "camera": ("Describe the camera movements, angles and shot "
               "transitions used in this video."),
    "background": ("Describe the background and setting of this video in "
                   "detail."),
    "main_object": ("Describe the main object or subject of this video "
                    "in detail, including its appearance and actions."),
    "short": "Write a one-sentence summary of the video.",
}


def make_vdc(kind: str = "detailed", dataset_path=None) -> TaskConfig:
    """vdc/utils.py:52-280: the reference scores by LLM-GENERATING QA
    pairs from the gold caption and grading the model caption against each
    with the yes/no + 0-5 rubric (gener_pred_score, :229-260) — that
    decomposition needs a generation endpoint. With a judge installed the
    caption is graded directly with the same rubric (one pair, the full
    caption); offline the corpus caption metrics are reported instead
    (documented deviation, PARITY.md). Metrics: accuracy (pred=='yes')
    and mean score, the reference's reported pair."""
    from msd_tpu_torch.harness.judge import videoqa_judge_score
    from msd_tpu_torch.harness.task_utils import captioning as C

    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("caption", d.get("answer", "")))
        js = videoqa_judge_score(
            _VDC_PROMPTS[kind], gold, pred)
        row = {"_pred": pred, "_refs": [gold]}
        if js is not None:
            row["accuracy"] = 1.0 if js[0] == "yes" else 0.0
            row["score"] = float(js[1])
        return row

    def _agg(rows):
        out = C.caption_scores(rows)
        accs = [r["accuracy"] for r in rows if "accuracy" in r]
        if accs:
            out["accuracy"] = float(np.mean(accs))
            out["score"] = float(np.mean([r["score"] for r in rows
                                          if "score" in r]))
        return out

    return TaskConfig(
        name=f"vdc_{kind}_test",
        doc_to_text=lambda d: _VDC_PROMPTS[kind],
        doc_to_visual=lambda d: [d.get("video", d.get("video_name", ""))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64 if kind == "short" else 256,
                    "temperature": 0.0},
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "caption": f"a person assembles device {i} on a wooden desk "
                       "while the camera pans slowly",
            "video_name": f"v{i}", "video": _synth_video(i)}
            for i in range(n)])
