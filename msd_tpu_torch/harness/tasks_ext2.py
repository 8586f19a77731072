"""Round-4 task tier: seedbench_2_plus, mmmu_pro, cmmmu, cinepile,
vcr_wiki, gqa_ru, mmvetv2, llava_wilder, activitynetqa, videochatgpt.

Each maker rebuilds the reference task's prompt + scoring semantics with
file:line citations; GPT-judged tasks route through the pluggable judge
(msd_tpu_torch.harness.judge) with deterministic offline fallbacks
documented in PARITY.md.

The port's own copy of the JAX package's ``harness/tasks_ext2.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from difflib import SequenceMatcher
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image
from msd_tpu_torch.harness.registry import register_task


# ---------------------------------------------------------------------------
# SEED-Bench-2-plus (seedbench_2_plus/utils.py)
# ---------------------------------------------------------------------------

def make_seedbench_2_plus(dataset_path=None) -> TaskConfig:
    """choice_A..D columns + per question_image_type accuracy
    (seedbench_2_plus/utils.py:14-43; pred = first char of the output)."""
    def _text(d):
        q = str(d["question"])
        for c in "ABCD":
            q += f"\n{c}. {d[f'choice_{c}']}"
        return (q + "\nAnswer with the option's letter from the given "
                    "choices directly.")

    def _res(d, r):
        pred = str(r[0]).strip()
        if len(pred) > 1:
            pred = pred[0]
        ok = 1.0 if pred.lower() == str(d["answer"]).strip().lower() else 0.0
        t = str(d.get("question_image_type", "all")).capitalize()
        return {"accuracy": ok, f"_type_{t}": ok}

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_type_")}
        return {k[len("_type_"):]: float(np.mean([r[k] for r in rows
                                                  if k in r]))
                for k in sorted(keys)}

    return TaskConfig(
        name="seedbench_2_plus",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [dict(
            {"question": f"Which option is number {i % 4}?",
             "answer": "ABCD"[i % 4],
             "question_image_type": ("chart", "map", "web")[i % 3],
             "question_id": i, "image": _synth_image(i)},
            **{f"choice_{c}": f"option {j}"
               for j, c in enumerate("ABCD")}) for i in range(n)])


# ---------------------------------------------------------------------------
# MMMU-Pro (mmmu_pro/utils.py; standard 10-option MC + vision variant)
# ---------------------------------------------------------------------------

def make_mmmu_pro(variant: str = "standard", dataset_path=None) -> TaskConfig:
    """mmmu_pro/utils.py:41-56 construct_prompt + the MMMU
    parse_multi_choice_response pipeline (task_utils/mmmu.py). The vision
    variant embeds the question in the image; its prompt is the fixed
    'Answer with the option letter' instruction (utils.py:50-57)."""
    from msd_tpu_torch.harness.task_utils import mmmu as MU

    def _opts(d) -> List[str]:
        o = d.get("options")
        if isinstance(o, str):
            import ast
            o = ast.literal_eval(o)
        return [str(x) for x in (o or [])]

    def _text(d):
        if variant == "vision":
            return ("Answer with the option letter from the given choices "
                    "directly. The last line of your response should be of "
                    "the following format: 'Answer: $LETTER' (without "
                    "quotes) where LETTER is one of options.")
        opts = _opts(d)
        letters = [chr(ord("A") + i) for i in range(len(opts))]
        lines = "\n".join(f"{c}. {o}" for c, o in zip(letters, opts))
        q = re.sub(r"<image \d+>", "", str(d["question"])).strip()
        return (f"{q}\n{lines}\n\nAnswer with the option letter from the "
                "given choices directly.")

    def _res(d, r):
        opts = _opts(d)
        if opts:
            index2ans, all_choices = MU.get_multi_choice_info(opts)
            pred = MU.parse_multi_choice_response(str(r[0]), all_choices,
                                                  index2ans)
        else:
            pred = str(r[0]).strip()[:1].upper()
        ok = 1.0 if pred == str(d.get("answer", "")).strip() else 0.0
        sub = str(d.get("subject", d.get("category", "")))
        out = {"accuracy": ok}
        if sub:
            out[f"_sub_{sub}"] = ok
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_sub_")}
        return {k[len("_sub_"):]: float(np.mean([r[k] for r in rows
                                                 if k in r]))
                for k in sorted(keys)}

    def _vis(d):
        if variant == "vision":
            return [d["image"]]
        out = []
        for i in range(1, 8):
            im = d.get(f"image_{i}")
            if im is not None:
                out.append(im)
        return out or [d.get("image_1", d.get("image"))]

    return TaskConfig(
        name=f"mmmu_pro_{variant}",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"<image 1> Which option is number {i % 10}?",
            "options": [f"option {j}" for j in range(10)],
            "answer": "ABCDEFGHIJ"[i % 10], "subject": "synthetic",
            "id": str(i), "image_1": _synth_image(i),
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# CMMMU (cmmmu/utils.py: Chinese MC / true-false / fill-blank)
# ---------------------------------------------------------------------------

def make_cmmmu(dataset_path=None) -> TaskConfig:
    """cmmmu/utils.py:20-75: prompt per type (选择 options A-D, 判断
    yes/no, 填空 free), per-subdomain accuracy aggregation. Answer
    extraction is a compact rebuild: MC via the MMMU choice parser,
    判断 via 对/错/是/否 markers, fill-blank via normalized containment
    (the reference's get_fill_blank_prediction segmentation heuristics
    reduce to this on its own test vectors)."""
    from msd_tpu_torch.harness.task_utils import mmmu as MU

    def _text(d):
        t = str(d.get("type", "选择"))
        q = re.sub(r"<图片 \d+>", "", str(d["question"])).strip()
        if t == "选择":
            lines = "\n".join(f"{c}. {d.get(f'option{i}', '')}"
                              for i, c in enumerate("ABCD", start=1))
            return f"{q}\n{lines}\n请直接回答选项字母。"
        if t == "判断":
            return f"{q}\n请直接回答“对”或“错”。"
        return f"{q}\n请直接给出答案。"

    def _res(d, r):
        t = str(d.get("type", "选择"))
        pred = str(r[0]).strip()
        ans = str(d.get("answer", "")).strip()
        if t == "选择":
            opts = [str(d.get(f"option{i}", "")) for i in range(1, 5)]
            index2ans, all_choices = MU.get_multi_choice_info(opts)
            p = MU.parse_multi_choice_response(pred, all_choices, index2ans)
            ok = 1.0 if p == ans else 0.0
        elif t == "判断":
            yes = any(m in pred for m in ("对", "是", "正确")) and \
                not any(m in pred[:2] for m in ("错", "否", "不"))
            gold_yes = any(m in ans for m in ("对", "是", "正确"))
            ok = 1.0 if yes == gold_yes else 0.0
        else:
            norm = lambda s: re.sub(r"[\s,，。.:：]", "", s).lower()  # noqa
            ok = 1.0 if norm(ans) and norm(ans) in norm(pred) else 0.0
        sub = str(d.get("subcategory", ""))
        out = {"accuracy": ok}
        if sub:
            out[f"_sub_{sub}"] = ok
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_sub_")}
        return {k[len("_sub_"):]: float(np.mean([r[k] for r in rows
                                                 if k in r]))
                for k in sorted(keys)}

    def _vis(d):
        out = []
        for i in range(1, 6):
            im = d.get(f"image_{i}")
            if im is not None:
                out.append(im)
        return out or [d.get("image")]

    def _synth(n):
        docs = []
        for i in range(n):
            kind = ("选择", "判断", "填空")[i % 3]
            base = {"question": f"<图片 1> 第{i}题", "type": kind,
                    "subcategory": "synthetic", "id": str(i),
                    "image_1": _synth_image(i)}
            if kind == "选择":
                base.update({f"option{j + 1}": f"选项{j}" for j in range(4)})
                base["answer"] = "ABCD"[i % 4]
            elif kind == "判断":
                base["answer"] = "对" if i % 2 == 0 else "错"
            else:
                base["answer"] = f"{i}"
            docs.append(base)
        return docs

    return TaskConfig(
        name="cmmmu_val",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        split="val",
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# CinePile (cinepile/utils.py video MC over answer_key_position/text)
# ---------------------------------------------------------------------------

def _cinepile_normalize(s: str):
    """cinepile/utils.py:75-95 normalize_string."""
    s = str(s).replace("*", "").strip()
    if re.match(r"^[A-E]$", s, re.IGNORECASE):
        return s.upper(), ""
    m = re.search(r"Answer:\s*([A-E])\)?\.?\s*(.*)", s, re.IGNORECASE)
    if m:
        return m.group(1).upper(), m.group(2).strip()
    return None, s.strip()


def cinepile_eval(response: str, key_letter: str, key_text: str) -> float:
    """cinepile/utils.py:96-120 evaluate_semantic_similarity."""
    num, text = _cinepile_normalize(response)
    if key_letter and num:
        if key_letter == num:
            if key_text and text:
                return 1.0 if key_text.lower() == text.lower() else 0.0
            return 1.0
        return 0.0
    return 1.0 if str(key_text).lower() == text.lower() else 0.0


def make_cinepile(dataset_path=None) -> TaskConfig:
    def _text(d):
        opts = d.get("choices", d.get("options", []))
        lines = "\n".join(f"- {c}) {o}" for c, o in zip("ABCDE", opts))
        return (f"{d['question']}\n{lines}\nAnswer with the option letter "
                "and text, e.g. 'Answer: A) ...'.")

    def _res(d, r):
        key_letter = "ABCDE"[int(d.get("answer_key_position", 0))]
        ok = cinepile_eval(r[0], key_letter, str(d.get("answer_key", "")))
        cat = str(d.get("question_category", ""))
        hard = str(d.get("hard_split", "False"))
        out = {"accuracy": ok}
        if cat:
            out[f"_cat_{cat}"] = ok
        if hard == "True":
            out["_hard"] = ok
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_")}
        return {k.lstrip("_"): float(np.mean([r[k] for r in rows if k in r]))
                for k in sorted(keys)}

    def _synth(n):
        rng = np.random.default_rng(31)
        return [{
            "question": f"What happens at time {i}?",
            "choices": [f"event {j}" for j in range(5)],
            "answer_key_position": i % 5,
            "answer_key": f"event {i % 5}",
            "question_category": "Temporal", "hard_split": "False",
            "video": rng.integers(0, 255, size=(4, 32, 32, 3),
                                  dtype=np.uint8)} for i in range(n)]

    return TaskConfig(
        name="cinepile",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d.get("video", d.get("video_path"))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# VCR-wiki (vcr_wiki/utils.py caption restoration; en/zh, easy/hard)
# ---------------------------------------------------------------------------

_REFUSALS = ("I can't", "I cannot", "sorry", "无法", "抱歉")


def _vcr_tokenize(text: str, language: str) -> List[str]:
    # deviation from the reference (documented): spacy is unavailable
    # offline; en uses word regex tokens, zh uses characters
    if language == "zh":
        return [c for c in re.sub(r"\s", "", str(text))]
    return re.findall(r"\w+|[^\w\s]", str(text))


def vcr_score_single(crossed_text: str, result: str, language: str) -> Dict:
    """vcr_wiki/utils.py:100-187: best n-gram window by SequenceMatcher
    ratio, then exact_match / jaccard / f1 over token sets."""
    zero = {"exact_match": 0.0, "jaccard": 0.0, "f1": 0.0}
    if any(m in result for m in _REFUSALS) or "sorry" in result.lower():
        return zero
    toks_r = _vcr_tokenize(result, language)
    toks_c = _vcr_tokenize(crossed_text, language)
    if not toks_r or not toks_c or len(toks_r) < len(toks_c):
        return zero
    n = len(toks_c)
    splitter = " " if language == "en" else ""
    cset = set(toks_c)
    best_val, best_ngram = 0.0, []
    for i in range(len(toks_r) - n + 1):
        ng = toks_r[i:i + n]
        if cset.isdisjoint(ng):
            continue
        sim = SequenceMatcher(None, splitter.join(ng), crossed_text).ratio()
        if sim > best_val:
            best_val, best_ngram = sim, ng
    if not best_ngram:
        return zero
    pset, rset = set(best_ngram), cset
    inter = len(pset & rset)
    prec, rec = inter / len(pset), inter / len(rset)
    f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
    jac = inter / len(pset | rset)
    return {"exact_match": float(best_ngram == toks_c), "jaccard": jac,
            "f1": f1}


def make_vcr(language: str = "en", difficulty: str = "easy",
             dataset_path=None) -> TaskConfig:
    pre = ("What is the covered texts in the image? Please restore the "
           "covered texts without outputting the explanations."
           if language == "en" else
           "图像中被覆盖的文本是什么？请在不输出解释的情况下还原被覆盖的文本。")

    def _res(d, r):
        crossed = d.get("crossed_text") or []
        if isinstance(crossed, str):
            crossed = [crossed]
        scores = [vcr_score_single(c, str(r[0]), language) for c in crossed]
        if not scores:
            return {"exact_match": 0.0, "jaccard": 0.0}
        return {"exact_match": float(np.mean([s["exact_match"]
                                              for s in scores])),
                "jaccard": float(np.mean([s["jaccard"] for s in scores]))}

    def _synth(n):
        docs = []
        for i in range(n):
            word = (f"hidden words {i}" if language == "en" else f"隐藏{i}")
            docs.append({"crossed_text": [word],
                         "caption": f"context {word} context",
                         "stacked_image": _synth_image(i),
                         "image": _synth_image(i)})
        return docs

    return TaskConfig(
        name=f"vcr_wiki_{language}_{difficulty}",
        doc_to_text=lambda d: pre,
        doc_to_visual=lambda d: [d.get("stacked_image", d.get("image"))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=("exact_match", "jaccard"),
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# MM-Vet v2 (mmvetv2/utils.py; same <AND>/<OR> judge algebra as v1 with
# the capability-set column)
# ---------------------------------------------------------------------------

def make_mmvetv2(dataset_path=None) -> TaskConfig:
    from msd_tpu_torch.harness import metrics as M

    def _part_hit(part: str, pred: str) -> float:
        pn = M.normalize_extract(pred)
        for alt in (a.strip() for a in part.split("<OR>")):
            an = M.normalize_extract(alt)
            if an and (an in pn or M.relaxed_correctness(pred, alt)):
                return 1.0
        return 0.0

    def _res(d, r):
        gt = str(d.get("answer", ""))
        from msd_tpu_torch.harness.judge import mmvet_judge_score
        js = mmvet_judge_score(d.get("question", ""), gt, r[0])
        if js is None:
            parts = [p.strip() for p in gt.split("<AND>") if p.strip()]
            js = (sum(_part_hit(p, r[0]) for p in parts) / len(parts)
                  if parts else 0.0)
        out = {"gpt_eval_score": js}
        caps = str(d.get("capability", ""))
        for cap in (c.strip() for c in caps.split(",") if c.strip()):
            out[f"_cap_{cap}"] = js
        return out

    def _agg(rows):
        keys = {k for row in rows for k in row if k.startswith("_cap_")}
        return {k[len("_cap_"):]: float(np.mean([r[k] for r in rows
                                                 if k in r]))
                for k in sorted(keys)}

    def _vis(d):
        ims = [v for k, v in sorted(d.items())
               if k.startswith("image") and v is not None]
        return ims or [d.get("image")]

    return TaskConfig(
        name="mmvetv2",
        doc_to_text=lambda d: str(d["question"]).replace("<IMG>", "").strip(),
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 512, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "question": f"<IMG> What are the two numbers shown? (doc {i})",
            "answer": f"{i} <AND> {i + 1}" if i % 2 == 0
            else f"{i} <OR> {i * 10}",
            "capability": "ocr,math",
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# LLaVA-Wilder (llava_wilder/utils.py — judged single-answer quality vs the
# GPT-4V reference answer; docs carry Question/Answer columns)
# ---------------------------------------------------------------------------

def make_llava_wilder(dataset_path=None) -> TaskConfig:
    from msd_tpu_torch.harness.tasks_judge import _token_f1

    def _res(d, r):
        from msd_tpu_torch.harness.judge import llava_pairwise_scores
        ans1 = str(d.get("Answer", d.get("gpt_answer", "")))
        ans2 = str(r[0]) if r else ""
        scores = llava_pairwise_scores("", d.get("Question",
                                                 d.get("question", "")),
                                       ans1, ans2)
        if scores is None:
            scores = (10.0, 10.0 * _token_f1(ans2, ans1))
        return {"_pair": (float(scores[0]), float(scores[1]))}

    def _agg(rows):
        pairs = [r["_pair"] for r in rows if r.get("_pair")]
        if not pairs:
            return {"gpt_eval_llava_all": 0.0}
        s1 = float(np.mean([p[0] for p in pairs]))
        s2 = float(np.mean([p[1] for p in pairs]))
        return {"gpt_eval_llava_all": round(s2 / max(s1, 1e-9) * 100, 1)}

    return TaskConfig(
        name="llava_wilder_small",
        doc_to_text=lambda d: str(d.get("Question", d.get("question", ""))),
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "Question": f"Describe image {i}.",
            "Answer": f"A synthetic test chart number {i}.",
            "image": _synth_image(i)} for i in range(n)])


# ---------------------------------------------------------------------------
# ActivityNet-QA + VideoChatGPT generic dims (judge-backed video QA)
# ---------------------------------------------------------------------------

def _videoqa_offline(answer: str, pred: str):
    """Offline stand-in for the video-QA judge: yes iff the normalized gold
    appears in the prediction (ActivityNet answers are near-atomic);
    score = 5 * tokenF1 (documented proxy, PARITY.md)."""
    from msd_tpu_torch.harness.tasks_judge import _token_f1
    a = str(answer).strip().lower()
    p = str(pred).strip().lower()
    hit = bool(a) and (a in p or p in a)
    return ("yes" if hit else "no", 5.0 * _token_f1(pred, answer))


def make_activitynetqa(dataset_path=None) -> TaskConfig:
    """activitynetqa/utils.py:63-88 prompt (+ yes/no hint for type 3) and
    :182-209 scoring: GPT yes/no + 0-5 score via the shared video-QA rubric
    (msd_tpu_torch.harness.judge.videoqa_judge_score), offline containment
    proxy otherwise. Reports accuracy (pred=='yes' rate) and average score."""
    def _text(d):
        q = str(d["question"])
        if str(d.get("type", "")) == "3":
            q += " Please answer with 'yes' or 'no'."
        return q

    def _res(d, r):
        from msd_tpu_torch.harness.judge import videoqa_judge_score
        js = videoqa_judge_score(d.get("question", ""),
                                 str(d.get("answer", "")), str(r[0]))
        if js is None:
            js = _videoqa_offline(d.get("answer", ""), r[0])
        return {"accuracy": 1.0 if js[0] == "yes" else 0.0,
                "score": float(js[1])}

    def _synth(n):
        rng = np.random.default_rng(47)
        return [{"question": f"what is shown in clip {i}",
                 "answer": f"pattern {i}", "type": str(i % 4),
                 "question_id": f"v{i}_q", "video_name": f"v{i}",
                 "video": rng.integers(0, 255, size=(4, 32, 32, 3),
                                       dtype=np.uint8)} for i in range(n)]

    return TaskConfig(
        name="activitynetqa",
        doc_to_text=_text,
        doc_to_visual=lambda d: [d.get("video", d.get("video_path"))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=("accuracy", "score"),
        synthetic_docs=_synth)


def make_videochatgpt_gen(dataset_path=None) -> TaskConfig:
    """videochatgpt generic dims (videochatgpt/utils.py): correctness /
    detail orientation / contextual understanding, each a 0-5 judge score
    against the reference answer (same rubric family as activitynetqa);
    offline proxy = 5 * tokenF1 per dim."""
    def _res(d, r):
        from msd_tpu_torch.harness.judge import videoqa_judge_score
        js = videoqa_judge_score(d.get("question", ""),
                                 str(d.get("answer", "")), str(r[0]))
        if js is None:
            js = _videoqa_offline(d.get("answer", ""), r[0])
        s = float(js[1])
        return {"correctness": s, "detail_orientation": s,
                "context_understanding": s}

    def _synth(n):
        rng = np.random.default_rng(53)
        return [{"question": f"describe activity {i}",
                 "answer": f"a person does activity {i}",
                 "video_name": f"v{i}",
                 "video": rng.integers(0, 255, size=(4, 32, 32, 3),
                                       dtype=np.uint8)} for i in range(n)]

    return TaskConfig(
        name="videochatgpt_gen",
        doc_to_text=lambda d: str(d["question"]),
        doc_to_visual=lambda d: [d.get("video", d.get("video_path"))],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("correctness", "detail_orientation",
                      "context_understanding"),
        synthetic_docs=_synth)


# ---------------------------------------------------------------------------
# registration
# ---------------------------------------------------------------------------

def register_ext2_tasks(p) -> None:
    from msd_tpu_torch.harness.tasks import make_textvqa
    register_task("seedbench_2_plus", make_seedbench_2_plus(
        p("SEED-Bench-2-plus")))
    register_task("mmmu_pro_standard",
                  make_mmmu_pro("standard", p("MMMU_Pro")))
    register_task("mmmu_pro_vision", make_mmmu_pro("vision", p("MMMU_Pro")))
    register_task("cmmmu_val", make_cmmmu(p("CMMMU")))
    register_task("cinepile", make_cinepile(p("CinePile")))
    register_task("vcr_wiki_en_easy", make_vcr("en", "easy",
                                               p("VCR-wiki-en-easy")))
    register_task("vcr_wiki_en_hard", make_vcr("en", "hard",
                                               p("VCR-wiki-en-hard")))
    register_task("vcr_wiki_zh_easy", make_vcr("zh", "easy",
                                               p("VCR-wiki-zh-easy")))
    register_task("vcr_wiki_zh_hard", make_vcr("zh", "hard",
                                               p("VCR-wiki-zh-hard")))
    # gqa_ru: the Russian GQA release scores exactly like gqa
    # (gqa_ru/utils.py == gqa/utils.py exact-match pipeline)
    register_task("gqa_ru", make_textvqa(p("GQA-ru")))
    register_task("mmvetv2", make_mmvetv2(p("MM-Vet-v2")))
    register_task("llava_wilder_small", make_llava_wilder(
        p("llava-bench-wilder")))
    register_task("activitynetqa", make_activitynetqa(p("ActivityNet-QA")))
    register_task("videochatgpt_gen", make_videochatgpt_gen(
        p("VideoChatGPT")))
