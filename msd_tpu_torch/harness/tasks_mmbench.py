"""MMBench dev/test variants (EN/CN/CC) with the reference's circular
evaluation.

Reference pipeline (tasks/mmbench/mmbench_evals.py):
- prompt = hint + question + sys_prompt + lettered A-E option columns
  (en_utils.py:45-66 + mmbench_evals.py:22-30), post_prompt per language
  template yaml;
- answer inference = can_infer_option (standalone letter with the 12
  prefix/suffix tuple forms, :81-107) then can_infer_text (unique option
  substring, :109-121), then a ChatGPT match prompt (:59-79 build_prompt)
  — here routed through the pluggable judge (msd_tpu_torch.harness.judge);
- CIRCULAR scoring: dev rows repeat each question with rotated options
  under index + k*1e6; a question is a hit only when EVERY rotation's
  inferred answer equals its gold (eval_sub_data :202-221, grouping
  :284-285); hit rates overall + per category/l2-category (:223-236).

The port's own copy of the JAX package's ``harness/tasks_mmbench.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig, _synth_image

_TUPS = [("", "."), ("", ","), ("", ":"), ("", ")"), ("", ")."),
         ("(", ")"), ("(", ")."), (":", ""), (":", ","), (":", "."),
         (":", ")"), (":", ").")]


def can_infer_option(answer: str, num_choice: int = 5):
    """mmbench_evals.py:81-107 (incl. the 'A as quantifier' guard)."""
    choices = "ABCDE"[:num_choice]
    answer = str(answer)

    def count(splits, prefix="", suffix=""):
        return sum(1 for c in choices if prefix + c + suffix in splits)

    splits = [x.strip() for x in answer.split()]
    if count(splits) == 1:
        for ch in choices:
            if "A" in splits and len(splits) > 3:
                break
            if ch in splits:
                return ch
    for prefix, suffix in _TUPS:
        if count(splits, prefix, suffix) == 1:
            for ch in choices:
                if prefix + ch + suffix in splits:
                    return ch
    return False


def can_infer_text(answer: str, choices: Dict[str, str]):
    """mmbench_evals.py:109-121: unique option-text substring."""
    answer = str(answer).lower()
    cands = [k for k, v in choices.items() if str(v).lower() in answer]
    return cands[0] if len(cands) == 1 else False


def can_infer(answer: str, choices: Dict[str, str]):
    ret = can_infer_option(answer)
    return ret if ret else can_infer_text(answer, choices)


_MATCH_PROMPT = (
    "You are an AI assistant who will help me to match an answer with "
    "several options of a single-choice question. You are provided with a "
    "question, several options, and an answer, and you need to find which "
    "option is most similar to the answer. If the meaning of all options "
    "are significantly different from the answer, output E. Your should "
    "output a single uppercase character in A, B, C, D (if they are valid "
    "options), and E. \n"
    "Example 1: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog\nAnswer: a cute teddy bear\nYour output: A\n"
    "Example 2: \n"
    "Question: What is the main object in image?\nOptions: A. teddy bear "
    "B. rabbit C. cat D. dog\nAnswer: Spider\nYour output: E\n"
    "Example 3: \n"
    "Question: {}?\nOptions: {}\nAnswer: {}\nYour output: ")


def _judge_match(question: str, choices: Dict[str, str], prediction: str):
    """mmbench_evals.py:167-200 extract_answer_from_item's ChatGPT stage via
    the pluggable judge; offline -> False (the rotation scores 0, matching
    the reference's API-failure path)."""
    from msd_tpu_torch.harness.judge import get_judge
    j = get_judge()
    if j is None:
        return False
    opts = " ".join(f"{k}. {v}" for k, v in sorted(choices.items()))
    out = j.complete(_MATCH_PROMPT.format(question, opts, prediction),
                     max_tokens=8)
    if out:
        ret = can_infer_option(out.strip())
        if ret:
            return ret
    return False


def _options(d: Dict) -> Dict[str, str]:
    out = {}
    for c in "ABCD":
        v = d.get(c)
        if v is not None and str(v) not in ("nan", ""):
            out[c] = str(v)
        else:
            break
    return out


def make_mmbench(name: str, dataset_path=None, split: str = "dev",
                 sys_prompt: str = "There are several options:",
                 post_prompt: str = "\nAnswer with the option's letter "
                                    "from the given choices directly."
                 ) -> TaskConfig:
    def _text(d):
        opts = _options(d)
        options_prompt = sys_prompt + "\n" + "\n".join(
            f"{k}. {v}" for k, v in sorted(opts.items()))
        hint = d.get("hint")
        q = str(d["question"])
        base = (f"{hint} {q} {options_prompt}"
                if hint and str(hint) != "nan" else f"{q} {options_prompt}")
        return base + post_prompt

    def _res(d, r):
        choices = _options(d)
        pred = can_infer(r[0], dict(choices))
        if not pred:
            pred = _judge_match(d.get("question", ""), choices, r[0])
        gt = str(d.get("answer", "")).strip().upper()[:1]
        return {"_index": int(d.get("index", 0)),
                "_hit": 1.0 if pred and pred == gt else 0.0,
                "_cat": str(d.get("category", "")),
                "_l2": str(d.get("L2-category",
                                 d.get("l2-category", "")))}

    def _agg(rows: List[Dict]) -> Dict[str, float]:
        groups: Dict[int, List[Dict]] = {}
        for row in rows:
            groups.setdefault(int(row["_index"]) % 1000000, []).append(row)
        hits = {k: float(all(r["_hit"] for r in g))
                for k, g in groups.items()}
        out = {"gpt_eval_score": float(np.mean(list(hits.values())))
               if hits else 0.0}
        for key, field in (("cat", "_cat"), ("l2", "_l2")):
            cats: Dict[str, List[float]] = {}
            for k, g in groups.items():
                c = g[0][field]
                if c:
                    cats.setdefault(c, []).append(hits[k])
            for c, v in sorted(cats.items()):
                out[f"{key}_{c}"] = float(np.mean(v))
        return out

    def _synth(n):
        docs = []
        opts = ["red", "green", "blue", "gray"]
        for i in range(n // 2 + 1):
            # two rotations per question exercise the circular grouping
            for rot in range(2):
                o = opts[rot:] + opts[:rot]
                ans = "ABCD"[(i - rot) % 4]
                docs.append(dict(
                    {"question": f"What color is patch {i}?",
                     "hint": "The patch is a uniform color." if i % 2
                     else None,
                     "answer": ans, "index": i + rot * 1000000,
                     "category": "color", "L2-category": "perception",
                     "image": _synth_image(i)},
                    **{c: o[j] for j, c in enumerate("ABCD")}))
        return docs[:max(n, 2)]

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=lambda d: [d["image"]],
        process_results=_res,
        dataset_path=dataset_path,
        split=split,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=_agg,
        synthetic_docs=_synth)


def register_mmbench_tasks(p) -> None:
    from msd_tpu_torch.harness.registry import register_task
    cn_sys = "有如下几个选项："
    cn_post = "\n请直接使用所提供的选项字母作为答案回答。"
    register_task("mmbench_en_dev",
                  make_mmbench("mmbench_en_dev", p("MMBench"), "dev"))
    register_task("mmbench_en_test",
                  make_mmbench("mmbench_en_test", p("MMBench"), "test"))
    register_task("mmbench_cn_dev",
                  make_mmbench("mmbench_cn_dev", p("MMBench-CN"), "dev",
                               sys_prompt=cn_sys, post_prompt=cn_post))
    register_task("mmbench_cn_test",
                  make_mmbench("mmbench_cn_test", p("MMBench-CN"), "test",
                               sys_prompt=cn_sys, post_prompt=cn_post))
    register_task("mmbench_cn_cc",
                  make_mmbench("mmbench_cn_cc", p("MMBench-CN-CC"), "cc",
                               sys_prompt=cn_sys, post_prompt=cn_post))
