"""Task definitions (the YAML-driven ConfigurableTask of lmms-eval, in code).

Mirrors lmms-eval/lmms_eval/api/task.py behaviors the MSD pipeline uses:
- doc iteration with rank/world_size sharding and the ``bottom`` mode that
  takes the LAST N docs (api/task.py:669-686),
- generate_until requests with per-task gen_kwargs,
- per-doc process_results -> metric dict, mean aggregation.

The five benchmark tasks of BASELINE.json are registered (chartqa, textvqa,
mathvista, ai2d, mathverse, + iconqa). Datasets resolve from (in order)
``dataset_path`` (a local HF-datasets dir or JSON file) or a deterministic
synthetic fallback so the full pipeline is testable offline.

The port's own copy of the JAX package's ``harness/tasks.py``: every
``make_*`` task it defines, registered by ``register_builtin_tasks`` as
the JAX module registers them, with the YAML tasks of ``$MSD_TPU_TASKS``
(``yaml_task.py``) and every task module the JAX copy calls into
(``tasks_ext``, ``tasks_judge``, ``tasks_mmbench``, ``tasks_ext2``,
``tasks_ext3``, ``tasks_mmupd``, ``tasks_judge2``, ``tasks_audio``,
``tasks_ext4`` and ``tasks_mmsearch``), in the JAX copy's order: a later
registration replaces an earlier one of the same name. Judged scorers
ask the judge of ``judge.py`` when one is installed and fall back to
their offline rules, as the JAX copy's do.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from msd_tpu_torch.harness import metrics as M
from msd_tpu_torch.harness.instance import Instance
from msd_tpu_torch.harness.registry import register_task


@dataclass
class TaskConfig:
    name: str
    doc_to_text: Callable[[Dict], str]
    doc_to_visual: Callable[[Dict], List]
    process_results: Callable[[Dict, List[str]], Dict[str, float]]
    dataset_path: Optional[str] = None
    split: str = "test"
    gen_kwargs: Dict[str, Any] = field(default_factory=lambda: {
        "max_new_tokens": 512, "temperature": 0.0})
    metric_names: Sequence[str] = ("accuracy",)
    synthetic_docs: Optional[Callable[[int], List[Dict]]] = None
    # request type (api/task.py OUTPUT_TYPE): "generate_until" |
    # "loglikelihood" | "generate_until_multi_round"
    output_type: str = "generate_until"
    # loglikelihood tasks: either one target per doc (doc_to_target) or one
    # request per choice (doc_to_choice) scored by likelihood
    doc_to_target: Optional[Callable[[Dict], str]] = None
    doc_to_choice: Optional[Callable[[Dict], List[str]]] = None
    # optional whole-result-set aggregation (e.g. MME's acc_plus pairs):
    # receives the per-doc result dicts, returns extra aggregate metrics
    aggregate_extra: Optional[Callable[[List[Dict]], Dict[str, float]]] = None
    # documented scoring deviation vs the reference pipeline (PARITY.md
    # "Documented scoring deviations"): surfaced verbatim in the
    # evaluator's per-task details so reported numbers carry their own
    # comparability caveat (round-4 VERDICT weak #5)
    scoring_deviation: Optional[str] = None

    # ------------------------------------------------------------------
    def load_docs(self, limit=None) -> List[Dict]:
        docs = None
        self.used_synthetic_docs = False
        if self.dataset_path:
            docs = _load_local(self.dataset_path, self.split)
        if docs is None and self.synthetic_docs is not None:
            # a fractional limit has no total to take a fraction of here;
            # synthesize a fixed pool and apply it below
            n = limit if isinstance(limit, int) and limit else 64
            docs = self.synthetic_docs(n)
            # LOUD marker: results computed on synthetic fallback docs must
            # never be mistaken for a real benchmark run
            self.used_synthetic_docs = True
            import sys
            print(f"WARNING: task {self.name}: no dataset at "
                  f"{self.dataset_path!r} — serving SYNTHETIC docs "
                  "(results are a pipeline check, not a benchmark score)",
                  file=sys.stderr)
        if docs is None:
            raise FileNotFoundError(
                f"task {self.name}: no dataset at {self.dataset_path!r} and "
                "no synthetic fallback")
        if limit:
            # float < 1 = fraction of the total docs, like the reference's
            # --limit (lmms-eval/__main__.py:150-153, evaluator.py)
            if isinstance(limit, float) and 0 < limit < 1:
                limit = max(1, int(len(docs) * limit))
            docs = docs[:int(limit)]
        return docs

    def doc_iterator(self, docs: List[Dict], rank: int = 0,
                    world_size: int = 1, limit: Optional[int] = None,
                    bottom: Optional[int] = None):
        """Shard docs by rank; ``bottom`` takes the LAST N docs
        (api/task.py:669-686)."""
        if bottom:
            docs = docs[-bottom:]
        elif limit:
            if isinstance(limit, float) and 0 < limit < 1:
                limit = max(1, int(len(docs) * limit))
            docs = docs[:int(limit)]
        for i, doc in enumerate(docs):
            if i % world_size == rank:
                yield i, doc

    def fewshot_context(self, docs: List[Dict], doc_id: int,
                        num_fewshot: int) -> str:
        """Deterministic k-shot prefix (api/task.py fewshot_context /
        samplers.py FirstNSampler): the first k OTHER docs of the split,
        rendered as 'prompt target' pairs. Text-only — fewshot visuals are
        not spliced (matches the reference VLM tasks, which run 0-shot; the
        flag surface still behaves for text-style tasks)."""
        parts = []
        for i, d in enumerate(docs):
            if len(parts) >= num_fewshot:
                break
            if i == doc_id:
                continue
            tgt = None
            if self.doc_to_target is not None:
                t = self.doc_to_target
                tgt = t(d) if callable(t) else str(t)
            if tgt is None:
                tgt = d.get("answer", "")
                if isinstance(tgt, (list, tuple)):
                    tgt = tgt[0] if tgt else ""
            parts.append(f"{self.doc_to_text(d)} {tgt}".strip())
        return "\n\n".join(parts) + ("\n\n" if parts else "")

    def build_requests(self, docs: List[Dict], rank: int = 0,
                       world_size: int = 1, limit: Optional[int] = None,
                       bottom: Optional[int] = None,
                       num_fewshot: int = 0,
                       system_instruction: Optional[str] = None,
                       gen_kwargs_override: Optional[Dict] = None
                       ) -> List[Instance]:
        reqs = []
        # merge per-call: writing the override back to self would leak it
        # into later runs of a --config sweep (TaskConfig lives in the
        # process-global registry)
        gen_kwargs = ({**self.gen_kwargs, **gen_kwargs_override}
                      if gen_kwargs_override else self.gen_kwargs)
        for doc_id, doc in self.doc_iterator(docs, rank, world_size, limit,
                                             bottom):
            ctx = self.doc_to_text(doc)
            if num_fewshot:
                ctx = self.fewshot_context(docs, doc_id, num_fewshot) + ctx
            if system_instruction:
                ctx = f"{system_instruction}\n\n{ctx}"
            if self.output_type == "loglikelihood":
                if self.doc_to_choice is not None:
                    targets = list(self.doc_to_choice(doc))
                else:
                    tgt = self.doc_to_target
                    targets = [tgt(doc) if callable(tgt) else str(tgt)]
                for i, tgt in enumerate(targets):
                    reqs.append(Instance(
                        request_type="loglikelihood", doc=doc,
                        arguments=(ctx, tgt, self.doc_to_visual, doc_id,
                                   self.name, self.split),
                        idx=i, task_name=self.name, doc_id=doc_id))
            elif self.output_type == "generate_until_multi_round":
                reqs.append(Instance(
                    request_type="generate_until_multi_round", doc=doc,
                    arguments=(ctx, dict(gen_kwargs),
                               self.doc_to_visual, self.doc_to_text,
                               doc_id, self.name, self.split),
                    idx=0, task_name=self.name, doc_id=doc_id))
            else:
                reqs.append(Instance(
                    request_type="generate_until", doc=doc,
                    arguments=(ctx, dict(gen_kwargs),
                               self.doc_to_visual, doc_id, self.name,
                               self.split),
                    idx=len(reqs), task_name=self.name, doc_id=doc_id))
        return reqs

    def aggregate(self, results: List[Dict[str, float]]) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name in self.metric_names:
            vals = [r[name] for r in results if name in r]
            if vals:
                out[name] = M.mean(vals)
                # bootstrap stderr alongside every mean aggregation
                # (evaluator.py bootstrap + api/metrics.py stderr)
                out[name + "_stderr"] = M.bootstrap_stderr(vals)
        if self.aggregate_extra is not None:
            out.update(self.aggregate_extra(results))
        return out


def _load_local(path: str, split: str) -> Optional[List[Dict]]:
    if not os.path.exists(path):
        return None
    if path.endswith(".json") or path.endswith(".jsonl"):
        with open(path) as f:
            if path.endswith(".jsonl"):
                return [json.loads(l) for l in f if l.strip()]
            return json.load(f)
    try:
        import datasets
        if os.path.isdir(os.path.join(path, split)):
            ds = datasets.load_from_disk(path)[split]
        else:
            ds = datasets.load_dataset(path, split=split)
        return list(ds)
    except Exception:
        return None


# ---------------------------------------------------------------------------
# synthetic fallback docs (deterministic; for offline runs/tests)
# ---------------------------------------------------------------------------

def _synth_image(seed: int, size: int = 336) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
    return img


def _synth_vqa_docs(n: int) -> List[Dict]:
    docs = []
    for i in range(n):
        docs.append({
            "question": f"What is the value of bar {i}?",
            "answer": str(i % 10),
            "answers": [str(i % 10)] * 10,
            "image": _synth_image(i),
            "type": "human_test" if i % 2 == 0 else "augmented_test",
        })
    return docs


# ---------------------------------------------------------------------------
# benchmark task definitions
# ---------------------------------------------------------------------------

def _visual(doc):
    return [doc["image"]]


def _chartqa_results(doc, results):
    score = 1.0 if M.relaxed_correctness(results[0], doc["answer"]) else 0.0
    out = {"relaxed_overall": score}
    if doc.get("type") == "human_test":
        out["relaxed_human_split"] = score
    else:
        out["relaxed_augmented_split"] = score
    return out


def make_chartqa(dataset_path=None) -> TaskConfig:
    return TaskConfig(
        name="chartqa",
        doc_to_text=lambda d: (f"{d['question']}\nAnswer the question with "
                               "a single word."),
        doc_to_visual=_visual,
        process_results=_chartqa_results,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("relaxed_overall", "relaxed_human_split",
                      "relaxed_augmented_split"),
        synthetic_docs=_synth_vqa_docs)


def make_textvqa(dataset_path=None, name="textvqa") -> TaskConfig:
    """Real TextVQA HF schema: question / answers (10 annotator strings) /
    question_id / image (tasks/textvqa/utils.py:15-58 — question is
    capitalized, VQAv2 min(1, matches/3) rule over normalized answers)."""
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: (f"{str(d['question']).capitalize()}\n"
                               "Answer the question using a single word or "
                               "phrase."),
        doc_to_visual=_visual,
        process_results=lambda d, r: {
            "exact_match": M.vqa_accuracy(r[0], d.get("answers",
                                                      [d.get("answer", "")]))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("exact_match",),
        synthetic_docs=_synth_vqa_docs)


def _mc_letter(answer, n_options: int) -> str:
    """AI2D-style answers are option indices ('2'); MMBench-style are
    letters ('C') — normalize to the letter (tasks/ai2d/utils.py:31-38)."""
    s = str(answer).strip()
    if s.isdigit():
        return chr(ord("A") + int(s))
    return s.upper()[:1]


def _mc_text(d) -> str:
    opts = d.get("options") or d.get("choices") or []
    letters = [chr(ord("A") + i) for i in range(len(opts))]
    # already-lettered options ("A. foo") pass through; bare texts get
    # lettered (the ai2d mcq prompt_format, tasks/ai2d/utils.py:7-18)
    if opts and not str(opts[0]).rstrip().startswith(("A.", "A)")):
        lines = [f"{l}. {o}" for l, o in zip(letters, opts)]
    else:
        lines = [str(o) for o in opts]
    return (d["question"] + ("\n" + "\n".join(lines) if lines else "")
            + "\nAnswer with the option's letter from the given choices "
              "directly.")


def make_mc_task(name: str, dataset_path=None) -> TaskConfig:
    return TaskConfig(
        name=name,
        doc_to_text=_mc_text,
        doc_to_visual=_visual,
        process_results=lambda d, r: {
            "accuracy": M.mc_accuracy(
                r[0], _mc_letter(d["answer"],
                                 len(d.get("options")
                                     or d.get("choices") or [])))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "options": [f"option {j}" for j in range(4)],
            "answer": str(i % 4),
            "image": _synth_image(i),
        } for i in range(n)])


def make_mathvista(dataset_path=None) -> TaskConfig:
    """Real MathVista schema (question_type/answer_type/choices/precision/
    decoded_image) with the reference's extraction->normalize->safe_equal
    pipeline rebuilt offline (task_utils/mathvista.py; ref
    tasks/mathvista/utils.py + mathvista_evals.py)."""
    from msd_tpu_torch.harness.task_utils import mathvista as MV
    return TaskConfig(
        name="mathvista",
        doc_to_text=MV.doc_to_text,
        doc_to_visual=MV.doc_to_visual,
        process_results=MV.process_results,
        dataset_path=dataset_path,
        split="testmini",
        gen_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        synthetic_docs=lambda n: [(
            {"question": f"Which letter marks value {i % 4}?",
             "question_type": "multi_choice", "answer_type": "text",
             "choices": [f"value {j}" for j in range(4)],
             "answer": f"value {i % 4}", "precision": 0,
             "query": "", "pid": str(i), "metadata": {"split": "testmini"},
             "image": _synth_image(i)}
            if i % 2 == 0 else
            {"question": f"What is {i} plus {i}?",
             "question_type": "free_form", "answer_type": "integer",
             "choices": None, "answer": str(2 * i), "precision": 0,
             "query": "", "pid": str(i), "metadata": {"split": "testmini"},
             "image": _synth_image(i)}) for i in range(n)])


def make_mathverse(dataset_path=None) -> TaskConfig:
    """Real MathVerse schema (query_wo/query_cot/problem_version/
    sample_index) with offline extraction+match scoring
    (task_utils/mathverse.py; ref tasks/mathverse/utils.py)."""
    from msd_tpu_torch.harness.task_utils import mathverse as MVE
    return TaskConfig(
        name="mathverse",
        doc_to_text=MVE.doc_to_text,
        doc_to_visual=MVE.doc_to_visual,
        process_results=MVE.process_results,
        dataset_path=dataset_path,
        split="testmini",
        gen_kwargs={"max_new_tokens": 1024, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        synthetic_docs=lambda n: [{
            "question": f"What is {i} times 2?",
            "query_wo": (f"What is {i} times 2? Please answer the question "
                         "and provide the final answer at the end."),
            "query_cot": f"What is {i} times 2? Reason step by step.",
            "question_type": "free-form", "problem_version": "Text Only",
            "answer": str(2 * i), "sample_index": str(i),
            "problem_index": str(i), "metadata": {"split": "testmini"},
            "image": _synth_image(i)} for i in range(n)])


def make_freeform_task(name: str, dataset_path=None) -> TaskConfig:
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: d["question"],
        doc_to_visual=_visual,
        process_results=lambda d, r: {
            "exact_match": M.exact_match(r[0], d["answer"])},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=("exact_match",),
        synthetic_docs=_synth_vqa_docs)


def make_anls_task(name: str, dataset_path=None) -> TaskConfig:
    """DocVQA/InfoVQA-style: ANLS over the answer list."""
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: (f"{d['question']}\nAnswer the question using "
                               "a single word or phrase."),
        doc_to_visual=_visual,
        process_results=lambda d, r: {
            "anls": M.anls(r[0], d.get("answers", [d.get("answer", "")]))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("anls",),
        synthetic_docs=_synth_vqa_docs)


def make_mc_ppl_task(name: str, dataset_path=None) -> TaskConfig:
    """Multiple-choice scored BY LIKELIHOOD (output_type=loglikelihood):
    one request per option, pick the argmax logprob (the lmms-eval
    ppl-style MC pattern, api/task.py doc_to_choice)."""
    def _choices(d):
        opts = d.get("options") or d.get("choices") or []
        # strip "A. " style prefixes: the scored continuation is the text
        return [o.split(". ", 1)[-1] if isinstance(o, str) else str(o)
                for o in opts]

    def _res(d, results):
        # results: [(logprob, is_greedy), ...] aligned with choices
        lps = [lp for lp, _ in results]
        pred = int(np.argmax(lps)) if lps else -1
        ans = d["answer"]
        # real AI2D answers are option-index strings ("2"); letters otherwise
        if isinstance(ans, str) and ans.strip():
            a = ans.strip()
            gold = int(a) if a.isdigit() else "ABCDEFGH".index(a.upper()[0])
        else:
            gold = int(ans)
        return {"accuracy": 1.0 if pred == gold else 0.0}

    return TaskConfig(
        name=name,
        doc_to_text=lambda d: (
            d["question"] + ("\n" + "\n".join(d["options"])
                             if d.get("options") else "")
            + "\nAnswer with the option's letter from the given choices "
              "directly."),
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_choice=_choices,
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "options": [f"{c}. option {j}" for j, c in enumerate("ABCD")],
            "answer": "ABCD"[i % 4],
            "image": _synth_image(i),
        } for i in range(n)])


def make_yesno_task(name: str, dataset_path=None) -> TaskConfig:
    """POPE-style binary hallucination probe (yes/no accuracy + yes-rate)."""
    def _res(d, r):
        pred = r[0].strip().lower().rstrip(".")
        pred = "yes" if pred.startswith("yes") else (
            "no" if pred.startswith("no") else pred)
        return {"accuracy": 1.0 if pred == d["answer"].lower() else 0.0,
                "yes_rate": 1.0 if pred == "yes" else 0.0}
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: (f"{d['question']}\nAnswer the question using "
                               "a single word or phrase."),
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 4, "temperature": 0.0},
        metric_names=("accuracy", "yes_rate"),
        synthetic_docs=lambda n: [{
            "question": f"Is there a square in region {i % 3} of the image?",
            "answer": "yes" if i % 2 == 0 else "no",
            "image": _synth_image(i),
        } for i in range(n)])


def make_vqa_consensus(name: str, dataset_path=None,
                       post_prompt=("\nAnswer the question using a single "
                                    "word or phrase.")) -> TaskConfig:
    """Consensus accuracy over 10 annotator answers (lmms-eval
    tasks/vqav2/utils.py + tasks/ok_vqa semantics via
    metrics.vqa_accuracy). ok_vqa adds the 'Unanswerable' hint to the
    prompt (ok_vqa_val2014_lite.yaml:25)."""
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: f"{d['question']}{post_prompt}",
        doc_to_visual=_visual,
        process_results=lambda d, r: {"vqa_accuracy": M.vqa_accuracy(
            r[0], d.get("answers", [d.get("answer", "")] * 10))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("vqa_accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"What color is object {i}?",
            "answers": (["red"] * 7 + ["blue"] * 3) if i % 2 == 0
            else ["blue"] * 10,
            "image": _synth_image(i),
        } for i in range(n)])


def make_mme(dataset_path=None) -> TaskConfig:
    """MME: yes/no probes scored acc + acc_plus (both questions of an image
    pair must be right for acc_plus — lmms-eval tasks/mme/utils.py). Doc
    schema: question/answer(Y|N)/question_id pairs share an image id."""
    def _res(d, r):
        pred = r[0].strip().lower().rstrip(".")
        pred = "yes" if pred.startswith("yes") else (
            "no" if pred.startswith("no") else pred)
        ok = 1.0 if pred == d["answer"].strip().lower() else 0.0
        # pair key must be NUMERIC: _gather_metrics allgathers a float array
        # under world_size > 1, so a string id would break multi-host MME
        import zlib
        pid = str(d.get("question_id", d.get("image_id", "")))
        return {"mme_acc": ok,
                "_pair_id": float(zlib.crc32(pid.encode())),
                "_ok": ok}
    return TaskConfig(
        name="mme",
        doc_to_text=lambda d: (f"{d['question']}\nAnswer the question using "
                               "a single word or phrase."),
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 4, "temperature": 0.0},
        metric_names=("mme_acc",),
        aggregate_extra=_mme_acc_plus,
        synthetic_docs=lambda n: [{
            "question": ("Is this a photo of a cat?" if i % 2 == 0 else
                         "Is this a photo of a dog?"),
            "answer": "Yes" if i % 4 < 2 else "No",
            "question_id": f"img_{i // 2}",
            "image": _synth_image(i // 2),
        } for i in range(n)])


def _mme_acc_plus(rows):
    """acc_plus: fraction of image pairs with BOTH probes correct."""
    pairs = {}
    for row in rows:
        pid = row.get("_pair_id", "")
        pairs.setdefault(pid, []).append(row.get("_ok", 0.0))
    both = [1.0 if all(v >= 1.0 for v in vs) else 0.0
            for vs in pairs.values()]
    return {"mme_acc_plus": sum(both) / max(len(both), 1)}



def _mmmu_visual(d):
    """MMMU stores up to 7 interleaved images as image_1..image_7
    (tasks/mmmu/utils.py:63-70); plain 'image' is the fallback."""
    imgs = [d[k] for k in (f"image_{i}" for i in range(1, 8))
            if d.get(k) is not None]
    return imgs or ([d["image"]] if d.get("image") is not None else [])


def _synth_mmmu_docs(n: int) -> List[Dict]:
    docs = []
    for i in range(n):
        if i % 2 == 0:
            docs.append({
                "id": f"validation_Art_{i}",
                "question": f"<image 1> Which option equals {i % 4}?",
                "question_type": "multiple-choice",
                "options": str([str(j) for j in range(4)]),
                "answer": chr(ord("A") + i % 4),
                "image_1": _synth_image(i)})
        else:
            docs.append({
                "id": f"validation_Math_{i}",
                "question": f"<image 1> What is {i} plus one?",
                "question_type": "open",
                "answer": str(i + 1),
                "image_1": _synth_image(i)})
    return docs


def make_mmmu(dataset_path=None) -> TaskConfig:
    """MMMU val (tasks/mmmu/mmmu_val.yaml + utils.py): question + lettered
    options + MC/open instruction; official parse/eval scoring rebuilt in
    task_utils/mmmu.py, per-subdomain accuracies as extra aggregates."""
    from msd_tpu_torch.harness.task_utils import mmmu as U
    return TaskConfig(
        name="mmmu_val",
        doc_to_text=U.construct_prompt,
        doc_to_visual=_mmmu_visual,
        process_results=U.process_results,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("mmmu_acc",),
        aggregate_extra=U.aggregate_subdomains,
        synthetic_docs=_synth_mmmu_docs)


def make_vizwiz(dataset_path=None) -> TaskConfig:
    """VizWiz-VQA val (tasks/vizwiz_vqa/utils.py:19-47): EvalAI-normalized
    leave-one-out VQAv2 accuracy over 10 annotator answers; the prompt
    allows 'Unanswerable' (_default_template_vqa_yaml post_prompt)."""
    return TaskConfig(
        name="vizwiz_vqa_val",
        doc_to_text=lambda d: (
            f"{d['question']}\nWhen the provided information is "
            "insufficient, respond with 'Unanswerable'.\nAnswer the "
            "question using a single word or phrase."),
        doc_to_visual=_visual,
        process_results=lambda d, r: {
            "exact_match": M.vqa_accuracy(
                r[0], d.get("answers", [d.get("answer", "")]))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 16, "temperature": 0.0},
        metric_names=("exact_match",),
        synthetic_docs=_synth_vqa_docs)


def _synth_caption_docs(n: int) -> List[Dict]:
    return [{
        "question_id": f"COCO_val2017_{i:012d}.jpg",
        "answer": [f"a photo of object {i}", f"an image of object {i}"],
        "image": _synth_image(i)} for i in range(n)]


def make_caption_task(name: str, dataset_path=None,
                      prompt=("Provide a one-sentence caption for the "
                              "provided image.")) -> TaskConfig:
    """Image captioning (tasks/coco_cap|textcaps|nocaps|flickr30k/utils.py):
    corpus BLEU-1..4 / ROUGE-L / CIDEr over all docs via aggregate_extra
    (the per-doc rows carry host-local pred/ref strings; see
    task_utils/captioning.py for the documented tokenizer/METEOR
    deviations). The reference ref-caption field differs per dataset —
    coco 'answer', textcaps 'caption_str' (textcaps/utils.py:34), nocaps
    'annotations_captions' (nocaps/utils.py:37), flickr30k 'caption'
    (flickr30k/utils.py:38) — all are checked."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    def _res(d, r):
        refs = (d.get("answer") or d.get("answers") or d.get("caption_str")
                or d.get("annotations_captions") or d.get("caption") or [])
        if isinstance(refs, str):
            refs = [refs]
        return {"_pred": r[0], "_refs": [str(a) for a in refs]}
    return TaskConfig(
        name=name,
        doc_to_text=lambda d: prompt,
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=C.caption_scores,
        synthetic_docs=_synth_caption_docs)


def make_hallusion_bench(dataset_path=None) -> TaskConfig:
    """HallusionBench yes/no probes with the reference's offline 'intern'
    scoring (hallusion_bench/evaluate_hb.py:91-117): aAcc per question,
    qAcc = min over the question group (category, subcategory, set_id,
    question_id), fAcc = min over the figure group (category, subcategory,
    set_id, figure_id). gt_answer is '1' (yes) / '0' (no); a prediction
    counts as yes iff it contains 'yes'. Group keys are crc32 floats so
    rows survive the numeric multi-host gather (same trick as MME)."""
    import zlib

    def _gkey(d, last):
        raw = "_".join([str(d.get("category", "")),
                        str(d.get("subcategory", "")),
                        str(d.get("set_id", "")), str(d.get(last, ""))])
        return float(zlib.crc32(raw.encode()))

    def _res(d, r):
        pred_yes = "yes" in r[0].lower()
        gt = str(d.get("gt_answer", d.get("answer", ""))).strip()
        gt_yes = gt == "1" or gt.lower().startswith("y")
        return {"aAcc": 1.0 if pred_yes == gt_yes else 0.0,
                "_qkey": _gkey(d, "question_id"),
                "_fkey": _gkey(d, "figure_id")}

    def _group_min(rows, key):
        groups: Dict[float, float] = {}
        for r in rows:
            k = r.get(key)
            if k is None:
                continue
            groups[k] = min(groups.get(k, 1.0), r["aAcc"])
        return sum(groups.values()) / max(1, len(groups))

    return TaskConfig(
        name="hallusion_bench",
        doc_to_text=lambda d: (
            "For the following question, provide a detailed explanation of "
            "your reasoning leading to the answer." + d["question"]),
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=("aAcc",),
        aggregate_extra=lambda rows: {
            "qAcc": _group_min(rows, "_qkey"),
            "fAcc": _group_min(rows, "_fkey")},
        synthetic_docs=lambda n: [{
            "question": f"Is shape {i % 3} present in the image?",
            "gt_answer": "1" if i % 2 == 0 else "0",
            "category": "VD", "subcategory": "illusion",
            "set_id": str(i // 4), "figure_id": str(i // 2),
            "question_id": str(i),
            "image": _synth_image(i)} for i in range(n)])


def make_videomme(dataset_path=None, max_frames: int = 8) -> TaskConfig:
    """Video-MME: multiple-choice over VIDEO input (tasks/videomme/
    utils.py:150-156 prompt format — option_prompt + lettered options +
    'The best answer is:'). doc_to_visual returns a [T, H, W, 3] frames
    array (or a video path from the dataset), which a video-capable
    adapter (qwen2_vl_msd) samples and runs through the temporal tower."""
    def _text(d):
        option_prompt = ("Select the best answer to the following "
                         "multiple-choice question based on the video. "
                         "Respond with only the letter (A, B, C, or D) of "
                         "the correct option.")
        opts = "\n".join(str(o) for o in d.get("options", []))
        return (f"{option_prompt}\n{d['question']}\n{opts}\n"
                "The best answer is:")

    def _vis(d):
        if "videoID" in d and d.get("video_root"):
            return [os.path.join(d["video_root"], d["videoID"] + ".mp4")]
        return [d["video"]]

    def _synth_video(i):
        rng = np.random.default_rng(i)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    return TaskConfig(
        name="videomme",
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=lambda d, r: {
            "accuracy": M.mc_accuracy(
                r[0], _mc_letter(d["answer"],
                                 len(d.get("options") or [])))},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "options": [f"{c}. option {j}" for j, c in enumerate("ABCD")],
            "answer": "ABCD"[i % 4],
            "video": _synth_video(i),
        } for i in range(n)])


def make_rec_task(name: str, dataset_path=None,
                  query_key: str = "answer") -> TaskConfig:
    """Referring-expression bbox grounding (REC): the model emits a
    normalized ``[x1, y1, x2, y2]`` box, scored IoU + ACC@{.1,.3,.5,.7,.9}
    + Center_ACC (tasks/refcoco/utils_rec.py:9-126,
    tasks/screenspot/utils_rec.py:6-126). Doc schema: ``bbox`` already
    normalized to x1y1x2y2 in [0, 1] (the reference's
    refcoco_bbox_rec_preprocess_dataset does the xywh->xyxy/normalize map
    at load time; a local dataset is expected pre-normalized), and the
    referring expression under ``query_key`` ('answer' for refcoco,
    'instruction' for screenspot)."""
    def _res(d, r):
        pred = M.parse_box(r[0])
        gt = [float(v) for v in d["bbox"]]
        iou = M.box_iou(gt, pred)
        out = {"IoU": iou, "Center_ACC": M.box_center_in(gt, pred)}
        for th in (0.1, 0.3, 0.5, 0.7, 0.9):
            out[f"ACC@{th}"] = float(iou >= th)
        return out

    return TaskConfig(
        name=name,
        doc_to_text=lambda d: (
            "Bounding box coordinates are specified in the format (top-left "
            "x, top-left y, bottom-right x, bottom-right y). All values are "
            "floating point numbers bounded between 0 and 1. Please provide "
            "the bounding box coordinate of the region this sentence "
            "describes: " + str(d[query_key])),
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("IoU", "ACC@0.1", "ACC@0.3", "ACC@0.5", "ACC@0.7",
                      "ACC@0.9", "Center_ACC"),
        synthetic_docs=lambda n: [{
            query_key: f"the object in cell {i % 4}",
            "bbox": [0.1 + 0.2 * (i % 4), 0.2, 0.2 + 0.2 * (i % 4), 0.5],
            "image": _synth_image(i),
        } for i in range(n)])


def make_mmvet(dataset_path=None) -> TaskConfig:
    """MM-Vet integrated-capability scoring. The reference grades with a
    GPT judge over an <AND>/<OR> ground-truth algebra
    (tasks/mmvet/utils.py:38-49 MM_VET_PROMPT); offline deterministic
    analog (same deviation class as the mathvista/mathverse rebuilds):
    score = mean over <AND> conjuncts of max over <OR> alternatives of
    normalized containment/numeric match — reproducing the judge's anchor
    cases (all conjuncts present = 1.0, one of two = 0.5, none = 0.0)."""
    def _part_hit(part: str, pred: str) -> float:
        alts = [a.strip() for a in part.split("<OR>")]
        pn = M.normalize_extract(pred)
        best = 0.0
        for alt in alts:
            an = M.normalize_extract(alt)
            if not an:
                continue
            if an in pn or M.relaxed_correctness(pred, alt):
                return 1.0
        return best

    def _res(d, r):
        gt = str(d.get("answer", ""))
        # judge-backed scoring when installed (mmvet/utils.py:74-108 row
        # format against MM_VET_PROMPT); offline algebra otherwise
        from msd_tpu_torch.harness.judge import mmvet_judge_score
        js = mmvet_judge_score(d.get("question", ""), gt, r[0])
        if js is not None:
            return {"gpt_eval_score": js}
        parts = [p.strip() for p in gt.split("<AND>") if p.strip()]
        score = (sum(_part_hit(p, r[0]) for p in parts) / len(parts)
                 if parts else 0.0)
        return {"gpt_eval_score": score}

    return TaskConfig(
        name="mmvet",
        doc_to_text=lambda d: d["question"],
        doc_to_visual=_visual,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 512, "temperature": 0.0},
        metric_names=("gpt_eval_score",),
        synthetic_docs=lambda n: [{
            "question": f"What are the two numbers shown? (doc {i})",
            "answer": f"{i} <AND> {i + 1}" if i % 2 == 0
            else f"{i} <OR> {i * 10}",
            "image": _synth_image(i),
        } for i in range(n)])


def make_video_mc_task(name: str, dataset_path=None) -> TaskConfig:
    """Video multiple-choice (egoschema / nextqa / perceptiontest /
    mvbench family): the option list and gold answer live under
    dataset-specific keys — ``option``+int answer (egoschema
    tasks/egoschema/utils.py:57-77), ``a0..a4``+int (nextqa
    tasks/nextqa/utils.py doc_to_text_mc), ``options``+letter, or
    ``candidates``+gold-string (mvbench tasks/mvbench/utils.py) — all
    normalized here to lettered options + a letter gold."""
    def _opts(d) -> List[str]:
        raw = (d.get("options") or d.get("option") or d.get("candidates")
               or [d[k] for k in ("a0", "a1", "a2", "a3", "a4")
                   if d.get(k) is not None])
        return [str(o) for o in raw]

    def _gold_letter(d, opts: List[str]) -> str:
        ans = d.get("answer", d.get("truth"))
        if isinstance(ans, (int, np.integer)):
            return "ABCDEFGH"[int(ans)]
        a = str(ans).strip()
        if a.isdigit():
            return "ABCDEFGH"[int(a)]
        if len(a) == 1 and a.upper() in "ABCDEFGH":
            return a.upper()
        # gold given as the full option string (mvbench): match it
        for j, o in enumerate(opts):
            if M.normalize_extract(o.split(". ", 1)[-1]) == \
                    M.normalize_extract(a):
                return "ABCDEFGH"[j]
        return "A"

    def _text(d):
        opts = _opts(d)
        lettered = [o if o[:2] in (f"{c}." for c in "ABCDEFGH")
                    else f"{'ABCDEFGH'[j]}. {o}"
                    for j, o in enumerate(opts)]
        return ("Select the best answer to the following multiple-choice "
                "question based on the video. Respond with only the letter "
                "of the correct option.\n"
                + d["question"] + "\n" + "\n".join(lettered)
                + "\nThe best answer is:")

    def _vis(d):
        if d.get("video_path"):
            return [d["video_path"]]
        return [d["video"]]

    def _synth_video(i):
        rng = np.random.default_rng(i)
        return rng.integers(0, 255, size=(6, 56, 56, 3), dtype=np.uint8)

    def _res(d, r):
        opts = _opts(d)
        return {"accuracy": M.mc_accuracy(r[0], _gold_letter(d, opts),
                                          max(1, len(opts)))}

    return TaskConfig(
        name=name,
        doc_to_text=_text,
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which option is number {i % 4}?",
            "option": [f"option {j}" for j in range(4)],
            "answer": i % 4,
            "video": _synth_video(i),
        } for i in range(n)])


def make_multidocvqa(dataset_path=None) -> TaskConfig:
    """MP-DocVQA (multidocvqa): ANLS + exact-accuracy over multi-page
    document images — doc_to_visual returns every non-null ``image_k``
    page, k = 1..20 (tasks/multidocvqa/utils.py:20-47); answers may be an
    ast-encoded list string like the HF dump."""
    def _answers(d) -> List[str]:
        ans = d.get("answers", d.get("answer", []))
        if isinstance(ans, str):
            try:
                import ast
                ans = ast.literal_eval(ans)
            except (ValueError, SyntaxError):
                ans = [ans]
        if not isinstance(ans, (list, tuple)):
            ans = [ans]
        return [str(a) for a in ans]

    def _vis(d):
        pages = [d[f"image_{i}"] for i in range(1, 21)
                 if d.get(f"image_{i}") is not None]
        return pages or ([d["image"]] if d.get("image") is not None else [])

    def _res(d, r):
        answers = _answers(d)
        norm = [a.strip().lower() for a in answers]
        return {"anls": M.anls(r[0], answers),
                "accuracy": float(str(r[0]).strip().lower() in norm)}

    return TaskConfig(
        name="multidocvqa_val",
        doc_to_text=lambda d: (f"{d['question']}\nAnswer the question "
                               "using a single word or phrase."),
        doc_to_visual=_vis,
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("anls", "accuracy"),
        synthetic_docs=lambda n: [{
            "question": f"What is the value on page 2 of doc {i}?",
            "answers": [str(i % 10)],
            "image_1": _synth_image(2 * i),
            "image_2": _synth_image(2 * i + 1),
        } for i in range(n)])


_GSM8K_NUM_RE = re.compile(r"-?[0-9][0-9,]*\.?[0-9]*")


def make_gsm8k(dataset_path=None) -> TaskConfig:
    """GSM8K text-only math word problems (tasks/gsm8k/gsm8k.yaml):
    'Question: {q}\\nAnswer:' prompt, gold after '#### ', scored with the
    yaml's flexible-extract filter (last number in the output, commas/$
    stripped). No visual — exercises the engine's text-only path."""
    def _gold(d) -> str:
        a = str(d.get("answer", ""))
        a = a.split("#### ")[-1].strip().rstrip(".")
        return a.replace(",", "").replace("$", "")

    def _res(d, r):
        nums = _GSM8K_NUM_RE.findall(str(r[0]).replace("$", ""))
        pred = nums[-1].replace(",", "").rstrip(".") if nums else ""
        gold = _gold(d)
        try:
            ok = float(pred) == float(gold)
        except ValueError:
            ok = pred == gold
        return {"exact_match": float(ok)}

    return TaskConfig(
        name="gsm8k",
        doc_to_text=lambda d: f"Question: {d['question']}\nAnswer:",
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0,
                    "until": ["Question:"]},
        metric_names=("exact_match",),
        synthetic_docs=lambda n: [{
            "question": f"Tom has {i} apples and buys {i} more. "
                        "How many apples does Tom have?",
            "answer": f"Tom has {i}+{i} apples. #### {2 * i}",
        } for i in range(n)])


def make_text_ppl_choice(name: str, dataset_path=None) -> TaskConfig:
    """Text-only likelihood-ranked multiple choice (arc/arc_easy.yaml,
    hellaswag/utils.py, mmlu/default): one loglikelihood request per
    choice continuation; reports acc (argmax logprob) and acc_norm
    (argmax logprob / choice character length — the lm-eval
    byte-normalized variant both yamls list). Doc schema: ``query`` (or
    'Question: {question}\\nAnswer:'), ``choices``, int ``gold``."""
    def _choices(d):
        return [str(c) for c in d["choices"]]

    def _query(d):
        return d.get("query") or f"Question: {d['question']}\nAnswer:"

    def _res(d, results):
        lps = np.array([lp for lp, _ in results], float)
        lens = np.array([max(1, len(c)) for c in _choices(d)], float)
        gold = int(d["gold"])
        return {"acc": float(int(np.argmax(lps)) == gold),
                "acc_norm": float(int(np.argmax(lps / lens)) == gold)}

    return TaskConfig(
        name=name,
        doc_to_text=_query,
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        output_type="loglikelihood",
        doc_to_choice=_choices,
        metric_names=("acc", "acc_norm"),
        synthetic_docs=lambda n: [{
            "query": f"Question: which option is number {i % 4}?\nAnswer:",
            "choices": [f" option {j}" for j in range(4)],
            "gold": i % 4,
        } for i in range(n)])


def register_builtin_tasks(dataset_root: Optional[str] = None) -> None:
    root = dataset_root or os.environ.get("MSD_TPU_DATASETS", "")

    def p(name):
        path = os.path.join(root, name) if root else None
        return path if path and os.path.exists(path) else None

    register_task("chartqa", make_chartqa(p("ChartQA")))
    register_task("textvqa", make_textvqa(p("TextVQA")))
    register_task("ai2d", make_mc_task("ai2d", p("AI2D")))
    register_task("iconqa", make_mc_task("iconqa", p("IconQA")))
    register_task("mathvista", make_mathvista(p("MathVista")))
    register_task("mathverse", make_mathverse(p("MathVerse")))
    # long-tail lmms-eval tasks the reference harness also exposes
    register_task("docvqa", make_anls_task("docvqa", p("DocVQA")))
    register_task("infovqa", make_anls_task("infovqa", p("InfoVQA")))
    register_task("gqa", make_textvqa(p("GQA")))
    register_task("pope", make_yesno_task("pope", p("POPE")))
    register_task("scienceqa_img", make_mc_task("scienceqa_img",
                                                p("ScienceQA")))
    register_task("mmbench_en", make_mc_task("mmbench_en", p("MMBench")))
    register_task("mmbench_cn", make_mc_task("mmbench_cn", p("MMBench-CN")))
    register_task("seedbench_2", make_mc_task("seedbench_2",
                                              p("SEED-Bench-2")))
    register_task("ocrbench", make_freeform_task("ocrbench", p("OCRBench")))
    register_task("ai2d_ppl", make_mc_ppl_task("ai2d_ppl", p("AI2D")))
    register_task("vqav2", make_vqa_consensus("vqav2", p("VQAv2")))
    register_task("ok_vqa", make_vqa_consensus(
        "ok_vqa", p("OK-VQA"),
        post_prompt=("\nWhen the provided information is insufficient, "
                     "respond with 'Unanswerable'.\nAnswer the question "
                     "using a single word or phrase.")))
    register_task("stvqa", make_anls_task("stvqa", p("ST-VQA")))
    register_task("mme", make_mme(p("MME")))
    register_task("hallusion_bench", make_hallusion_bench(
        p("HallusionBench")))
    register_task("videomme", make_videomme(p("Video-MME")))
    register_task("seedbench", make_mc_task("seedbench", p("SEED-Bench")))
    register_task("mmstar", make_mc_task("mmstar", p("MMStar")))
    register_task("realworldqa", make_mc_task("realworldqa",
                                              p("RealWorldQA")))
    register_task("mmmu_val", make_mmmu(p("MMMU")))
    register_task("vizwiz_vqa_val", make_vizwiz(p("VizWiz-VQA")))
    register_task("coco2017_cap_val",
                  make_caption_task("coco2017_cap_val",
                                    p("COCO-Caption2017")))
    register_task("textcaps_val", make_caption_task("textcaps_val",
                                                    p("TextCaps")))
    register_task("nocaps_val", make_caption_task("nocaps_val", p("NoCaps")))
    register_task("flickr30k_test", make_caption_task(
        "flickr30k_test", p("Flickr30k"),
        prompt=("Provide a one-sentence caption for the provided image. "
                "For the following question, provide a detailed explanation "
                "of your reasoning leading to the answer.")))
    # user YAML tasks (the lmms-eval tasks/*.yaml layer): every *.yaml under
    # $MSD_TPU_TASKS (or <dataset_root>/tasks) registers one task
    yaml_dir = os.environ.get("MSD_TPU_TASKS",
                              os.path.join(root, "tasks") if root else "")
    if yaml_dir and os.path.isdir(yaml_dir):
        from msd_tpu_torch.harness.yaml_task import register_yaml_dir
        register_yaml_dir(yaml_dir, dataset_root=root or None)
    register_task("refcoco_bbox_rec_val",
                  make_rec_task("refcoco_bbox_rec_val", p("RefCOCO")))
    register_task("refcoco+_bbox_rec_val",
                  make_rec_task("refcoco+_bbox_rec_val", p("RefCOCO+")))
    register_task("refcocog_bbox_rec_val",
                  make_rec_task("refcocog_bbox_rec_val", p("RefCOCOg")))
    register_task("screenspot_rec_test",
                  make_rec_task("screenspot_rec_test", p("ScreenSpot"),
                                query_key="instruction"))
    register_task("mmvet", make_mmvet(p("MM-Vet")))
    register_task("multidocvqa_val", make_multidocvqa(p("MP-DocVQA")))
    register_task("egoschema", make_video_mc_task("egoschema",
                                                  p("EgoSchema")))
    register_task("nextqa_mc_test", make_video_mc_task("nextqa_mc_test",
                                                       p("NExT-QA")))
    register_task("perceptiontest_val_mc", make_video_mc_task(
        "perceptiontest_val_mc", p("PerceptionTest")))
    register_task("mvbench", make_video_mc_task("mvbench", p("MVBench")))
    # round-3b extended tier (tasks_ext.py): mme_realworld, muirbench,
    # websrc, qbench, longvideobench, mlvu, mmlu, mmlu_pro, gpqa, synthdog,
    # vatex, detailcaps, naturalbench
    from msd_tpu_torch.harness.tasks_ext import register_ext_tasks
    register_ext_tasks(p)
    from msd_tpu_torch.harness.tasks_judge import register_judge_tasks
    register_judge_tasks(p)
    from msd_tpu_torch.harness.tasks_mmbench import register_mmbench_tasks
    register_mmbench_tasks(p)
    from msd_tpu_torch.harness.tasks_ext2 import register_ext2_tasks
    register_ext2_tasks(p)
    from msd_tpu_torch.harness.tasks_ext3 import register_ext3_tasks
    register_ext3_tasks(p)
    from msd_tpu_torch.harness.tasks_mmupd import register_mmupd_tasks
    register_mmupd_tasks(p)
    from msd_tpu_torch.harness.tasks_judge2 import register_judge2_tasks
    register_judge2_tasks(p)
    from msd_tpu_torch.harness.tasks_audio import register_audio_tasks
    register_audio_tasks(p)
    from msd_tpu_torch.harness.tasks_ext4 import register_ext4_tasks
    register_ext4_tasks(p)
    from msd_tpu_torch.harness.tasks_mmsearch import register_mmsearch_tasks
    register_mmsearch_tasks(p)
    register_task("gsm8k", make_gsm8k(p("GSM8K")))
    register_task("arc_easy", make_text_ppl_choice("arc_easy", p("ARC-Easy")))
    register_task("arc_challenge",
                  make_text_ppl_choice("arc_challenge", p("ARC-Challenge")))
    register_task("hellaswag", make_text_ppl_choice("hellaswag",
                                                    p("HellaSwag")))
    register_task("synthetic_vqa", make_chartqa(None))
