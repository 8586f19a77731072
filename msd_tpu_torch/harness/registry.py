"""Model / task registries (mirror of lmms-eval api/registry.py:8-118).

The port's own copy of the JAX package's ``harness/registry.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, Type

MODEL_REGISTRY: Dict[str, Type] = {}
TASK_REGISTRY: Dict[str, "object"] = {}


def register_model(*names: str) -> Callable:
    def deco(cls):
        for n in names:
            MODEL_REGISTRY[n] = cls
        return cls
    return deco


def get_model(name: str):
    try:
        return MODEL_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model '{name}'; available: "
                       f"{sorted(MODEL_REGISTRY)}")


# Documented scoring deviations vs the reference pipelines (PARITY.md
# "Documented scoring deviations"), keyed by task-name prefix and stamped
# onto tasks at registration so every result dict carries its own
# comparability caveat (round-4 VERDICT weak #5). Tasks that set their own
# TaskConfig.scoring_deviation win over this table.
SCORING_DEVIATIONS: Dict[str, str] = {
    "muirbench": "lenient extract_letter instead of the reference's "
                 "MultiChoiceRegexFilter + exact match; verbose "
                 "predictions can score differently",
    "mmt": "lenient extract_letter instead of the reference's filter "
           "stage + exact match",
    "mathvista": "deterministic local answer extraction instead of the "
                 "reference's GPT extraction round",
    "mathverse": "deterministic local extraction + match instead of the "
                 "reference's GPT extract/score rounds",
    "mmvet": "offline <AND>/<OR> keyword scoring unless a judge endpoint "
             "is configured (reference uses GPT-4 grading)",
    "tempcompass_caption_matching": "unmatched outputs score 0 offline "
                                    "instead of the reference's ChatGPT "
                                    "fallback",
    "vitatecs": "offline rule scoring; unmatched outputs score 0 unless "
                "a judge endpoint is configured",
    "video_detail_description": "offline fallback scores 5*tokenF1 "
                                "unless a judge endpoint is configured",
    "mmupd": "abstention detected by none-option phrase patterns "
             "(mmupd_evals.py:160-258) rather than a GPT extraction round",
    "olympiadbench": "native sympy equivalence judger without the antlr "
                     "LaTeX parser; common competition forms rewritten "
                     "by rule",
    "youcook2": "BLEU/ROUGE-L/CIDEr only; METEOR/SPICE need external "
                "jars and are omitted",
    "temporalbench_short_caption": "SentenceTransformer cosine metric "
                                   "out of scope (GPU embedding model)",
    "mmsearch": "offline retriever over doc-carried website entries "
                "instead of a live search engine + Playwright",
    "vdc": "offline judge rubric / caption-metric fallback unless a "
           "judge endpoint is configured",
    "ifeval": "langdetect/nltk replaced by script heuristics "
              "(task_utils/ifeval.py:9-13)",
}


def register_task(name: str, task) -> None:
    if getattr(task, "scoring_deviation", None) is None:
        for prefix, note in SCORING_DEVIATIONS.items():
            if name == prefix or name.startswith(prefix + "_") or \
                    name.startswith(prefix):
                try:
                    task.scoring_deviation = note
                except Exception:
                    pass
                break
    TASK_REGISTRY[name] = task


def get_task(name: str):
    try:
        return TASK_REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown task '{name}'; available: "
                       f"{sorted(TASK_REGISTRY)}")
