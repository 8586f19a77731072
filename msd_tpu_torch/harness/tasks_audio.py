"""Audio task family: librispeech / common_voice_15 / people_speech /
tedlium / gigaspeech (ASR WER), vocalsound, muchomusic, clotho_aqa,
air_bench chat+foundation, alpaca_audio, wavcaps.

Reference: the lmms-eval audio dirs (librispeech/utils.py etc.). The MSD
reference has no audio-capable model — these tasks exist for harness
parity: prompts, metrics, and aggregation are reference-faithful, the raw
audio rides in ``doc["audio"]`` (a {"array", "sampling_rate"} dict, the HF
convention) for a future audio adapter, and ``doc_to_visual`` returns []
so today's image/video adapters can still smoke-run the pipeline on
synthetic docs (PARITY.md).

The port's own copy of the JAX package's ``harness/tasks_audio.py``:
the same tasks under the same names, docs, prompts and scoring.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List

import numpy as np

from msd_tpu_torch.harness.tasks import TaskConfig
from msd_tpu_torch.harness.registry import register_task

_PUNCS = "!,.?;:"


def _synth_audio(i: int) -> Dict:
    rng = np.random.default_rng(i + 97)
    return {"array": rng.normal(size=(800,)).astype(np.float32),
            "sampling_rate": 16000}


def asr_normalize(text: str, language: str = "en") -> List[str]:
    """librispeech/utils.py:54-63 remove_sp + the EvaluationTokenizer's
    lowercase/punctuation-removal defaults: strip <|...|> control tokens,
    collapse spaces, drop punctuation, lowercase; zh scores per
    character."""
    t = re.sub(r"<\|.*?\|>", " ", str(text))
    t = re.sub(r"\s+", " ", t)
    t = re.sub(f" ?([{_PUNCS}])", r"\1", t).strip()
    t = t.lower()
    for p in _PUNCS:
        t = t.replace(p, "")
    if language == "zh":
        return [c for c in re.sub(r"\s+", "", t)]
    return [w for w in t.split() if w]


def wer(pred: str, gt: str, language: str = "en") -> float:
    """Word error rate: word-level edit distance / reference length."""
    h, r = asr_normalize(pred, language), asr_normalize(gt, language)
    if not r:
        return 0.0 if not h else 1.0
    d = np.zeros((len(r) + 1, len(h) + 1), dtype=np.int32)
    d[:, 0] = np.arange(len(r) + 1)
    d[0, :] = np.arange(len(h) + 1)
    for i in range(1, len(r) + 1):
        for j in range(1, len(h) + 1):
            sub = d[i - 1, j - 1] + (r[i - 1] != h[j - 1])
            d[i, j] = min(sub, d[i - 1, j] + 1, d[i, j - 1] + 1)
    return float(d[len(r), len(h)]) / len(r)


def make_asr_task(name: str, language: str = "en",
                  dataset_path=None) -> TaskConfig:
    """ASR transcription scored by corpus WER (librispeech/utils.py:33-48;
    the same shape serves common_voice_15 / people_speech / tedlium /
    gigaspeech — their utils differ only in dataset plumbing)."""
    def _res(d, r):
        return {"wer": wer(str(r[0]) if r else "",
                           str(d.get("gt", d.get("sentence",
                                                 d.get("text", "")))),
                           language)}

    return TaskConfig(
        name=name,
        doc_to_text=lambda d: ("Please recognize the speech and only "
                               "output the recognized content:"),
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 256, "temperature": 0.0},
        metric_names=("wer",),
        synthetic_docs=lambda n: [{
            "gt": f"hello world number {i}", "source": "synth",
            "task": "asr", "audio": _synth_audio(i)} for i in range(n)])


_VOCAL_CLASSES = ("Laughter", "Sigh", "Cough", "Throat clearing",
                  "Sneeze", "Sniff")


def make_vocalsound(dataset_path=None) -> TaskConfig:
    """vocalsound/utils.py:36-90: class-containment answer extraction,
    overall accuracy + gender (spk_id[0]=='f') and age-group extras."""
    def _pred(resp: str):
        for c in ("Laughter", "Sigh", "Cough", "Throat", "Sneeze", "Sniff"):
            if c.lower() in resp.lower():
                return "Throat clearing" if c == "Throat" else c
        return ""

    def _res(d, r):
        ok = 1.0 if _pred(str(r[0]) if r else "") == d.get("answer") else 0.0
        return {"accuracy": ok, "_spk": str(d.get("spk_id", "m0")),
                "_age": str(d.get("age_group", "1"))}

    def _agg(rows):
        tot, cor = defaultdict(int), defaultdict(float)
        for row in rows:
            g = "female" if row["_spk"][:1] == "f" else "male"
            tot[g] += 1
            cor[g] += row["accuracy"]
            a = f"age{row['_age']}"
            tot[a] += 1
            cor[a] += row["accuracy"]
        return {k: round(cor[k] / tot[k], 5) for k in sorted(tot)}

    return TaskConfig(
        name="vocalsound_test",
        doc_to_text=lambda d: ("Classify the vocal sound. Choose one of: "
                               + ", ".join(_VOCAL_CLASSES) + "."),
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        aggregate_extra=_agg,
        synthetic_docs=lambda n: [{
            "answer": _VOCAL_CLASSES[i % 6],
            "spk_id": ("f" if i % 2 else "m") + str(i),
            "age_group": str(1 + i % 3),
            "audio": _synth_audio(i)} for i in range(n)])


def make_muchomusic(dataset_path=None) -> TaskConfig:
    """muchomusic/utils.py:22-60: lettered choices appended to the
    question; gold letter = answer[1] ('(A) ...'); first standalone
    letter in the response."""
    def _res(d, r):
        gold = str(d.get("answer", ""))
        gold = gold[1] if len(gold) > 1 and gold[0] == "(" else gold[:1]
        m = re.search(r"\b([A-D])\b", str(r[0]).strip().upper() if r
                      else "")
        return {"accuracy": 1.0 if m and m.group(1) == gold.upper()
                else 0.0}

    return TaskConfig(
        name="muchomusic",
        doc_to_text=lambda d: (str(d.get("question", ""))
                               + "\n" + str(d.get("choices", ""))),
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8, "temperature": 0.0},
        metric_names=("accuracy",),
        synthetic_docs=lambda n: [{
            "question": f"Which instrument plays in clip {i}?",
            "choices": "(A) piano (B) guitar (C) drums (D) violin",
            "answer": f"({'ABCD'[i % 4]}) x",
            "audio": _synth_audio(i)} for i in range(n)])


def make_clotho_aqa(dataset_path=None) -> TaskConfig:
    """clotho_aqa/utils.py:21-95: audio QA judged with the Score0-5
    alignment rubric; offline proxy 5 * tokenF1 (PARITY.md)."""
    from msd_tpu_torch.harness import judge as J
    from msd_tpu_torch.harness.tasks_judge import _token_f1

    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        score = None
        if j is not None:
            user = (f"Question: {d.get('question', '')}\n"
                    f"Reference answer: {gold}\nModel answer: {pred}\n"
                    "Rate the model's answer based on its alignment with "
                    "the reference answer, focusing on accuracy and "
                    "relevance to the reference provided. Score0: "
                    "completely misaligned. Score5: highly accurate and "
                    "matches the reference perfectly. Respond with "
                    "'Rating: (int)'.")
            out = j.complete(user, max_tokens=128)
            if out:
                m = re.search(r"Rating:\s*([0-5])", out)
                if m:
                    score = float(m.group(1))
        if score is None:
            score = 5.0 * _token_f1(pred, gold)
        return {"gpt_eval": score}

    return TaskConfig(
        name="clotho_aqa_test",
        doc_to_text=lambda d: str(d.get("question", "")),
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 32, "temperature": 0.0},
        metric_names=("gpt_eval",),
        synthetic_docs=lambda n: [{
            "question": f"what makes sound {i}?",
            "answer": f"a machine {i}", "audio": _synth_audio(i)}
            for i in range(n)])


def make_air_bench(kind: str = "foundation",
                   dataset_path=None) -> TaskConfig:
    """air_bench/utils.py: foundation = A-D multiple choice over
    choice_a..d; chat = pairwise 1-10 judge vs the gold answer run in
    BOTH assistant orders to cancel position bias (:128-140), offline
    10 * tokenF1 proxy."""
    from msd_tpu_torch.harness import judge as J
    from msd_tpu_torch.harness.tasks_judge import _token_f1

    def _text(d):
        q = str(d.get("question", ""))
        if kind == "foundation":
            letters = "abcd"
            opts = "\n".join(f"{c.upper()}. {d[f'choice_{c}']}"
                             for c in letters if d.get(f"choice_{c}"))
            return (f"{q}\n{opts}\nAnswer with the option's letter from "
                    "the given choices directly.")
        return q

    def _res_found(d, r):
        m = re.search(r"\b([A-D])\b", str(r[0]).strip().upper() if r
                      else "")
        gold = ""
        for i, c in enumerate("abcd"):
            if str(d.get(f"choice_{c}", "")) == str(d.get("answer_gt", "")):
                gold = "ABCD"[i]
        return {"accuracy": 1.0 if m and gold and m.group(1) == gold
                else 0.0}

    def _res_chat(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer_gt", ""))
        j = J.get_judge()
        score = None
        if j is not None:
            scores = []
            for a1, a2, pick in ((gold, pred, 1), (pred, gold, 0)):
                out = j.complete(
                    "You are a helpful and precise assistant for checking "
                    "the quality of the answer.\n"
                    f"[Detailed Audio Description]\n"
                    f"{d.get('meta_info', '')}\n[Question]\n"
                    f"{d.get('question', '')}\n[Assistant 1]\n{a1}\n"
                    f"[Assistant 2]\n{a2}\n[System]\nEach assistant "
                    "receives an overall score on a scale of 1 to 10. "
                    "Please output a single line containing only two "
                    "values indicating the scores for Assistant 1 and 2, "
                    "respectively.", max_tokens=64)
                if out:
                    sp = out.split("\n")[0].split()
                    if len(sp) >= 2:
                        try:
                            scores.append(float(sp[pick]))
                        except ValueError:
                            pass
            if scores:
                score = float(np.mean(scores))
        if score is None:
            score = 10.0 * _token_f1(pred, gold)
        return {"gpt_eval": score}

    synth = (lambda n: [dict(
        {"question": f"Which option is number {i % 4}?",
         "answer_gt": f"option {i % 4}", "audio": _synth_audio(i)},
        **{f"choice_{c}": f"option {j}"
           for j, c in enumerate("abcd")}) for i in range(n)]) \
        if kind == "foundation" else \
        (lambda n: [{"question": f"describe sound {i}",
                     "answer_gt": f"a low hum {i}",
                     "meta_info": "synthetic tone",
                     "audio": _synth_audio(i)} for i in range(n)])

    return TaskConfig(
        name=f"air_bench_{kind}",
        doc_to_text=_text,
        doc_to_visual=lambda d: [],
        process_results=_res_found if kind == "foundation" else _res_chat,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 8 if kind == "foundation" else 128,
                    "temperature": 0.0},
        metric_names=("accuracy",) if kind == "foundation"
        else ("gpt_eval",),
        synthetic_docs=synth)


def make_alpaca_audio(dataset_path=None) -> TaskConfig:
    """alpaca_audio/utils.py: instruction following over audio, judged
    against the gold answer (same 1-5 alignment family); offline
    5 * tokenF1."""
    from msd_tpu_torch.harness import judge as J
    from msd_tpu_torch.harness.tasks_judge import _token_f1

    def _res(d, r):
        pred = str(r[0]) if r else ""
        gold = str(d.get("answer", ""))
        j = J.get_judge()
        score = None
        if j is not None:
            out = j.complete(
                f"Question: {d.get('speech_instruction', '')}\n"
                f"Reference: {gold}\nModel: {pred}\n"
                "Rate alignment 0-5. Respond 'Rating: (int)'.",
                max_tokens=64)
            if out:
                m = re.search(r"Rating:\s*([0-5])", out)
                if m:
                    score = float(m.group(1))
        if score is None:
            score = 5.0 * _token_f1(pred, gold)
        return {"gpt_eval": score}

    return TaskConfig(
        name="alpaca_audio_test",
        doc_to_text=lambda d: "Listen and follow the spoken instruction.",
        doc_to_visual=lambda d: [],
        process_results=_res,
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 128, "temperature": 0.0},
        metric_names=("gpt_eval",),
        synthetic_docs=lambda n: [{
            "speech_instruction": f"say hello {i}",
            "answer": f"hello {i}", "audio": _synth_audio(i)}
            for i in range(n)])


def make_wavcaps(dataset_path=None) -> TaskConfig:
    """wavcaps audio captioning → the corpus caption metric family."""
    from msd_tpu_torch.harness.task_utils import captioning as C

    return TaskConfig(
        name="wavcaps_val",
        doc_to_text=lambda d: ("Provide a one-sentence caption for the "
                               "provided audio."),
        doc_to_visual=lambda d: [],
        process_results=lambda d, r: {
            "_pred": str(r[0]) if r else "",
            "_refs": [str(d.get("caption", d.get("answer", "")))]},
        dataset_path=dataset_path,
        gen_kwargs={"max_new_tokens": 64, "temperature": 0.0},
        metric_names=(),
        aggregate_extra=C.caption_scores,
        synthetic_docs=lambda n: [{
            "caption": f"a machine hums at pitch {i}",
            "audio": _synth_audio(i)} for i in range(n)])


def register_audio_tasks(p) -> None:
    register_task("librispeech_test_clean",
                  make_asr_task("librispeech_test_clean",
                                dataset_path=p("librispeech")))
    register_task("common_voice_15_en",
                  make_asr_task("common_voice_15_en",
                                dataset_path=p("common_voice_15")))
    register_task("people_speech_val",
                  make_asr_task("people_speech_val",
                                dataset_path=p("people_speech")))
    register_task("tedlium_dev_test",
                  make_asr_task("tedlium_dev_test",
                                dataset_path=p("tedlium")))
    register_task("gigaspeech_test",
                  make_asr_task("gigaspeech_test",
                                dataset_path=p("gigaspeech")))
    register_task("vocalsound_test", make_vocalsound(p("vocalsound")))
    register_task("muchomusic", make_muchomusic(p("muchomusic")))
    register_task("clotho_aqa_test", make_clotho_aqa(p("clotho_aqa")))
    register_task("air_bench_foundation",
                  make_air_bench("foundation", p("air_bench")))
    register_task("air_bench_chat", make_air_bench("chat", p("air_bench")))
    register_task("alpaca_audio_test", make_alpaca_audio(p("alpaca_audio")))
    register_task("wavcaps_val", make_wavcaps(p("wavcaps")))
