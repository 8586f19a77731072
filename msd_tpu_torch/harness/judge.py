"""Pluggable judge for GPT-scored tasks.

The reference grades mathvista answer extraction, MM-Vet correctness, and
the LLaVA-Bench pairwise reviews with an OpenAI chat endpoint
(lmms_eval/tasks/mathvista/utils.py:23-39 + mathvista_evals.py:262-280,
mmvet/utils.py:20-51, llava-in-the-wild/utils.py:50-88). Offline — this
harness's default — those tasks fall back to deterministic rule analogs
(documented deviation, PARITY.md). When a local LLM endpoint is available,
install an EndpointJudge to restore judge-parity scoring:

    from msd_tpu_torch.harness.judge import set_judge
    set_judge("endpoint:http://localhost:8000/v1/chat/completions")

or from the CLI: ``python -m msd_tpu_torch.harness ... --judge
endpoint:URL``.

The endpoint may speak either the OpenAI chat-completions contract
(``{"messages": [...]}`` -> ``{"choices": [{"message": {"content": ...}}]}``)
or a plain ``{"prompt": ...}`` -> ``{"text": ...}`` one; responses are
parsed permissively. Judge failures (connection refused, timeout, garbage
output) return ``None`` and every scorer falls back to its offline rule —
an unreachable endpoint can never crash or stall an eval run beyond the
per-request timeout.

The port's own copy of the JAX package's ``harness/judge.py``: the same
client, prompts and parsing, byte for byte.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import Optional, Tuple

# -- reference judge prompts (behavioral constants required for parity) ----

# mmvet/utils.py:38-49 MM_VET_PROMPT (few-shot correctness rubric)
MM_VET_PROMPT = """Compare the ground truth and prediction from AI models, to give a correctness score for the prediction. <AND> in the ground truth means it is totally right only when all elements in the ground truth are present in the prediction, and <OR> means it is totally right when any one element in the ground truth is present in the prediction. The correctness score is 0.0 (totally wrong), 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, or 1.0 (totally right). Just complete the last space of the correctness score.
gpt_query_prompt | Ground truth | Prediction | Correctness
--- | --- | --- | ---
What is x in the equation? | -1 <AND> -5 | x = 3 | 0.0
What is x in the equation? | -1 <AND> -5 | x = -1 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -5 or 5 | 0.5
What is x in the equation? | -1 <AND> -5 | x = -1 or x = -5 | 1.0
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme talks about Iceland and Greenland. It's pointing out that despite their names, Iceland is not very icy and Greenland isn't very green. | 0.4
Can you explain this meme? | This meme is poking fun at the fact that the names of the countries Iceland and Greenland are misleading. Despite its name, Iceland is known for its beautiful green landscapes, while Greenland is mostly covered in ice and snow. The meme is saying that the person has trust issues because the names of these countries do not accurately represent their landscapes. | The meme is using humor to point out the misleading nature of Iceland's and Greenland's names. Iceland, despite its name, has lush green landscapes while Greenland is mostly covered in ice and snow. The text 'This is why I have trust issues' is a playful way to suggest that these contradictions can lead to distrust or confusion. The humor in this meme is derived from the unexpected contrast between the names of the countries and their actual physical characteristics. | 1.0
"""

# llava-in-the-wild/rule.json (conv/detail/complex share one pairwise
# rubric; the reference prepends it with the question + both answers)
LLAVA_BENCH_RULE_PROMPT = (
    "We would like to request your feedback on the performance of two AI "
    "assistants in response to the user question displayed above. The user "
    "asks the question on observing an image. For your reference, the "
    "visual content in the image is represented with a few sentences "
    "describing the image. \nPlease rate the helpfulness, relevance, "
    "accuracy, level of details of their responses. Each assistant "
    "receives an overall score on a scale of 1 to 10, where a higher score "
    "indicates better overall performance.\nPlease first output a single "
    "line containing only two values indicating the scores for Assistant 1 "
    "and 2, respectively. The two scores are separated by a space.\nIn the "
    "subsequent line, please provide a comprehensive explanation of your "
    "evaluation, avoiding any potential bias and ensuring that the order "
    "in which the responses were presented does not affect your judgment.")

# mathvista/mathvista_evals.py:108-146 DEMO_PROMPT, abbreviated to the
# instruction + two representative shots (the endpoint judge is a local
# model; the full 5-shot block is available in the reference for byte
# parity but the extraction contract is identical)
MATHVISTA_EXTRACT_PROMPT = """
Please read the following example. Then extract the answer from the model response and type it at the end of the prompt.

Hint: Please answer the question requiring an integer answer and provide the final value, e.g., 1, 2, 3, at the end.
Question: Which number is missing?

Model response: The number missing in the sequence is 14.

Extracted answer: 14

Hint: Please answer the question and provide the correct option letter, e.g., A, B, C, D, at the end.
Question: What fraction of the shape is blue?\nChoices:\n(A) 3/11\n(B) 8/11\n(C) 6/11\n(D) 3/5

Model response: The correct answer is (B) 8/11.

Extracted answer: B
"""


class EndpointJudge:
    """HTTP judge client (stdlib urllib; no extra dependency)."""

    def __init__(self, url: str, timeout: float = 60.0, retries: int = 2,
                 model: str = "local-judge"):
        self.url = url
        self.timeout = timeout
        self.retries = retries
        self.model = model

    def _post(self, payload: dict) -> Optional[dict]:
        data = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.url, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read().decode())
        except (urllib.error.URLError, TimeoutError, ValueError, OSError):
            return None

    def complete(self, prompt: str, max_tokens: int = 256,
                 temperature: float = 0.0,
                 system: Optional[str] = None) -> Optional[str]:
        """One judged completion, or None on any failure."""
        messages = ([{"role": "system", "content": system}]
                    if system else [])
        messages.append({"role": "user", "content": prompt})
        payload = {"model": self.model, "messages": messages,
                   "temperature": temperature, "max_tokens": max_tokens,
                   "prompt": prompt}  # plain-contract servers read this
        for _ in range(max(self.retries, 1)):
            j = self._post(payload)
            if j is None:
                continue
            # OpenAI chat / completions / plain contracts
            try:
                ch = j.get("choices")
                if ch:
                    msg = ch[0].get("message", {}).get("content")
                    txt = msg if msg is not None else ch[0].get("text")
                else:
                    txt = j.get("text", j.get("completion"))
                if isinstance(txt, str) and txt.strip():
                    return txt.strip()
            except (AttributeError, IndexError, TypeError):
                pass
        return None


_JUDGE = None


def set_judge(spec) -> None:
    """Install the global judge. ``spec``: None/''/'offline' clears it,
    'endpoint:URL' installs an EndpointJudge, or pass any object with a
    ``complete(prompt, ...) -> Optional[str]`` method."""
    global _JUDGE
    if spec is None or spec == "" or spec == "offline":
        _JUDGE = None
    elif isinstance(spec, str) and spec.startswith("endpoint:"):
        _JUDGE = EndpointJudge(spec[len("endpoint:"):])
    elif isinstance(spec, str):
        raise ValueError(f"unknown judge spec {spec!r}; use 'offline' or "
                         "'endpoint:URL'")
    else:
        _JUDGE = spec


def get_judge():
    return _JUDGE


# -- task-facing helpers (each returns None when no judge / judge failed) --

def mmvet_judge_score(question: str, gt: str, pred: str) -> Optional[float]:
    """mmvet/utils.py:74-108: append the sample row to MM_VET_PROMPT, read
    a correctness score in [0, 1] off the completion."""
    j = get_judge()
    if j is None:
        return None
    q = str(question).replace("\n", " ")
    row = (f"{q} | {str(gt).replace('<AND>', ' <AND> ')} | "
           f"{str(pred).strip()} |")
    out = j.complete(MM_VET_PROMPT + row, max_tokens=8)
    if out is None:
        return None
    m = re.search(r"([01](?:\.\d+)?)", out)
    if not m:
        return None
    v = float(m.group(1))
    return v if 0.0 <= v <= 1.0 else None


def llava_pairwise_scores(context: str, question: str, ans1: str,
                          ans2: str, role: str = "Assistant"
                          ) -> Optional[Tuple[float, float]]:
    """llava-in-the-wild/utils.py:117-137 content layout + :90-102
    parse_score: first line carries 'score1 score2'."""
    j = get_judge()
    if j is None:
        return None
    content = (f"[Context]\n{context}\n\n[Question]\n{question}\n\n"
               f"[{role} 1]\n{ans1}\n\n[End of {role} 1]\n\n"
               f"[{role} 2]\n{ans2}\n\n[End of {role} 2]\n\n"
               f"[System]\n{LLAVA_BENCH_RULE_PROMPT}\n\n")
    out = j.complete(content, max_tokens=1024, temperature=0.2,
                     system="You are a helpful and precise assistant for "
                            "checking the quality of the answer.")
    if out is None:
        return None
    sp = out.split("\n")[0].replace(",", " ").split()
    try:
        if len(sp) == 2:
            return float(sp[0]), float(sp[1])
    except ValueError:
        pass
    return None


_VIDEOQA_SYSTEM = (
    "You are an intelligent chatbot designed for evaluating the "
    "correctness of generative outputs for question-answer pairs. "
    "Your task is to compare the predicted answer with the correct answer "
    "and determine if they match meaningfully. Here's how you can "
    "accomplish the task:"
    "------"
    "##INSTRUCTIONS: "
    "- Focus on the meaningful match between the predicted answer and the "
    "correct answer.\n"
    "- Consider synonyms or paraphrases as valid matches.\n"
    "- Evaluate the correctness of the prediction compared to the answer.")


def videoqa_judge_score(question: str, answer: str, pred: str
                        ) -> Optional[Tuple[str, float]]:
    """The video-QA GPT rubric shared by activitynetqa and the
    videochatgpt family (activitynetqa/utils.py:93-131): the judge returns
    a python-dict string {'pred': 'yes'|'no', 'score': 0-5}."""
    j = get_judge()
    if j is None:
        return None
    user = (f"Please evaluate the following video-based question-answer "
            f"pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
            f"Predicted Answer: {pred}\n\n"
            "Provide your evaluation only as a yes/no and score where the "
            "score is an integer value between 0 and 5, with 5 indicating "
            "the highest meaningful match. Please generate the response in "
            "the form of a Python dictionary string with keys 'pred' and "
            "'score', where value of 'pred' is  a string of 'yes' or 'no' "
            "and value of 'score' is in INTEGER, not STRING."
            "DO NOT PROVIDE ANY OTHER OUTPUT TEXT OR EXPLANATION. Only "
            "provide the Python dictionary string. "
            "For example, your response should look like this: "
            "{'pred': 'yes', 'score': 4.8}.")
    out = j.complete(user, max_tokens=64, system=_VIDEOQA_SYSTEM)
    if out is None:
        return None
    m = re.search(r"['\"]pred['\"]\s*:\s*['\"](yes|no)['\"]", out, re.I)
    s = re.search(r"['\"]score['\"]\s*:\s*([0-9]+(?:\.[0-9]+)?)", out)
    if not (m and s):
        return None
    return m.group(1).lower(), float(s.group(1))


def mathvista_judge_extract(query: str, response: str) -> Optional[str]:
    """mathvista_evals.py:262-280 general extraction via the judge."""
    j = get_judge()
    if j is None:
        return None
    full = (MATHVISTA_EXTRACT_PROMPT.strip()
            + f"\n\n{query}\n\n{response}\n\nExtracted answer: ")
    out = j.complete(full, max_tokens=256)
    return out.strip() if out else None
