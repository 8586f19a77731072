"""IFEval instruction checkers + strict/loose evaluation.

Native rebuild of lmms_eval/tasks/ifeval/instructions.py (+ registry and
utils.py strict/loose protocol). Each checker reproduces the reference's
check_following semantics at the cited lines; ``check(instruction_id,
kwargs, response, prompt)`` is the registry entry point.

Documented deviations (PARITY.md): the reference detects language with
``langdetect`` and tokenizes words/sentences with nltk; here language
detection is a Unicode-script heuristic (exact for script-distinct
languages like zh/ja/ko/ru/ar/hi/th, permissive among Latin-script
languages) and word/sentence counts use regex tokenizers.

The port's own copy of the JAX package's ``harness/task_utils/ifeval.py``:
the same instruction checkers, character for character.
"""

from __future__ import annotations

import collections
import json
import re
from typing import Dict, List, Tuple

_LESS, _AT_LEAST = "less than", "at least"

_CONSTRAINED_OPTIONS = ("My answer is yes.", "My answer is no.",
                        "My answer is maybe.")

_SCRIPTS = {
    "zh": (0x4E00, 0x9FFF), "ja": (0x3040, 0x30FF), "ko": (0xAC00, 0xD7AF),
    "ru": (0x0400, 0x04FF), "ar": (0x0600, 0x06FF), "hi": (0x0900, 0x097F),
    "th": (0x0E00, 0x0E7F), "bn": (0x0980, 0x09FF), "te": (0x0C00, 0x0C7F),
    "ta": (0x0B80, 0x0BFF), "mr": (0x0900, 0x097F), "ur": (0x0600, 0x06FF),
    "fa": (0x0600, 0x06FF), "he": (0x0590, 0x05FF), "el": (0x0370, 0x03FF),
}


def _script_fraction(value: str, lo: int, hi: int) -> float:
    letters = [c for c in value if c.isalpha()]
    if not letters:
        return 0.0
    return sum(1 for c in letters if lo <= ord(c) <= hi) / len(letters)


def detect_language_matches(value: str, language: str) -> bool:
    """langdetect analog (instructions.py:159-175): exact for
    script-distinct languages, permissive among Latin-script ones."""
    language = str(language).lower()
    if language in _SCRIPTS:
        lo, hi = _SCRIPTS[language]
        return _script_fraction(value, lo, hi) >= 0.5
    # Latin-script target (en/fr/de/es/...): require a mostly-Latin text
    letters = [c for c in value if c.isalpha()]
    if not letters:
        return True
    latin = sum(1 for c in letters if ord(c) < 0x250) / len(letters)
    return latin >= 0.5


def count_words(value: str) -> int:
    """instructions_util.count_words (nltk RegexpTokenizer(r'\\w+'))."""
    return len(re.findall(r"\w+", value))


def count_sentences(value: str) -> int:
    """instructions_util.count_sentences analog: split on terminal
    punctuation runs followed by whitespace/end."""
    parts = re.split(r"[.!?]+(?:\s+|$)", value.strip())
    return len([p for p in parts if p.strip()])


# --- one function per reference checker ----------------------------------

def _keyword_existence(kw: Dict, v: str) -> bool:
    """instructions.py KeywordChecker (:~900): every keyword present
    case-insensitively (regex search, as the reference)."""
    for k in kw.get("keywords") or []:
        if not re.search(str(k), v, flags=re.IGNORECASE):
            return False
    return True


def _keyword_frequency(kw: Dict, v: str) -> bool:
    n = len(re.findall(str(kw.get("keyword", "")), v, flags=re.IGNORECASE))
    need = int(kw.get("frequency", 1))
    return n < need if kw.get("relation") == _LESS else n >= need


def _forbidden_words(kw: Dict, v: str) -> bool:
    for w in kw.get("forbidden_words") or []:
        if re.search(r"\b" + str(w) + r"\b", v, flags=re.IGNORECASE):
            return False
    return True


def _letter_frequency(kw: Dict, v: str) -> bool:
    cnt = collections.Counter(v.lower())[str(kw.get("letter", "")).lower()]
    need = int(kw.get("let_frequency", 1))
    return cnt < need if kw.get("let_relation") == _LESS else cnt >= need


def _response_language(kw: Dict, v: str) -> bool:
    return detect_language_matches(v, kw.get("language", "en"))


def _number_sentences(kw: Dict, v: str) -> bool:
    n = count_sentences(v)
    need = int(kw.get("num_sentences", 1))
    return n < need if kw.get("relation") == _LESS else n >= need


def _number_paragraphs(kw: Dict, v: str) -> bool:
    """ParagraphChecker (:563-573): split on ***; blank edge paragraphs
    are dropped, a blank middle paragraph fails."""
    paragraphs = re.split(r"\s?\*\*\*\s?", v)
    n = len(paragraphs)
    for i, p in enumerate(paragraphs):
        if not p.strip():
            if i in (0, len(paragraphs) - 1):
                n -= 1
            else:
                return False
    return n == int(kw.get("num_paragraphs", 1))


def _number_words(kw: Dict, v: str) -> bool:
    n = count_words(v)
    need = int(kw.get("num_words", 1))
    return n < need if kw.get("relation") == _LESS else n >= need


def _nth_paragraph_first_word(kw: Dict, v: str) -> bool:
    """ParagraphFirstWordCheck (:922-964)."""
    paragraphs = re.split(r"\n\n", v)
    n = len([p for p in paragraphs if p.strip()])
    nth = int(kw.get("nth_paragraph", 1))
    if nth > n or nth < 1:
        return False
    paragraph = paragraphs[nth - 1].strip()
    if not paragraph:
        return False
    word = paragraph.split()[0].strip().lstrip("'").lstrip('"')
    first = ""
    for ch in word:
        if ch in {".", ",", "?", "!", "'", '"'}:
            break
        first += ch.lower()
    return (n == int(kw.get("num_paragraphs", n))
            and first == str(kw.get("first_word", "")).lower())


def _number_placeholders(kw: Dict, v: str) -> bool:
    return len(re.findall(r"\[.*?\]", v)) >= int(
        kw.get("num_placeholders", 1))


def _postscript(kw: Dict, v: str) -> bool:
    """PostscriptChecker (:616-625)."""
    v = v.lower()
    marker = str(kw.get("postscript_marker", "P.S."))
    if marker == "P.P.S":
        pat = r"\s*p\.\s?p\.\s?s.*$"
    elif marker == "P.S.":
        pat = r"\s*p\.\s?s\..*$"
    else:
        pat = r"\s*" + re.escape(marker.lower()) + r".*$"
    return bool(re.findall(pat, v, flags=re.MULTILINE))


def _number_bullets(kw: Dict, v: str) -> bool:
    """BulletListChecker (:325-328): exact count of '*'/'-' lines."""
    b1 = re.findall(r"^\s*\*[^\*].*$", v, flags=re.MULTILINE)
    b2 = re.findall(r"^\s*-.*$", v, flags=re.MULTILINE)
    return len(b1) + len(b2) == int(kw.get("num_bullets", 1))


def _constrained_response(kw: Dict, v: str) -> bool:
    v = v.strip()
    return any(opt in v for opt in _CONSTRAINED_OPTIONS)


def _highlighted_sections(kw: Dict, v: str) -> bool:
    """HighlightSectionChecker (:448-459)."""
    n = 0
    for h in re.findall(r"\*[^\n\*]*\*", v):
        if h.strip("*").strip():
            n += 1
    for h in re.findall(r"\*\*[^\n\*]*\*\*", v):
        if h[2:-2].strip():
            n += 1
    return n >= int(kw.get("num_highlights", 1))


def _multiple_sections(kw: Dict, v: str) -> bool:
    """SectionChecker (:517-521)."""
    splitter = str(kw.get("section_spliter", "Section"))
    pat = r"\s?" + re.escape(splitter) + r"\s?\d+\s?"
    return len(re.split(pat, v)) - 1 >= int(kw.get("num_sections", 1))


def _json_format(kw: Dict, v: str) -> bool:
    s = v.strip()
    for pre in ("```json", "```Json", "```JSON", "```"):
        s = s.removeprefix(pre)
    s = s.removesuffix("```").strip()
    try:
        json.loads(s)
    except ValueError:
        return False
    return True


def _title(kw: Dict, v: str) -> bool:
    return any(t.lstrip("<").rstrip(">").strip()
               for t in re.findall(r"<<[^\n]+>>", v))


def _two_responses(kw: Dict, v: str) -> bool:
    """TwoResponsesChecker: exactly two distinct responses around ******."""
    parts = v.split("******")
    valid = []
    for i, p in enumerate(parts):
        if not p.strip():
            if i not in (0, len(parts) - 1):
                return False
        else:
            valid.append(p)
    return len(valid) == 2 and valid[0].strip() != valid[1].strip()


def _repeat_prompt(kw: Dict, v: str) -> bool:
    return v.strip().lower().startswith(
        str(kw.get("prompt_to_repeat", "")).strip().lower())


def _end_checker(kw: Dict, v: str) -> bool:
    return v.strip().strip('"').lower().endswith(
        str(kw.get("end_phrase", "")).strip().lower())


def _capital_word_frequency(kw: Dict, v: str) -> bool:
    n = len([w for w in re.findall(r"\w+(?:-\w+)*", v) if w.isupper()])
    need = int(kw.get("capital_frequency", 1))
    return n < need if kw.get("capital_relation") == _LESS else n >= need


def _english_capital(kw: Dict, v: str) -> bool:
    return v.isupper() and detect_language_matches(v, "en")


def _english_lowercase(kw: Dict, v: str) -> bool:
    return v.islower() and detect_language_matches(v, "en")


def _no_comma(kw: Dict, v: str) -> bool:
    return not re.search(r"\,", v)


def _quotation(kw: Dict, v: str) -> bool:
    v = v.strip()
    return len(v) > 1 and v[0] == '"' and v[-1] == '"'


CHECKERS = {
    "keywords:existence": _keyword_existence,
    "keywords:frequency": _keyword_frequency,
    "keywords:forbidden_words": _forbidden_words,
    "keywords:letter_frequency": _letter_frequency,
    "language:response_language": _response_language,
    "length_constraints:number_sentences": _number_sentences,
    "length_constraints:number_paragraphs": _number_paragraphs,
    "length_constraints:number_words": _number_words,
    "length_constraints:nth_paragraph_first_word":
        _nth_paragraph_first_word,
    "detectable_content:number_placeholders": _number_placeholders,
    "detectable_content:postscript": _postscript,
    "detectable_format:number_bullet_lists": _number_bullets,
    "detectable_format:constrained_response": _constrained_response,
    "detectable_format:number_highlighted_sections": _highlighted_sections,
    "detectable_format:multiple_sections": _multiple_sections,
    "detectable_format:json_format": _json_format,
    "detectable_format:title": _title,
    "combination:two_responses": _two_responses,
    "combination:repeat_prompt": _repeat_prompt,
    "startend:end_checker": _end_checker,
    "change_case:capital_word_frequency": _capital_word_frequency,
    "change_case:english_capital": _english_capital,
    "change_case:english_lowercase": _english_lowercase,
    "punctuation:no_comma": _no_comma,
    "startend:quotation": _quotation,
}


def check(instruction_id: str, kwargs: Dict, response: str,
          prompt: str = "") -> bool:
    """utils.py:25-55 strict check for one instruction. Unknown ids score
    False (never crash on a new dataset)."""
    fn = CHECKERS.get(instruction_id)
    if fn is None:
        return False
    kw = {k: v for k, v in (kwargs or {}).items() if v is not None}
    if instruction_id == "combination:repeat_prompt" and \
            not kw.get("prompt_to_repeat"):
        kw["prompt_to_repeat"] = prompt
    try:
        return bool(response.strip()) and bool(fn(kw, response))
    except Exception:
        return False


def loose_variants(response: str) -> List[str]:
    """utils.py:62-80: the 8 loose-eval response variants."""
    r = response.split("\n")
    rm_first = "\n".join(r[1:]).strip()
    rm_last = "\n".join(r[:-1]).strip()
    rm_both = "\n".join(r[1:-1]).strip()
    out = [response, response.replace("*", ""), rm_first, rm_last, rm_both,
           rm_first.replace("*", ""), rm_last.replace("*", ""),
           rm_both.replace("*", "")]
    return out


def evaluate(instruction_ids: List[str], kwargs_list: List[Dict],
             response: str, prompt: str = ""
             ) -> Tuple[List[bool], List[bool]]:
    """Returns (strict_follow_list, loose_follow_list)."""
    strict = [check(iid, kw, response, prompt)
              for iid, kw in zip(instruction_ids, kwargs_list)]
    variants = loose_variants(response)
    loose = [any(check(iid, kw, v, prompt) for v in variants if v.strip())
             for iid, kw in zip(instruction_ids, kwargs_list)]
    return strict, loose
