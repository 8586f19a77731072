"""Response filters (lmms-eval api/filters + filters/extraction analogs).

A filter maps raw model responses to the string given to process_results.
The reference ships regex extraction and multiple-choice extraction
(lmms-eval/lmms_eval/filters/*, exercised by test_parse.py) applied via task
YAML; here tasks attach filter callables directly.

The port's own copy of the JAX package's ``harness/filters.py``.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence


def take_first(resps: List[str]) -> str:
    return resps[0] if resps else ""


class RegexFilter:
    """Extract the first regex group match; fallback string otherwise."""

    def __init__(self, pattern: str = r"#### (\-?[0-9\.\,]+)",
                 group_select: int = 0, fallback: str = "[invalid]"):
        self.regex = re.compile(pattern)
        self.group_select = group_select
        self.fallback = fallback

    def __call__(self, resp: str) -> str:
        matches = self.regex.findall(resp)
        if not matches:
            return self.fallback
        m = matches[self.group_select]
        if isinstance(m, tuple):
            m = next((x for x in m if x), self.fallback)
        return m.strip()


class MultiChoiceRegexFilter(RegexFilter):
    """Match a choice letter, tolerating '(A)', 'A.', 'A)' and falling back
    to matching the choice TEXT against the options list
    (filters/extraction.py MultiChoiceRegexFilter; test_parse.py:1-20)."""

    def __init__(self, pattern: str = r"\(?([A-H])\)?",
                 ignore_case: bool = True, fallback: str = "[invalid]"):
        super().__init__(pattern, 0, fallback)
        self.ignore_case = ignore_case

    def filter_with_choices(self, resp: str,
                            choices: Optional[Sequence[str]] = None) -> str:
        text = resp.strip()
        m = re.search(r"\(?\b([A-H])\b\)?", text)
        if m:
            return m.group(1)
        if choices:
            low = text.lower() if self.ignore_case else text
            for i, c in enumerate(choices):
                body = re.sub(r"^[A-H][\.\)]\s*", "", str(c))
                cc = body.lower() if self.ignore_case else body
                if cc and cc in low:
                    return chr(ord("A") + i)
        return self.fallback

    def __call__(self, resp: str) -> str:
        return self.filter_with_choices(resp)


class WhitespaceFilter:
    def __call__(self, resp: str) -> str:
        return resp.strip()


def chain(*filters: Callable[[str], str]) -> Callable[[str], str]:
    def run(resp: str) -> str:
        for f in filters:
            resp = f(resp)
        return resp
    return run
