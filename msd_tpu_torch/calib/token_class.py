"""Token-category classification (content / func_punct / number).

The port's own copy of the JAX package's ``calib/token_class.py``.

The reference decodes every candidate token per step on the host
(cnets.py:448-505 categorize_token_simple — tokenizer.decode inside the hot
loop). Here the ENTIRE vocabulary is classified once at load into an int8
table, and the category lookup is a device gather.
"""

from __future__ import annotations

import re
import string

import numpy as np

CONTENT, FUNC_PUNCT, NUMBER = 0, 1, 2

FUNCTION_WORDS = {
    'the', 'a', 'an', 'and', 'or', 'but', 'in', 'on', 'at', 'to', 'for',
    'of', 'with', 'by', 'from', 'up', 'about', 'into', 'through', 'during',
    'before', 'after', 'above', 'below', 'between', 'among', 'under', 'over',
    'is', 'are', 'was', 'were', 'be', 'been', 'being', 'have', 'has', 'had',
    'do', 'does', 'did', 'will', 'would', 'could', 'should', 'may', 'might',
    'can', 'must', 'shall', 'ought', 'need', 'dare', 'used',
    'i', 'you', 'he', 'she', 'it', 'we', 'they', 'me', 'him', 'her', 'us',
    'them', 'my', 'your', 'his', 'its', 'our', 'their', 'mine', 'yours',
    'hers', 'ours', 'theirs',
    'this', 'that', 'these', 'those', 'here', 'there', 'where', 'when',
    'why', 'how', 'what', 'which', 'who', 'whom', 'whose', 'if', 'unless',
    'until', 'while', 'since', 'because', 'so', 'as', 'than', 'then', 'now',
    'just', 'only', 'also', 'even', 'still', 'yet', 'already', 'again',
    'once', 'twice', 'always', 'never', 'often', 'sometimes', 'usually',
    'rarely', 'hardly', 'almost', 'quite', 'very', 'too', 'much', 'many',
    'more', 'most', 'less', 'least', 'few', 'little', 'some', 'any',
    'all', 'both', 'each', 'every', 'either', 'neither', 'none', 'no', 'not',
}


def classify_text(token_text: str) -> int:
    """Mirror of categorize_token_simple (cnets.py:448-505)."""
    token_text = token_text.strip()
    if token_text.isdigit() or re.match(r'^\d+\.?\d*$', token_text):
        return NUMBER
    if (not token_text or token_text.isspace()
            or all(c in string.punctuation for c in token_text)
            or (token_text.startswith('<') and token_text.endswith('>'))):
        return FUNC_PUNCT
    if token_text.lower().strip(' ') in FUNCTION_WORDS:
        return FUNC_PUNCT
    return CONTENT


def classify_vocab(tokenizer, vocab_size: int) -> np.ndarray:
    """[vocab_size] int8 category table. One-time cost at model load."""
    table = np.zeros((vocab_size,), np.int8)
    for tid in range(vocab_size):
        try:
            text = tokenizer.decode([tid], skip_special_tokens=False)
            table[tid] = classify_text(text)
        except Exception:
            table[tid] = CONTENT
    return table


def synthetic_vocab_table(vocab_size: int, seed: int = 0) -> np.ndarray:
    """Deterministic pseudo-classification for tests/benchmarks (no tokenizer)."""
    rng = np.random.default_rng(seed)
    return rng.choice([CONTENT, FUNC_PUNCT, NUMBER], size=vocab_size,
                      p=[0.7, 0.2, 0.1]).astype(np.int8)
