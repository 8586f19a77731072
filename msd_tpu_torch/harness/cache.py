"""SQLite response cache — the CachingLMM analog
(lmms-eval/lmms_eval/api/model.py:151-218 with sqlitedict).

Wraps any adapter's generate_until: responses are keyed by a hash of the
request context + gen kwargs + a model tag, so repeated eval runs skip
generation entirely.

The port's own copy of the JAX package's ``harness/cache.py``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from typing import List, Optional


class ResponseCache:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.conn = sqlite3.connect(path)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS responses (key TEXT PRIMARY KEY, "
            "value TEXT)")
        self.conn.commit()

    def get(self, key: str) -> Optional[str]:
        row = self.conn.execute(
            "SELECT value FROM responses WHERE key = ?", (key,)).fetchone()
        return row[0] if row else None

    def put(self, key: str, value: str) -> None:
        self.conn.execute(
            "INSERT OR REPLACE INTO responses VALUES (?, ?)", (key, value))
        self.conn.commit()

    def close(self):
        self.conn.close()


def request_key(model_tag: str, context: str, gen_kwargs: dict,
                doc_id: int, task: str) -> str:
    payload = json.dumps([model_tag, context, sorted(gen_kwargs.items()),
                          doc_id, task], default=str)
    return hashlib.sha256(payload.encode()).hexdigest()


class CachingLM:
    """Adapter wrapper: caches generate_until (strings) and loglikelihood
    ((logprob, is_greedy) tuples); other request types delegate uncached.
    Tracks cache_hits/cache_misses for observability."""

    def __init__(self, lm, cache_path: str, model_tag: str = "model"):
        self.lm = lm
        self.cache = ResponseCache(cache_path)
        self.model_tag = model_tag
        self.cache_hits = 0
        self.cache_misses = 0

    def _run_cached(self, requests, run_fn, kind: str,
                    encode, decode) -> List:
        outputs: List = [None] * len(requests)
        misses = []
        for i, req in enumerate(requests):
            ctx, arg1 = req.arguments[0], req.arguments[1]
            if not isinstance(arg1, dict):  # loglikelihood: target str/fn
                arg1 = {"target": arg1 if isinstance(arg1, str) else "<fn>"}
            key = request_key(self.model_tag + ":" + kind, ctx, arg1,
                              req.doc_id, req.task_name)
            hit = self.cache.get(key)
            if hit is not None:
                outputs[i] = decode(hit)
                self.cache_hits += 1
            else:
                misses.append((i, key, req))
                self.cache_misses += 1
        if misses:
            fresh = run_fn([r for _, _, r in misses])
            for (i, key, _), resp in zip(misses, fresh):
                outputs[i] = resp
                self.cache.put(key, encode(resp))
        return outputs

    def generate_until(self, requests) -> List[str]:
        return self._run_cached(requests, self.lm.generate_until,
                                "gen", lambda s: s, lambda s: s)

    def loglikelihood(self, requests) -> List[tuple]:
        return self._run_cached(
            requests, self.lm.loglikelihood, "ll",
            lambda t: json.dumps(list(t)),
            lambda s: tuple(json.loads(s)))

    def __getattr__(self, name):
        return getattr(self.lm, name)
