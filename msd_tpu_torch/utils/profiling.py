"""Timing and profiling utilities.

The port of the JAX package's ``utils/profiling.py`` (reference:
EAGLE/eagle/model/utils.py:50-61 Timer, cuda.synchronize-bracketed wall
clock). ``Timer`` and ``time_fn`` wait for the device of the tensors they
are given (``torch.cuda.synchronize`` on a CUDA device, nothing on the
CPU, where every op has finished when it returns); ``trace`` wraps
``torch.profiler`` and writes a Chrome trace; ``StepStats`` accumulates
per-request engine counters.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _sync(x) -> None:
    """Wait for the device of the first tensor in ``x`` (a tensor, or a
    list, tuple or dict holding tensors)."""
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            if isinstance(v, (torch.Tensor, list, tuple, dict)):
                _sync(v)
                return
        return
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class Timer:
    """``with Timer("step", sync_on=t) as tm: ...``; ``tm.elapsed`` in
    seconds, taken after the device of ``sync_on`` has finished."""

    def __init__(self, name: str = "", sync_on: Optional[object] = None,
                 log=None):
        self.name = name
        self.sync_on = sync_on
        self.log = log
        self.elapsed = 0.0

    def __enter__(self):
        if self.sync_on is not None:
            _sync(self.sync_on)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync_on is not None:
            _sync(self.sync_on)
        self.elapsed = time.perf_counter() - self.t0
        if self.log:
            self.log(f"[Timer] {self.name}: {self.elapsed*1e3:.2f} ms")
        return False


def time_fn(fn, *args, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of wall clock in seconds of ``fn(*args)``, each call waited
    for on the device of its result."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def trace(log_dir: str = "msd_torch_trace"):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    when a card is present); the Chrome trace goes to
    ``log_dir/trace.json``. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepStats:
    """Streaming accumulator for per-step engine metrics (temp_cache
    analog, utils.py:23-48: token counters + acceptance histogram)."""

    def __init__(self):
        self.in_tokens = 0
        self.out_tokens = 0
        self.accept_steps = 0
        self.accept_len_sum = 0
        self.alpha_hist: Dict[int, int] = {}

    def update(self, *, prompt_tokens: int, new_tokens: int, steps: int,
               acc_sum: int, hist=None):
        self.in_tokens += prompt_tokens
        self.out_tokens += new_tokens
        self.accept_steps += steps
        self.accept_len_sum += acc_sum
        if hist is not None:
            for i, c in enumerate(hist):
                self.alpha_hist[i] = self.alpha_hist.get(i, 0) + int(c)

    @property
    def avg_accept_len(self) -> float:
        return self.accept_len_sum / max(self.accept_steps, 1)

    def summary(self) -> Dict:
        return {"in_tokens": self.in_tokens, "out_tokens": self.out_tokens,
                "accept_steps": self.accept_steps,
                "avg_accept_len": self.avg_accept_len,
                "alpha_hist": dict(sorted(self.alpha_hist.items()))}
