"""Continuous (in-flight) batching for the MSD engine.

The port of the JAX package's ``serve/continuous.py``. A fixed number of
slots are the lanes of one batched ``EngineState`` that the scheduler holds
for its lifetime (``spec_engine``'s batched lanes, the counterpart of the
JAX scheduler's stacked state pytree):

- ONE step for every segment: ``spec_engine.decode_until`` over all slots
  with a per-slot ``stop_at`` bound. Each step reads the weights once for
  every live slot, whatever their number; a slot that reached its bound,
  finished or holds no request is masked and left unchanged, as
  ``jax.vmap`` masks a finished lane of its ``while_loop``. On the card the
  step is one CUDA graph captured for (configuration, slot count) at the
  first segment and replayed for every later one.
- Slot join = the single-request prefill (``spec_engine.prefill``, or
  ``qwen_prefill`` with the request's ``img_grid`` on an inline engine:
  the same code as ``generate``) written straight into the slot's lane: the
  lane is a view of the batched buffers, so nothing is copied in. A
  request joins a RUNNING batch at the next segment boundary without
  stopping anyone else.
- Slot retire = host bookkeeping only; the lane is masked by
  ``stop_at = 0`` until a new request lands in it.

Scheduling is cooperative and host-driven: the owner calls ``step()`` in a
loop; each call admits queued requests into free slots, runs ONE segment,
streams newly committed tokens to per-request callbacks and returns the
requests that finished. Sampling parameters are pinned per scheduler (the
slots share one step configuration); mixed image/text prompts and
per-request ``max_new`` and seeds share the batch. A sampled slot draws
from its own generator, reseeded with the request's seed at admission, so
it reproduces a lone ``generate(..., seed=req.seed)``.

Tensor parallelism: with a generator over sharded trees every rank of
the mesh runs its own scheduler over the same submissions in the same
order. Admission and retirement read only what the ranks hold alike (the
queue, the prompts' lengths and the committed ids and counters, which the
collectives make equal), so every rank admits, steps and retires in
lockstep and calls the same collectives.

Token identity: a slot's output is what a lone ``generate()`` /
``generate_stream()`` call gives for that request wherever the batched
products round each row as the one-lane products do (bitwise on the CPU,
tests/test_torch_serve.py); on the card bf16 GEMMs over another row count
may round otherwise (ROADMAP section 3).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.generator import _host, _trim
from msd_tpu_torch.ops.sampling import SamplingParams


@dataclasses.dataclass
class Request:
    """One generation request tracked by the scheduler."""

    ids: np.ndarray                      # prompt token ids (unpadded)
    img_feats: Optional[torch.Tensor] = None
    img_grid: Optional[tuple] = None     # inline (Qwen) engines only
    max_new: int = 256
    seed: int = 0
    # called with each np.int32 array of newly committed tokens (streaming)
    on_tokens: Optional[Callable[[np.ndarray], None]] = None
    # filled in by the scheduler when the request finishes
    tokens: Optional[np.ndarray] = None
    accept_steps: int = 0
    accept_len_sum: int = 0
    segments: int = 0                    # segment steps this request spanned
    error: Optional[str] = None          # admission failure (solo; the batch
    #                                      and other requests are unaffected)

    @property
    def avg_accept_len(self) -> float:
        return self.accept_len_sum / max(self.accept_steps, 1)


@dataclasses.dataclass
class _Active:
    req: Request
    e0: int            # first new-token row in the expanded ids buffer
    emitted: int = 0   # tokens already surfaced to the callback
    new_tokens: int = 0


class ContinuousScheduler:
    """Fixed-slot continuous batcher over one MSDGenerator.

    n_slots bounds concurrency and device memory: each slot owns a full
    target + draft KV allocation (671 MB of target KV at LLaVA-1.5-7B width
    and the smoke's 1280-row cache in bf16), so pick n_slots from the memory
    left after the weights. segment is the token interval between
    scheduling decisions: smaller = lower join and stream latency, larger =
    fewer host round trips. ``close()`` releases the slots' graphs.
    """

    def __init__(self, gen, n_slots: int = 4, segment: int = 16,
                 sp: Optional[SamplingParams] = None,
                 use_calibration: bool = False):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        if use_calibration and "calib" not in gen.params:
            raise ValueError("set_calibrator() before use_calibration=True")
        self.gen = gen
        self.n_slots = n_slots
        self.segment = int(segment)
        self.sp = sp if sp is not None else gen.sp
        self.st = gen._statics(gen.eng.max_new_tokens, self.sp,
                               use_calibration, lanes=n_slots)
        self.queue: "deque[Request]" = deque()
        self.slots: List[Optional[_Active]] = [None] * n_slots
        self.state = gen.alloc_lanes(n_slots)
        self.rngs = [torch.Generator(device=gen.device)
                     for _ in range(n_slots)]
        self.steps = 0                   # segment steps executed
        self.joined = 0                  # requests admitted into slots

    # -- public API -----------------------------------------------------
    def submit(self, req: Request) -> None:
        req.max_new = min(int(req.max_new), self.st.max_new)
        self.queue.append(req)

    @property
    def busy(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def active(self) -> int:
        return sum(s is not None for s in self.slots)

    def step(self) -> List[Request]:
        """Admit, run one segment, harvest. Returns finished requests
        (including ones that failed admission, with .error set — a bad
        request must not take down the other slots)."""
        failed = self._admit()
        if self.active == 0:
            return failed
        stop = [0 if a is None else min(a.new_tokens + self.segment,
                                        a.req.max_new)
                for a in self.slots]
        gen, s = self.gen, self.state
        SE.decode_until(self.st, gen.params, s, stop,
                        gen.step_fn(SE.decode_step, self.st, s), self.rngs)
        self.steps += 1
        # one host copy of the lanes' ids and one of their counters
        ids = _host(s.ids)
        cur, done, new, steps, acc = _host(torch.stack([
            s.cur_len, s.done.to(torch.int32), s.new_tokens, s.steps,
            s.acc_sum]))
        finished: List[Request] = []
        for i, a in enumerate(self.slots):
            if a is None:
                continue
            r = a.req
            r.segments += 1
            out = _trim(ids[i, a.e0:cur[i] + 1], gen.eos_id, r.max_new)
            if len(out) > a.emitted:
                if r.on_tokens is not None:
                    r.on_tokens(out[a.emitted:])
                a.emitted = len(out)
            a.new_tokens = int(new[i])
            if done[i] or a.emitted >= r.max_new:
                r.tokens = out
                r.accept_steps = int(steps[i])
                r.accept_len_sum = int(acc[i])
                finished.append(r)
                self.slots[i] = None     # lane masked by stop_at=0
        return failed + finished

    def run_all(self) -> List[Request]:
        """Drive step() until drained (convenience for tests/offline use)."""
        done: List[Request] = []
        while self.busy:
            done.extend(self.step())
        return done

    def close(self) -> None:
        """Release the graphs captured over this scheduler's state, so its
        buffers can be freed (a later scheduler captures its own)."""
        if self.gen.graphs is not None:
            self.gen.graphs.drop({t.data_ptr()
                                  for t in SE.state_tensors(self.state)})

    # -- internals ------------------------------------------------------
    def _prefill(self, req: Request, i: int) -> int:
        """The single-request prefill, into slot i's lane. Returns e0."""
        gen = self.gen
        ids, padded, img_pos = gen._prompt(req.ids)
        gen._prefill(self.st, SE.lane(self.state, i), ids, padded, img_pos,
                     req.img_feats, req.img_grid,
                     self.rngs[i].manual_seed(req.seed))
        return gen._e0(ids, req.img_feats)

    def _admit(self) -> List[Request]:
        failed: List[Request] = []
        for i in range(self.n_slots):
            while self.queue and self.slots[i] is None:
                req = self.queue.popleft()
                try:
                    e0 = self._prefill(req, i)
                except Exception as e:   # bad request (e.g. prompt too long)
                    req.error = f"{type(e).__name__}: {e}"
                    failed.append(req)
                    continue
                self.slots[i] = _Active(req=req, e0=e0)
                self.joined += 1
        return failed
