"""CUDA graphs of the engine's step programs: the port's counterpart of
``jax.jit`` over the JAX package's one-program ``lax.while_loop``s.

A step (``spec_engine.decode_step``, ``spec_engine.ar_step``) reads and
writes only a generator's static ``EngineState`` and the weights, issues no
host sync and uploads nothing, so it is captured once and replayed for
every later step of every request: one replay in place of the thousands of
kernel launches of an eager step. The host loop around it still reads
``done`` once per replay and, when sampling, writes the step's random
draws into the state before it (``spec_engine.draw``).

Graphs are cached the way ``jax.jit`` caches executables by their static
arguments: by the step function, the static configuration (the request's
token limit excepted: it rides in the state), the state it runs over (its
lane count and buffers: a generator holds a one-lane state for single
requests and one state per batch size, a continuous batcher one of its
slot count) and the address, shape and dtype of every weight tensor the
step reads, so a generator whose draft
or calibration tables are swapped captures a graph of its own for the new
tensors and never replays one that reads the old ones, while steps that
do not rerank keep their graphs when tables are installed. An entry keeps
its weight and state tensors alive, so their addresses cannot be reused
by other tensors while it is cached; ``StepGraphs.drop`` releases the
entries that hold given tensors (a generator's ``set_draft``, a batcher
that closes), after which the old tensors can be freed and their
addresses reused, since no cached graph reads them any more;
``StepGraphs.drop_all`` releases every entry when the states themselves
are reallocated (a generator adopting new engine budgets).

Each capture first warms the step up on the capture stream (first-use
uploads, the kernel build, cuBLAS workspaces), then captures it into one
memory pool that all of the generator's graphs share (they are replayed
one at a time, on one stream, and leave nothing alive in it), then puts
back the state the warm-up steps advanced. Nothing here catches an error:
a capture or replay that fails raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.ops.decode_attention import decode_attention

# eager steps on the capture stream before each capture
WARMUP_STEPS = 2


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def weights_key(params: Dict) -> tuple:
    """(address, shape, dtype) of every tensor in ``params``, those of
    tuples such as the calibration tables (``params["calib"]``) included."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for t in leaves(params))


class CapturedStep:
    """One captured step; calling it replays the graph."""

    def __init__(self, index: int, graph: torch.cuda.CUDAGraph, key: tuple,
                 weights: List[torch.Tensor], k1_calls: int,
                 buffers: List[torch.Tensor] = ()):
        self.index = index
        self.graph = graph
        self.key = key
        # the weights and the state buffers it reads, alive while cached
        self.weights = weights
        self.buffers = list(buffers)
        # decode-attention (K1) launches the graph holds
        self.k1_calls = k1_calls

    def __call__(self):
        self.graph.replay()
        decode_attention.launches += self.k1_calls


class StepGraphs:
    """The captured steps of one generator, over its one static state."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        # by capture index; None once dropped
        self.steps: List[Optional[CapturedStep]] = []
        self._cache: Dict[tuple, CapturedStep] = {}
        self.capture_seconds = 0.0

    def get(self, fn: Callable, st: SE.Statics, params: Dict,
            state: SE.EngineState) -> CapturedStep:
        """The captured ``fn(st, params, state)``, captured now if this
        step, configuration and set of weights have none yet. The step is
        keyed on, and captured over, the tensors of ``params`` it reads
        (``spec_engine.step_params``)."""
        params = SE.step_params(st, params)
        key = (fn, dataclasses.replace(st, max_new=0), weights_key(params),
               state.ids.data_ptr(), tuple(state.ids.shape))
        step = self._cache.get(key)
        if step is None:
            step = self._capture(fn, st, params, state, key)
            self._cache[key] = step
        return step

    def reads(self, index: int, params: Dict) -> bool:
        """Whether the graph of capture ``index`` is still cached and reads
        exactly the weight tensors of ``params`` that its step reads."""
        step = self.steps[index]
        return step is not None and \
            step.key[2] == weights_key(SE.step_params(step.key[1], params))

    def drop(self, ptrs: set) -> None:
        """Release every cached graph that reads a tensor whose address is
        in ``ptrs``, once the card has finished any replay of it."""
        stale = [key for key, step in self._cache.items()
                 if any(t.data_ptr() in ptrs
                        for t in step.weights + step.buffers)]
        if stale:
            torch.cuda.synchronize(self.device)
        for key in stale:
            self.steps[self._cache.pop(key).index] = None

    def drop_all(self) -> None:
        """Release every cached graph (the state they were captured over
        is being replaced), once the card has finished any replay."""
        if self._cache:
            torch.cuda.synchronize(self.device)
        for step in self._cache.values():
            self.steps[step.index] = None
        self._cache.clear()

    def _capture(self, fn, st, params, state, key) -> CapturedStep:
        t0 = time.perf_counter()
        buffers = SE.state_tensors(state)
        saved = [x.clone() for x in buffers]
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            for _ in range(WARMUP_STEPS):
                fn(st, params, state)
        current.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        k1_before = decode_attention.captured
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            fn(st, params, state)
        k1_calls = decode_attention.captured - k1_before
        for x, y in zip(buffers, saved):
            x.copy_(y)
        torch.cuda.synchronize(self.device)
        self.capture_seconds += time.perf_counter() - t0
        step = CapturedStep(len(self.steps), graph, key, leaves(params),
                            k1_calls, buffers)
        self.steps.append(step)
        return step
