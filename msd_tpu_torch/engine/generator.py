"""Host-side wrapper around the engine: prompt bucketing, result extraction
and per-request stats.

The port of the part of the JAX package's ``engine/generator.py`` that the
benchmark drives: ``generate`` (greedy medusa MSD), ``naive_generate``
(the AR baseline, optionally from the MSD prefill) and ``first_token``, for
expand-mode prompts with at most one image. ``prefill`` and ``decode``
ranges mark each request's two phases for ``torch.profiler``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from msd_tpu_torch.configs import (DraftConfig, EngineConfig,
                                   IMAGE_TOKEN_INDEX, LlamaConfig)
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.graphs import StepGraphs
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.sampling import SamplingParams


@dataclass
class GenResult:
    tokens: np.ndarray          # generated ids (prompt excluded, EOS trimmed)
    accept_steps: int = 0
    accept_len_sum: int = 0     # sum of tokens-per-step over verify steps
    alpha_hist: Optional[np.ndarray] = None
    graph: Optional[int] = None  # capture index of the graph replayed

    @property
    def avg_accept_len(self) -> float:
        return self.accept_len_sum / max(self.accept_steps, 1)


class MSDGenerator:
    """Speculative + AR generation over one model bundle on one device.

    The generator owns the engine's static buffers (one ``EngineState`` of
    the engine's capacity, reused by every request) and, on a CUDA device
    with ``cuda_graphs=True``, the CUDA graphs of the verify step and the
    AR token, captured at first use and replayed for every later request
    (``engine/graphs.py``). A capture or replay that fails raises; nothing
    falls back to eager. ``cuda_graphs=False`` runs the same in-place steps
    eagerly on the card; tensors on the CPU always run eagerly.
    """

    def __init__(self, target_params: Dict, draft_params: Dict,
                 tcfg: LlamaConfig, dcfg: DraftConfig,
                 eng: EngineConfig = EngineConfig(), *, n_img: int = 0,
                 eos_id: int = 2, sp: SamplingParams = SamplingParams(),
                 device="cuda", cuda_graphs: bool = True):
        self.tcfg, self.dcfg, self.eng = tcfg, dcfg, eng
        self.n_img, self.eos_id, self.sp = n_img, eos_id, sp
        self.device = torch.device(device)
        max_pos = eng.max_seq_len + eng.tree.num_nodes + 64
        cos_t, sin_t = L.make_rope(tcfg, max_pos, self.device)
        self.params = {"target": target_params, "draft": draft_params,
                       "cos_t": cos_t, "sin_t": sin_t}
        self.state = SE.alloc_state(self._statics(0),
                                    target_params["embed_tokens"].dtype,
                                    self.device)
        self.graphs = StepGraphs(self.device) \
            if cuda_graphs and self.device.type == "cuda" else None

    def _statics(self, max_new: int) -> SE.Statics:
        return SE.Statics(tcfg=self.tcfg, dcfg=self.dcfg, tree=self.eng.tree,
                          eng=self.eng, sp=self.sp, n_img=self.n_img,
                          eos_id=self.eos_id, max_new=max_new)

    def _step(self, fn, st: SE.Statics):
        """The graph replaying ``fn`` over the static state (captured now if
        this step, configuration and weights have none yet), or None for
        the eager step."""
        if self.graphs is None:
            return None
        return self.graphs.get(fn, st, self.params, self.state)

    def _pad(self, ids: np.ndarray) -> np.ndarray:
        """Pad to the next multiple of prompt_pad_multiple (128-token
        buckets by default); refuse prompts the engine budget cannot
        hold."""
        m = self.eng.prompt_pad_multiple
        p = ((len(ids) + m - 1) // m) * m
        n_exp = len(ids) + max(self.n_img - 1, 0)
        limit = self.eng.max_seq_len - self.eng.tree.num_nodes \
            - self.eng.tree.max_path_len - 2
        if n_exp >= limit:
            raise ValueError(
                f"prompt too long: {n_exp} expanded tokens, engine budget "
                f"allows < {limit} (max_seq_len={self.eng.max_seq_len}, "
                f"tree={self.eng.tree.num_nodes} nodes)")
        out = np.zeros((p,), np.int32)
        out[:len(ids)] = ids
        return out

    def _img_pos(self, ids: np.ndarray) -> int:
        pos = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
        return int(pos[0]) if len(pos) else len(ids)

    def _prompt(self, ids):
        ids = np.asarray(ids, np.int32)
        padded = torch.from_numpy(self._pad(ids)).to(self.device)
        return ids, padded, self._img_pos(ids)

    def _e0(self, ids: np.ndarray, img_feats) -> int:
        return len(ids) + (max(self.n_img - 1, 0)
                           if img_feats is not None else 0)

    def _tokens(self, e0: int, max_new: int) -> np.ndarray:
        cur = int(self.state.cur_len)
        return _trim(_host(self.state.ids[e0:cur + 1]), self.eos_id, max_new)

    def first_token(self, ids, img_feats: Optional[torch.Tensor] = None,
                    max_new_tokens: Optional[int] = None) -> int:
        """First new token from the target-only AR prefill."""
        ids, padded, img_pos = self._prompt(ids)
        st = self._statics(max_new_tokens or self.eng.max_new_tokens)
        SE.ar_prefill(st, self.params, self.state, padded, len(ids),
                      img_feats, img_pos)
        return int(self.state.bonus)

    def generate(self, ids, img_feats: Optional[torch.Tensor] = None,
                 max_new_tokens: Optional[int] = None,
                 first_token: Optional[int] = None) -> GenResult:
        """Greedy speculative (MSD) generation; lossless wrt the target.

        first_token: pin the first new token (see first_token())."""
        ids, padded, img_pos = self._prompt(ids)
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new)
        with record_function("prefill"):
            SE.prefill(st, self.params, self.state, padded, len(ids),
                       img_feats, img_pos, first_token)
        step = self._step(SE.decode_step, st)
        with record_function("decode"):
            SE.decode(st, self.params, self.state, step)
        s = self.state
        return GenResult(
            tokens=self._tokens(self._e0(ids, img_feats), max_new),
            accept_steps=int(s.steps), accept_len_sum=int(s.acc_sum),
            alpha_hist=_host(s.alpha_hist),
            graph=None if step is None else step.index)

    def naive_generate(self, ids, img_feats: Optional[torch.Tensor] = None,
                       max_new_tokens: Optional[int] = None,
                       share_prefill: bool = False) -> GenResult:
        """Plain greedy AR baseline over the same weights and KV layout.

        share_prefill: start from the MSD ``prefill`` (target and draft),
        so the AR loop decodes over exactly the KV cache and first token
        every MSD run starts from; otherwise a target-only prefill."""
        ids, padded, img_pos = self._prompt(ids)
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new)
        prefill = SE.prefill if share_prefill else SE.ar_prefill
        with record_function("prefill"):
            prefill(st, self.params, self.state, padded, len(ids), img_feats,
                    img_pos)
        step = self._step(SE.ar_step, st)
        with record_function("decode"):
            SE.ar_decode(st, self.params, self.state, step)
        return GenResult(tokens=self._tokens(self._e0(ids, img_feats),
                                             max_new),
                         graph=None if step is None else step.index)


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy that owns its memory (a CPU tensor's ``numpy()`` would
    alias the static buffer, which the next request overwrites)."""
    return x.cpu().numpy().copy()


def _trim(out: np.ndarray, eos_id: int, max_new: int) -> np.ndarray:
    eos = np.nonzero(out == eos_id)[0]
    if len(eos):
        out = out[:eos[0]]
    return out[:max_new]
