"""Host-side wrapper around the engine: prompt bucketing, result extraction
and per-request stats.

The port of the part of the JAX package's ``engine/generator.py`` that the
benchmark drives: ``generate`` (MSD in every drafting mode, greedy or
sampled, with the calibrated rerank after ``set_calibrator``, the
collection of its features and of the trajectory's hidden states for
distillation), ``naive_generate`` (the AR baseline, optionally from the
MSD prefill), ``first_token``, ``set_draft`` and ``autotune_tree``, for
expand-mode prompts with at most one image. ``prefill``
and ``decode`` ranges mark each request's two phases for
``torch.profiler``. Sampling draws from one ``torch.Generator`` on the
generator's device, seeded per request from ``seed``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from msd_tpu_torch.configs import (DraftConfig, EngineConfig,
                                   IMAGE_TOKEN_INDEX, LlamaConfig)
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.graphs import StepGraphs, leaves
from msd_tpu_torch.calib.device import CalibTables
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.sampling import SamplingParams


@dataclass
class GenResult:
    tokens: np.ndarray          # generated ids (prompt excluded, EOS trimmed)
    accept_steps: int = 0
    accept_len_sum: int = 0     # sum of tokens-per-step over verify steps
    alpha_hist: Optional[np.ndarray] = None
    graph: Optional[int] = None  # capture index of the graph replayed
    # per-node features when collecting: {field: [steps, N]} (see
    # spec_engine.CALIB_FIELDS)
    calib_data: Optional[Dict[str, np.ndarray]] = None
    # with collect_hiddens: the target hidden of every committed position
    # [cur_len, H] (float32, the engine's dtype cast exactly) and the
    # expanded ids [cur_len]
    traj_hidden: Optional[np.ndarray] = None
    exp_ids: Optional[np.ndarray] = None

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
                 attn_feature_mode: str = "reference", device="cuda",
                 cuda_graphs: bool = True):
        self.tcfg, self.dcfg = tcfg, dcfg
        self.n_img, self.eos_id, self.sp = n_img, eos_id, sp
        self.attn_feature_mode = attn_feature_mode
        self.device = torch.device(device)
        self.rng = torch.Generator(device=self.device)
        self.params = {"target": target_params, "draft": draft_params}
        self.graphs = StepGraphs(self.device) \
            if cuda_graphs and self.device.type == "cuda" else None
        self.state = None
        self.eng = eng

    @property
    def eng(self) -> EngineConfig:
        return self._eng

    @eng.setter
    def eng(self, eng: EngineConfig) -> None:
        """Adopt engine budgets (e.g. a tree an autotuner picked): the
        static state and the rope tables are sized by them, so both are
        allocated anew for ``eng``, after every graph captured over the old
        ones is released. Later requests capture anew."""
        if self.graphs is not None:
            self.graphs.drop_all()
        self.state = None     # free the old buffers before the new ones
        self._eng = eng
        max_pos = eng.max_seq_len + eng.tree.num_nodes + 64
        self.params["cos_t"], self.params["sin_t"] = L.make_rope(
            self.tcfg, max_pos, self.device)
        self.state = SE.alloc_state(
            self._statics(0), self.params["target"]["embed_tokens"].dtype,
            self.device)

    def _statics(self, max_new: int, sp: Optional[SamplingParams] = None,
                 use_calibration: bool = False,
                 collect_calibration: bool = False,
                 collect_hiddens: bool = False) -> SE.Statics:
        return SE.Statics(tcfg=self.tcfg, dcfg=self.dcfg, tree=self.eng.tree,
                          eng=self.eng, sp=sp or self.sp, n_img=self.n_img,
                          eos_id=self.eos_id, max_new=max_new,
                          attn_feature_mode=self.attn_feature_mode,
                          use_calibration=use_calibration,
                          collect_calibration=collect_calibration,
                          collect_hiddens=collect_hiddens)

    def autotune_tree(self, candidates=(40, 48, 50, 56, 60, 96, 128),
                      log=None) -> None:
        """The reference's ``total_token = -1`` surface (ea_model.py:
        156-179): time the verify forward at each candidate node budget on
        this device (``engine.autotune.autotune_total_token``) and adopt
        the best tree (reallocating the state, see ``eng``)."""
        from msd_tpu_torch.engine.autotune import autotune_total_token

        tree = autotune_total_token(self.params["target"], self.tcfg,
                                    self.eng, candidates=candidates, log=log,
                                    device=self.device)
        self.eng = dataclasses.replace(self.eng, tree=tree)

    def set_calibrator(self, tables: CalibTables) -> None:
        """Install device calibration tables (``CalibTables.from_host``) for
        ``generate(use_calibration=True)``. A reranking step's graph keys on
        the tables' tensors: new tables capture graphs of their own."""
        self.params["calib"] = tables

    def set_draft(self, draft_params: Dict) -> None:
        """Serve with another draft (e.g. one just distilled). The graphs
        that hold a tensor of the old draft that the new bundle does not
        hold are released first, so the old draft's memory can be freed
        and no graph captured over it is replayed over whatever the
        allocator puts at its addresses; the next request captures anew."""
        old = self.params["draft"]
        self.params["draft"] = draft_params
        if self.graphs is not None:
            self.graphs.drop(_ptrs(old) - _ptrs(self.params))

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
        limit = self._statics(0).step_limit
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
                    max_new_tokens: Optional[int] = None,
                    seed: int = 0) -> int:
        """First new token from the target-only AR prefill."""
        ids, padded, img_pos = self._prompt(ids)
        st = self._statics(max_new_tokens or self.eng.max_new_tokens)
        SE.ar_prefill(st, self.params, self.state, padded, len(ids),
                      img_feats, img_pos, self.rng.manual_seed(seed))
        return int(self.state.bonus)

    def generate(self, ids, img_feats: Optional[torch.Tensor] = None,
                 max_new_tokens: Optional[int] = None, seed: int = 0,
                 sp: Optional[SamplingParams] = None,
                 use_calibration: bool = False,
                 collect_calibration: bool = False,
                 first_token: Optional[int] = None,
                 collect_hiddens: bool = False,
                 fetch_hiddens: Optional[bool] = None) -> GenResult:
        """Speculative (MSD) generation; lossless wrt the target model.

        seed: seeds the request's random draws (sampling); sp: sampling
        parameters for this request (default: the generator's).
        use_calibration: calibrated tree rerank (set_calibrator first).
        collect_calibration: return per-node calibration features/labels.
        first_token: pin the first new token (see first_token()).
        collect_hiddens: return the engine's own hidden state of every
        committed position and the expanded ids (``traj_hidden``,
        ``exp_ids``): on-policy distillation data with decode-time
        numerics. fetch_hiddens: copy them to the host (default:
        collect_hiddens); False runs the collecting step without the
        copy."""
        if use_calibration and "calib" not in self.params:
            raise ValueError("set_calibrator() before use_calibration=True")
        ids, padded, img_pos = self._prompt(ids)
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp, use_calibration, collect_calibration,
                           collect_hiddens)
        rng = self.rng.manual_seed(seed)
        with record_function("prefill"):
            SE.prefill(st, self.params, self.state, padded, len(ids),
                       img_feats, img_pos, first_token, rng)
        step = self._step(SE.decode_step, st)
        with record_function("decode"):
            SE.decode(st, self.params, self.state, step, rng)
        s = self.state
        steps = int(s.steps)
        calib_data = {k: _host(v[:steps]) for k, v in s.calib_log.items()} \
            if collect_calibration else None
        traj_hidden = exp_ids = None
        fetch = collect_hiddens if fetch_hiddens is None else fetch_hiddens
        if collect_hiddens and fetch:
            cur = int(s.cur_len)
            traj_hidden = _host(s.traj_hidden[:cur].float())
            exp_ids = _host(s.ids[:cur])
        return GenResult(
            tokens=self._tokens(self._e0(ids, img_feats), max_new),
            accept_steps=steps, accept_len_sum=int(s.acc_sum),
            alpha_hist=_host(s.alpha_hist),
            graph=None if step is None else step.index,
            calib_data=calib_data, traj_hidden=traj_hidden, exp_ids=exp_ids)

    def naive_generate(self, ids, img_feats: Optional[torch.Tensor] = None,
                       max_new_tokens: Optional[int] = None, seed: int = 0,
                       sp: Optional[SamplingParams] = None,
                       share_prefill: bool = False,
                       collect_hiddens: bool = False) -> GenResult:
        """Plain AR baseline over the same weights and KV layout.

        share_prefill: start from the MSD ``prefill`` (target and draft),
        so the AR loop decodes over exactly the KV cache and first token
        every MSD run starts from; otherwise a target-only prefill.
        collect_hiddens: run that prefill as a collecting ``generate`` runs
        it (the AR token itself reads and writes no hiddens)."""
        ids, padded, img_pos = self._prompt(ids)
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp)
        rng = self.rng.manual_seed(seed)
        with record_function("prefill"):
            if share_prefill:
                pst = dataclasses.replace(st, collect_hiddens=collect_hiddens)
                SE.prefill(pst, self.params, self.state, padded, len(ids),
                           img_feats, img_pos, rng=rng)
            else:
                SE.ar_prefill(st, self.params, self.state, padded, len(ids),
                              img_feats, img_pos, rng)
        step = self._step(SE.ar_step, st)
        with record_function("decode"):
            SE.ar_decode(st, self.params, self.state, step, rng)
        return GenResult(tokens=self._tokens(self._e0(ids, img_feats),
                                             max_new),
                         graph=None if step is None else step.index)


def _ptrs(params: Dict) -> set:
    return {t.data_ptr() for t in leaves(params)}


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy that owns its memory (a CPU tensor's ``numpy()`` would
    alias the static buffer, which the next request overwrites)."""
    return x.cpu().numpy().copy()


def _trim(out: np.ndarray, eos_id: int, max_new: int) -> np.ndarray:
    eos = np.nonzero(out == eos_id)[0]
    if len(eos):
        out = out[:eos[0]]
    return out[:max_new]
