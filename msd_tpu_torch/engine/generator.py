"""Host-side wrapper around the engine: prompt bucketing, result extraction
and per-request stats.

The port of the JAX package's ``engine/generator.py`` for prompts whose
images are expanded from placeholders (LLaVA) or inline (Qwen2-VL:
``image_mode="inline"``, the prompt holds the image-pad span and the
caller passes the merged grid ``img_grid`` for mrope; Qwen-VL v1: 1-D
rope, the span found by ``inline_pad_ids``): ``generate`` (MSD in every
drafting mode, greedy or sampled, with the calibrated rerank after
``set_calibrator``, the collection of its features and of the
trajectory's hidden states for distillation), ``generate_stream`` (the same tokens in segments),
``generate_batch`` (B requests as the lanes of one batched step),
``naive_generate`` (the AR baseline, optionally from the MSD prefill;
``generate`` and ``naive_generate`` also take a list of image feature
blocks, one per placeholder: several images, or anyres tiles merged into
one block, fused beforehand and prefilled as they are),
``score`` (a teacher-forced loglikelihood), ``first_token``,
``set_draft`` and ``autotune_tree``. ``prefill`` and
``decode`` ranges mark each request's two phases for ``torch.profiler``.
Sampling draws from one ``torch.Generator`` on the generator's device,
seeded per request from ``seed`` (a batch: one per lane).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from msd_tpu_torch.configs import (DraftConfig, EngineConfig,
                                   IMAGE_TOKEN_INDEX, LlamaConfig)
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.graphs import StepGraphs, leaves
from msd_tpu_torch.calib.device import CalibTables
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.qwen2vl import (IMAGE_PAD_ID, VIDEO_PAD_ID,
                                          mrope_positions)
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
                 image_mode: str = "expand", mrope_section=None,
                 attn_feature_mode: str = "reference", device="cuda",
                 cuda_graphs: bool = True, inline_pad_ids=None):
        self.tcfg, self.dcfg = tcfg, dcfg
        self.n_img, self.eos_id, self.sp = n_img, eos_id, sp
        self.image_mode = image_mode
        self.mrope_section = None if mrope_section is None \
            else tuple(mrope_section)
        # an inline prompt's image-pad ids: Qwen2-VL's image and video pads
        # by default, a Qwen-VL v1 adapter's <imgpad>
        self.inline_pad_ids = tuple(inline_pad_ids) if inline_pad_ids \
            else None
        self.attn_feature_mode = attn_feature_mode
        self.device = torch.device(device)
        self.rng = torch.Generator(device=self.device)
        self.params = {"target": target_params, "draft": draft_params}
        self.graphs = StepGraphs(self.device) \
            if cuda_graphs and self.device.type == "cuda" else None
        self.bstate = None
        self.lane_rngs: List[torch.Generator] = []
        self.last_stream_stats: Optional[Dict] = None
        self.eng = eng

    @property
    def state(self) -> Optional[SE.EngineState]:
        """The single-lane state every one-request call runs on: lane 0 of
        ``bstate``, as views."""
        return self._state

    @state.setter
    def state(self, state: Optional[SE.EngineState]) -> None:
        """Adopt a state (a batched state of one lane, or a lane view); it
        is also the batches' state of one lane, and the states of larger
        batches are released with their graphs."""
        for dropped in getattr(self, "lane_states", {}).values():
            self._release(dropped)
        self.bstate = None if state is None else SE.as_lanes(state)
        self._state = None if state is None else SE.lane(self.bstate, 0)
        self.lane_states: Dict[int, SE.EngineState] = \
            {} if state is None else {1: self.bstate}

    def _release(self, state: SE.EngineState) -> None:
        """Release the graphs captured over ``state``, so its buffers can
        be freed (as ``ContinuousScheduler.close`` does for its own)."""
        if self.graphs is not None:
            self.graphs.drop({t.data_ptr() for t in SE.state_tensors(state)})

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
        self._per_lane: Dict[int, frozenset] = {}
        max_pos = eng.max_seq_len + eng.tree.num_nodes + 64
        self.params["cos_t"], self.params["sin_t"] = L.make_rope(
            self.tcfg, max_pos, self.device)
        self.state = self.alloc_lanes(1)

    def alloc_lanes(self, lanes: int) -> SE.EngineState:
        """A zeroed batched state of ``lanes`` lanes at this generator's
        budgets and dtype."""
        return SE.alloc_state(self._statics(0),
                              self.params["target"]["embed_tokens"].dtype,
                              self.device, lanes)

    def _statics(self, max_new: int, sp: Optional[SamplingParams] = None,
                 use_calibration: bool = False,
                 collect_calibration: bool = False,
                 collect_hiddens: bool = False,
                 lanes: int = 1) -> SE.Statics:
        """The statics of a run on a state of ``lanes`` lanes; the verify
        products a lane count needs one lane at a time are found at its
        first use (``llama.lane_variant``)."""
        if lanes not in self._per_lane:
            self._per_lane[lanes] = L.lane_variant(
                self.params["target"], lanes, self.eng.tree.num_nodes)
        return SE.Statics(tcfg=self.tcfg, dcfg=self.dcfg, tree=self.eng.tree,
                          eng=self.eng, sp=sp or self.sp, n_img=self.n_img,
                          eos_id=self.eos_id, max_new=max_new,
                          image_mode=self.image_mode,
                          mrope_section=self.mrope_section,
                          attn_feature_mode=self.attn_feature_mode,
                          use_calibration=use_calibration,
                          collect_calibration=collect_calibration,
                          collect_hiddens=collect_hiddens,
                          per_lane=self._per_lane[lanes])

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

    def step_fn(self, fn, st: SE.Statics, state: SE.EngineState):
        """The graph replaying ``fn`` over ``state`` (captured now if this
        step, configuration, state and weights have none yet), or None for
        the eager step."""
        if self.graphs is None:
            return None
        return self.graphs.get(fn, st, self.params, state)

    @property
    def max_prompt_tokens(self) -> int:
        """Longest raw (before image expansion) prompt that ``generate``
        and ``naive_generate`` accept under the engine budget: ``_pad``'s
        limit less the image rows' expansion. The harness adapters
        truncate longer eval prompts to it. An inline prompt already holds
        its image rows."""
        return self._statics(0).step_limit - 1 - self._expansion()

    def _expansion(self, has_image: bool = True) -> int:
        """Rows an image prompt gains by expansion (0 inline)."""
        if self.image_mode == "inline" or not has_image:
            return 0
        return max(self.n_img - 1, 0)

    def _pad(self, ids: np.ndarray) -> np.ndarray:
        """Pad to the next multiple of prompt_pad_multiple (128-token
        buckets by default); refuse prompts the engine budget cannot
        hold."""
        m = self.eng.prompt_pad_multiple
        p = ((len(ids) + m - 1) // m) * m
        n_exp = len(ids) + self._expansion()
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
        """The image span's first row: the placeholder (expand) or the
        first image-pad id (inline: ``inline_pad_ids``, else Qwen2-VL's
        image and video pads); len(ids) without one."""
        if self.image_mode == "inline":
            hit = np.isin(ids, self.inline_pad_ids
                          or (IMAGE_PAD_ID, VIDEO_PAD_ID))
        else:
            hit = ids == IMAGE_TOKEN_INDEX
        pos = np.nonzero(hit)[0]
        return int(pos[0]) if len(pos) else len(ids)

    def _qwen_pos(self, rows: int, img_start: int, img_grid):
        """(pos3 [3, rows] on the device or None, pos_delta) of an inline
        prompt padded to ``rows`` with its image span at ``img_start``.
        img_grid: (grid_h, grid_w) of an image or (grid_t, grid_h, grid_w)
        of a video, LLM-space merged grids; None (text-only, or a 1-D rope
        model) gives 1-D positions."""
        if not self.n_img or img_grid is None:
            return None, 0
        gt, (gh, gw) = (1, img_grid) if len(img_grid) == 2 \
            else (img_grid[0], img_grid[1:])
        pos3, delta = mrope_positions(rows, img_start, self.n_img, gh, gw,
                                      grid_t=gt)
        return torch.from_numpy(pos3).to(self.device), delta

    def _prefill(self, st: SE.Statics, state: SE.EngineState, ids, padded,
                 img_pos: int, img_feats, img_grid, rng, ar: bool = False,
                 first_token: Optional[int] = None):
        """The MSD prefill (or with ``ar`` the target-only one) of one
        request into ``state``, by the image mode; ``first_token`` pins an
        expand-mode MSD prefill's first token."""
        if self.image_mode == "inline":
            pos3, delta = self._qwen_pos(padded.shape[0], img_pos, img_grid)
            fn = SE.qwen_ar_prefill if ar else SE.qwen_prefill
            fn(st, self.params, state, padded, len(ids), img_feats, img_pos,
               pos3, delta, rng)
        elif ar:
            SE.ar_prefill(st, self.params, state, padded, len(ids),
                          img_feats, img_pos, rng)
        else:
            SE.prefill(st, self.params, state, padded, len(ids), img_feats,
                       img_pos, first_token, rng)

    def _fuse_multi(self, ids, img_feats_list) -> tuple:
        """A multi-image prompt's fused block on the device
        (``models/llava.fuse_embeddings_multi``; llava_arch.py:229-324),
        padded to the next multiple of prompt_pad_multiple: (fused
        [P, H], exp_ids [P] int32, image-row mask [P], e0, img_pos), e0
        the fused length and img_pos its first image row (e0 without one).
        Refuses a block the engine budget cannot hold."""
        from msd_tpu_torch.models.llava import fuse_embeddings_multi

        fused, exp_ids, img_rows = fuse_embeddings_multi(
            self.params["target"]["embed_tokens"], ids, img_feats_list)
        e0 = fused.shape[0]
        limit = self._statics(0).step_limit
        if e0 >= limit:
            raise ValueError(f"multi-image prompt too long: {e0} expanded "
                             f"tokens, engine budget allows < {limit}")
        m = self.eng.prompt_pad_multiple
        pad = -(-e0 // m) * m - e0
        fused = torch.cat([fused, fused.new_zeros(pad, fused.shape[1])])
        exp_ids = torch.cat([exp_ids, exp_ids.new_zeros(pad)])
        img_rows = torch.cat([img_rows, img_rows.new_zeros(pad)])
        first = torch.nonzero(img_rows)
        img_pos = int(first[0, 0]) if len(first) else e0
        return fused, exp_ids, img_rows, e0, img_pos

    def _prompt(self, ids):
        ids = np.asarray(ids, np.int32)
        padded = torch.from_numpy(self._pad(ids)).to(self.device)
        return ids, padded, self._img_pos(ids)

    def _e0(self, ids: np.ndarray, img_feats) -> int:
        return len(ids) + self._expansion(img_feats is not None)

    def _tokens(self, e0: int, max_new: int) -> np.ndarray:
        cur = int(self.state.cur_len)
        return _trim(_host(self.state.ids[e0:cur + 1]), self.eos_id, max_new)

    def first_token(self, ids, img_feats: Optional[torch.Tensor] = None,
                    max_new_tokens: Optional[int] = None,
                    seed: int = 0) -> int:
        """First new token from the target-only AR prefill (expand-mode
        prompts: an inline prompt's first token is not pinned)."""
        if self.image_mode == "inline":
            raise ValueError("first_token is not supported for inline-mode "
                             "prompts")
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
                 fetch_hiddens: Optional[bool] = None,
                 img_grid=None) -> GenResult:
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
        copy. img_grid: an inline prompt's merged image grid (mrope)."""
        if use_calibration and "calib" not in self.params:
            raise ValueError("set_calibrator() before use_calibration=True")
        multi = isinstance(img_feats, (list, tuple))
        if first_token is not None and (self.image_mode == "inline"
                                        or multi):
            # only the expand-mode single-image prefill takes a pinned
            # first token; dropping it silently would void the alignment
            # asked for
            raise ValueError("first_token is not supported for inline-mode "
                             "or multi-image prompts")
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp, use_calibration, collect_calibration,
                           collect_hiddens)
        rng = self.rng.manual_seed(seed)
        with record_function("prefill"):
            if multi:
                fused, exp_ids, img_rows, e0, img_pos = self._fuse_multi(
                    ids, img_feats)
                SE.prefill_prefused(st, self.params, self.state, fused,
                                    exp_ids, e0, img_rows, img_pos, rng)
            else:
                ids, padded, img_pos = self._prompt(ids)
                self._prefill(st, self.state, ids, padded, img_pos,
                              img_feats, img_grid, rng,
                              first_token=first_token)
                e0 = self._e0(ids, img_feats)
        step = self.step_fn(SE.decode_step, st, self.bstate)
        with record_function("decode"):
            SE.decode(st, self.params, self.bstate, step, rng)
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
            tokens=self._tokens(e0, max_new),
            accept_steps=steps, accept_len_sum=int(s.acc_sum),
            alpha_hist=_host(s.alpha_hist),
            graph=None if step is None else step.index,
            calib_data=calib_data, traj_hidden=traj_hidden, exp_ids=exp_ids)

    def generate_stream(self, ids, img_feats: Optional[torch.Tensor] = None,
                        max_new_tokens: Optional[int] = None, seed: int = 0,
                        sp: Optional[SamplingParams] = None,
                        segment: int = 16,
                        use_calibration: bool = False, img_grid=None
                        ) -> Iterator[np.ndarray]:
        """Streaming MSD generation: yields np.int32 arrays of the newly
        committed tokens every ~``segment`` tokens.

        The prefill runs once, then each segment is ``decode_until`` with
        a growing bound (``stop_at``, in the state), over the same step,
        and on the card the same captured graph, as ``generate``: the
        chunks concatenate to ``generate``'s tokens for the same seed. One
        host read of the tokens per segment. The generator's state is the
        stream's until it ends. The final acceptance stats land in
        ``self.last_stream_stats``."""
        if use_calibration and "calib" not in self.params:
            raise ValueError("set_calibrator() before use_calibration=True")
        ids, padded, img_pos = self._prompt(ids)
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp, use_calibration)
        rng = self.rng.manual_seed(seed)
        self._prefill(st, self.state, ids, padded, img_pos, img_feats,
                      img_grid, rng)
        e0 = self._e0(ids, img_feats)
        step = self.step_fn(SE.decode_step, st, self.bstate)
        s = self.state
        emitted, target = 0, 0
        while True:
            target += segment
            SE.decode_until(st, self.params, self.bstate, [target], step,
                            [rng])
            out = self._tokens(e0, max_new)
            if len(out) > emitted:
                yield out[emitted:]
                emitted = len(out)
            if bool(s.done):
                break
        self.last_stream_stats = {"accept_steps": int(s.steps),
                                  "accept_len_sum": int(s.acc_sum)}

    def lane_rng(self, b: int) -> torch.Generator:
        """Lane b's generator of random draws (on the generator's device,
        made at first use, reseeded by every batch)."""
        while len(self.lane_rngs) <= b:
            self.lane_rngs.append(torch.Generator(device=self.device))
        return self.lane_rngs[b]

    def generate_batch(self, ids_list: Sequence,
                       img_feats_list: Optional[Sequence] = None,
                       max_new_tokens: Optional[int] = None, seed: int = 0,
                       sp: Optional[SamplingParams] = None,
                       seeds: Optional[Sequence[int]] = None,
                       img_grid=None) -> List[GenResult]:
        """Batched speculative generation: the B prompts decode together as
        the lanes of one batched state (the JAX package's ``vmap`` of its
        generate program). Every step, one replayed graph on the card,
        advances all B lanes: each draft forward and the target's verify
        forward read the weights once for the B lanes' rows. Lane b is
        prefilled alone, exactly as ``generate`` prefills it, and steps
        until its own stop; a finished lane is masked. Each lane's tokens
        are those of its request run alone: the verify products that the
        device rounds otherwise over B lanes' rows than over one lane's
        run one lane at a time (``Statics.per_lane``).
        ``img_feats_list``: one [n_img, H] tensor or None per prompt;
        inline engines take one shared ``img_grid`` per batch, as the JAX
        package does (lanes without image rows take 1-D positions).

        B is run on a state of the next power of two of lanes, the pad
        lanes kept out of every step (``stop_at`` 0; a step computes them
        and commits nothing of theirs), so a generator keeps at most the
        states of 1, 2, 4, 8, ... lanes (``lane_states``; 1 is the
        one-request state) and on the card one graph per (configuration,
        lane count), captured at its first use.

        Sampling: lane b draws from its own generator seeded with
        ``seeds[b]`` (default ``seed + b``), so lane b reproduces
        ``generate(..., seed=seeds[b])``. This departs from the JAX
        package, whose lanes take ``jax.random.split(PRNGKey(seed), B)``, a
        stream the port does not reproduce (no random stream of the port is
        JAX's)."""
        B = len(ids_list)
        lanes = 1 << (B - 1).bit_length()
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp, lanes=lanes)
        feats = list(img_feats_list) if img_feats_list is not None \
            else [None] * B
        seeds = [seed + b for b in range(B)] if seeds is None else seeds
        prompts = [self._prompt(ids) for ids in ids_list]   # validates all
        state = self.lane_states.get(lanes)
        if state is None:
            state = self.lane_states[lanes] = self.alloc_lanes(lanes)
        rngs = [self.lane_rng(b).manual_seed(int(s))
                for b, s in enumerate(seeds)]
        with record_function("prefill"):
            for b, (ids, padded, img_pos) in enumerate(prompts):
                self._prefill(st, SE.lane(state, b), ids, padded, img_pos,
                              feats[b], None if feats[b] is None
                              else img_grid, rngs[b])
        step = self.step_fn(SE.decode_step, st, state)
        with record_function("decode"):
            SE.decode_until(st, self.params, state,
                            [max_new] * B + [0] * (lanes - B), step, rngs)
        cur, steps = _host(state.cur_len), _host(state.steps)
        acc, hist = _host(state.acc_sum), _host(state.alpha_hist)
        ids_host = _host(state.ids)
        out = []
        for b, (ids, _, _) in enumerate(prompts):
            e0 = self._e0(ids, feats[b])
            out.append(GenResult(
                tokens=_trim(ids_host[b, e0:cur[b] + 1], self.eos_id,
                             max_new),
                accept_steps=int(steps[b]), accept_len_sum=int(acc[b]),
                alpha_hist=hist[b],
                graph=None if step is None else step.index))
        return out

    def score(self, ids, cont_start: int,
              img_feats: Optional[torch.Tensor] = None,
              img_grid=None) -> tuple:
        """Teacher-forced loglikelihood of ids[cont_start:] given
        ids[:cont_start] (the lmms ``loglikelihood`` request): one eager
        forward (``engine/scoring.py``) over the request padded to the
        prompt bucket; inline prompts with mrope positions from
        ``img_grid``. Returns (logprob_sum: float, is_greedy: bool)."""
        from msd_tpu_torch.engine import scoring as SC

        ids = np.asarray(ids, np.int32)
        if not 0 < cont_start < len(ids):
            raise ValueError(
                f"cont_start={cont_start} outside (0, {len(ids)})")
        m = self.eng.prompt_pad_multiple
        padded = np.zeros((((len(ids) + m - 1) // m) * m,), np.int32)
        padded[:len(ids)] = ids
        dev_ids = torch.from_numpy(padded).to(self.device)
        if self.image_mode == "inline":
            pos3, _ = self._qwen_pos(len(padded), self._img_pos(ids),
                                     img_grid)
            lp, n_match, n_cont = SC.qwen_score_program(
                self.tcfg, self.n_img if img_feats is not None else 0,
                self.mrope_section, self.params, dev_ids, len(ids),
                int(cont_start), img_feats, self._img_pos(ids), pos3)
        else:
            lp, n_match, n_cont = SC.score_program(
                self.tcfg, self.n_img, self.params, dev_ids, len(ids),
                int(cont_start), img_feats, self._img_pos(ids))
        return float(lp), bool(int(n_match) == int(n_cont))

    def naive_generate(self, ids, img_feats: Optional[torch.Tensor] = None,
                       max_new_tokens: Optional[int] = None, seed: int = 0,
                       sp: Optional[SamplingParams] = None,
                       share_prefill: bool = False,
                       collect_hiddens: bool = False,
                       img_grid=None) -> GenResult:
        """Plain AR baseline over the same weights and KV layout.

        share_prefill: start from the MSD ``prefill`` (target and draft),
        so the AR loop decodes over exactly the KV cache and first token
        every MSD run starts from; otherwise a target-only prefill.
        collect_hiddens: run that prefill as a collecting ``generate`` runs
        it (the AR token itself reads and writes no hiddens). Inline
        prompts (``img_grid`` as in ``generate``) take the target-only
        prefill; share_prefill is for expand-mode prompts."""
        multi = isinstance(img_feats, (list, tuple))
        if share_prefill and (self.image_mode != "expand" or multi):
            raise ValueError("share_prefill supports expand-mode "
                             "single-image/text prompts only")
        max_new = max_new_tokens or self.eng.max_new_tokens
        st = self._statics(max_new, sp)
        rng = self.rng.manual_seed(seed)
        if not multi:
            ids, padded, img_pos = self._prompt(ids)
            e0 = self._e0(ids, img_feats)
        with record_function("prefill"):
            if multi:
                fused, exp_ids, _, e0, _ = self._fuse_multi(ids, img_feats)
                SE.ar_prefill_prefused(st, self.params, self.state, fused,
                                       exp_ids, e0, rng)
            elif share_prefill:
                pst = dataclasses.replace(st, collect_hiddens=collect_hiddens)
                SE.prefill(pst, self.params, self.state, padded, len(ids),
                           img_feats, img_pos, rng=rng)
            else:
                self._prefill(st, self.state, ids, padded, img_pos,
                              img_feats, img_grid, rng, ar=True)
        step = self.step_fn(SE.ar_step, st, self.state)
        with record_function("decode"):
            SE.ar_decode(st, self.params, self.state, step, rng)
        return GenResult(tokens=self._tokens(e0, max_new),
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
