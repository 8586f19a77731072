"""The MSD decode engine: speculative decoding with every drafting mode of
the JAX package (greedy or sampled, optionally with the calibrated tree
rerank) and the AR baseline.

The port of the JAX package's ``engine/spec_engine.py``:

  prefill : fused multimodal embedding -> target prefill -> first token ->
            draft prefill (EAGLE shift-by-one pairing, image rows bypassing
            the fusion fc).
  decode  : a host loop over one verify step: extend the draft KV with the
            accepted rows, draft a tree, verify all nodes in one target
            forward with window-canonical attention, accept (greedily, or
            by speculative sampling), gather the accepted path's KV into
            place. The tree comes from one of four drafting modes:
            EAGLE recursion (the OPT-Tree frontier with its early stop,
            ``_draft_expand_eagle``; the default, ``medusa_heads=0``),
            medusa heads over a static width plan or ``medusa_choices``
            (``_draft_expand_medusa``), or a static choices tree
            (``_draft_expand_static``). With calibration the candidates
            are reranked by the calibrated acceptance probability
            (``_rerank``); with collection every step records per-node
            features and labels (``_collect_step``). The JAX
            ``lax.while_loop`` becomes a loop with one host read per step,
            of ``done``; on the card each step is one CUDA-graph replay
            (``engine/graphs.py``).
  ar      : the AR baseline, one token per target forward (``ar_step``),
            whose single query row goes to the CUDA decode-attention kernel.

With ``collect_hiddens`` the prefill and every commit also write the target
hidden of each committed position into ``traj_hidden``: the distillation
records of ``train/data_gen.record_from_traj``, with the numerics the
draft's suffix path reads back at serve time.

All engine state lives in one ``EngineState`` of static buffers, allocated
once per generator (``alloc_state``) and updated IN PLACE: the prefills
zero and refill it, ``decode_step`` and ``ar_step`` read and write only its
tensors and the weights. Engine scalars (committed length E, lengths,
counters, the request's token limit) are 0-dim device tensors, as the
traced scalars of the JAX programs, so a step issues no host sync and no
host-to-device copy, and one captured step serves every request. A
sampling step reads its random draws from the state's ``rand`` buffer,
which ``draw`` fills from the request's ``torch.Generator`` before each
step, outside any captured graph.

Conventions (post image expansion everywhere): E is the committed expanded
length (= target KV length); ``bonus`` is the sampled-but-uncommitted next
token at position E, root of the next tree; draft row j pairs emb(token at
j+1) with the target hidden at j.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from msd_tpu_torch.calib.device import calibration_bias
from msd_tpu_torch.configs import (DraftConfig, EngineConfig, LlamaConfig,
                                   TreeConfig)
from msd_tpu_torch.engine import static_tree
from msd_tpu_torch.engine import tree as tree_mod
from msd_tpu_torch.engine.tree import Tree
from msd_tpu_torch.engine.tree import top_k as _top_k
from msd_tpu_torch.models import draft as draft_mod
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import expand_ids, fuse_embeddings
from msd_tpu_torch.ops.attention import NEG_INF, causal_prefill_bias
from msd_tpu_torch.ops.sampling import (SamplingParams,
                                        apply_repetition_penalty,
                                        canon_logits, gumbel_noise,
                                        process_logits, sample_token)


@dataclass(frozen=True)
class Statics:
    """Static configuration of one engine run (the JAX programs' static
    argument)."""

    tcfg: LlamaConfig
    dcfg: DraftConfig
    tree: TreeConfig
    eng: EngineConfig
    sp: SamplingParams
    n_img: int          # 0 (text-only) or the image row count (576)
    eos_id: int
    # the request's token limit: the prefills write it into the state's
    # ``max_new`` scalar, which the steps read (as the JAX ``decode_until``
    # takes ``stop_at`` traced), so a step does not depend on it
    max_new: int
    # visual-attention calibration feature:
    #   "reference": row[child_idx] of the latest draft prefix forward, 0
    #                beyond the valid rows (faithful to cnets.py:516-575);
    #   "last_row":  the current position's attention over the image span
    #                (row valid_rows - 1), broadcast to all candidates
    attn_feature_mode: str = "reference"
    # calibrated tree construction (params must carry a "calib" CalibTables)
    use_calibration: bool = False
    # record per-node calibration features/labels each step
    collect_calibration: bool = False
    # write the target hidden of every committed position into
    # ``traj_hidden`` (prefill rows, then the accepted rows of each step)
    collect_hiddens: bool = False

    def __post_init__(self):
        if self.tree.static_choices is not None and self.need_attn:
            # the JAX package neither reranks nor collects a static tree
            raise ValueError("static_choices trees take no calibration: "
                             "use_calibration and collect_calibration "
                             "need EAGLE or medusa drafting")

    @property
    def s_target(self) -> int:
        """Target KV capacity: prompt + generation + one tree, rounded up to
        a multiple of 128 (as the JAX engine allocates it)."""
        return -128 * (-(self.eng.max_seq_len + self.tree.num_nodes) // 128)

    @property
    def s_draft(self) -> int:
        """Draft KV capacity: stable prefix + suffix pad + frontier scratch."""
        t = self.tree
        return self.eng.max_seq_len + t.max_path_len + t.max_depth * t.top_k + 8

    @property
    def step_limit(self) -> int:
        """Committed length at which MSD stops: room for one more tree and
        path below max_seq_len."""
        return self.eng.max_seq_len - self.tree.num_nodes \
            - self.tree.max_path_len - 2

    @property
    def need_attn(self) -> bool:
        return self.use_calibration or self.collect_calibration


class EngineState(NamedTuple):
    """The engine's static buffers; every field is updated in place."""

    ids: torch.Tensor            # [S_t] int32 expanded committed ids
    cur_len: torch.Tensor        # E
    bonus: torch.Tensor          # pending token at position E
    suffix_tokens: torch.Tensor  # [MAX_PATH] tokens of the next suffix rows
    suffix_hidden: torch.Tensor  # [MAX_PATH, H] target hidden of those rows
    suffix_len: torch.Tensor
    last_draft_hidden: torch.Tensor  # [H]
    target_kv: Dict              # {"k", "v"} [L, S_t, Hkv, D]
    draft_kv: Dict               # {"k", "v"} [L_d, S_d, Hkv, D]
    draft_len: torch.Tensor      # draft stable KV length
    max_new: torch.Tensor        # the request's token limit
    new_tokens: torch.Tensor
    steps: torch.Tensor
    acc_sum: torch.Tensor        # sum of (accept_len + 1) over verify steps
    alpha_hist: torch.Tensor     # [16] histogram of tokens per step
    done: torch.Tensor           # MSD: stop; AR: the last token stopped
    img_pos: torch.Tensor        # placeholder index (= image span start)
    attn_feat: torch.Tensor      # [TOP_K] visual-attention intensity per
    #                              child slot from the latest draft forward
    calib_log: Dict              # {field: [LOG_ROWS, N]} per-step features
    #                              and labels (collect_calibration)
    rand: torch.Tensor           # [D * K + V] uniform draws of one step:
    #                              the acceptance walk's [D, K], then the
    #                              final token's [V] (sampling)
    traj_hidden: torch.Tensor    # [S_t, H] target hidden per committed
    #                              position (collect_hiddens)


CALIB_FIELDS = {"token": torch.int32, "depth": torch.int32,
                "draft_conf": torch.float32, "attn": torch.float32,
                "margin": torch.float32, "base_conf": torch.float32,
                "base_top1": torch.int32, "base_margin": torch.float32,
                "accept": torch.int32, "valid": torch.int32}


def _walk_draws(st: Statics) -> int:
    """Uniform draws of one sampled verify step's acceptance walk."""
    t = st.tree
    return t.max_depth * tree_mod.sampling_width(t.num_nodes, t.top_k)


def alloc_state(st: Statics, dtype: torch.dtype, device) -> EngineState:
    """Zeroed static buffers for engines of ``st``'s capacity; hiddens and
    KV caches in ``dtype`` (the weights' dtype).

    The calibration log has ``st.step_limit`` rows: a verify step runs only
    while the committed length is below that limit and commits at least
    one token past a prompt of at least one, so no request takes more
    steps and its row ``steps`` is always in the log."""
    P, N = st.tree.max_path_len, st.tree.num_nodes

    def scalar(dt=torch.int32):
        return torch.zeros((), dtype=dt, device=device)

    return EngineState(
        ids=torch.zeros(st.s_target, dtype=torch.int32, device=device),
        cur_len=scalar(), bonus=scalar(),
        suffix_tokens=torch.zeros(P, dtype=torch.int32, device=device),
        suffix_hidden=torch.zeros(P, st.tcfg.hidden_size, dtype=dtype,
                                  device=device),
        suffix_len=scalar(),
        last_draft_hidden=torch.zeros(st.dcfg.text.hidden_size, dtype=dtype,
                                      device=device),
        target_kv=L.init_kv_cache(st.tcfg, st.s_target, dtype, device),
        draft_kv=draft_mod.init_draft_kv(st.dcfg, st.s_draft, dtype, device),
        draft_len=scalar(), max_new=scalar(), new_tokens=scalar(),
        steps=scalar(), acc_sum=scalar(),
        alpha_hist=torch.zeros(16, dtype=torch.int32, device=device),
        done=scalar(torch.bool), img_pos=scalar(),
        attn_feat=torch.zeros(st.tree.top_k, dtype=torch.float32,
                              device=device),
        calib_log={k: torch.zeros(st.step_limit, N, dtype=dt, device=device)
                   for k, dt in CALIB_FIELDS.items()},
        rand=torch.zeros(_walk_draws(st) + st.tcfg.vocab_size,
                         dtype=torch.float32, device=device),
        traj_hidden=torch.zeros(st.s_target, st.tcfg.hidden_size,
                                dtype=dtype, device=device))


def draw(state: EngineState, rng: torch.Generator):
    """Fill the state's ``rand`` with the next step's uniform draws from
    ``rng`` (one launch, outside any captured graph, so every replay of a
    sampling step consumes fresh draws and reseeding ``rng`` changes
    them)."""
    state.rand.uniform_(0.0, 1.0, generator=rng)


def _step_draws(st: Statics, s: EngineState):
    """(acceptance-walk uniforms [D, K], Gumbel noise [V]) from ``rand``."""
    n = _walk_draws(st)
    return (s.rand[:n].view(st.tree.max_depth, -1),
            gumbel_noise(s.rand[n:]))


def step_params(st: Statics, params: Dict) -> Dict:
    """The part of ``params`` that a step of ``st`` reads: the calibration
    tables only when it reranks, so installing tables leaves the other
    steps' graphs (keyed on what they read) valid."""
    if st.use_calibration or "calib" not in params:
        return params
    return {k: v for k, v in params.items() if k != "calib"}


def state_tensors(state: EngineState) -> List[torch.Tensor]:
    """Every buffer of the state, the KV caches' k and v included."""
    out = []
    for x in state:
        out.extend(x.values() if isinstance(x, dict) else [x])
    return out


def _reset(st: Statics, state: EngineState):
    """Zero every buffer, as a fresh allocation is zeroed, so no request
    sees rows an earlier one left behind; set the request's token limit."""
    for x in state_tensors(state):
        x.zero_()
    state.max_new.fill_(st.max_new)


def _write(buf: torch.Tensor, val: torch.Tensor, start, dim: int = 0):
    """In-place ``lax.dynamic_update_slice`` of ``val`` into ``buf`` along
    ``dim`` at ``start`` (int or 0-dim tensor, clamped as JAX clamps)."""
    rows = L.update_rows(buf.shape[dim], start, val.shape[dim], buf.device)
    buf.index_copy_(dim, rows, val)


# ---------------------------------------------------------------------------
# Draft tree expansion: EAGLE recursion, medusa heads, static trees
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _medusa_layout(t: TreeConfig, medusa_heads: int, device: str):
    """Static slot layout of the medusa tree, built once per (tree config,
    head count, device) with numpy as the JAX version builds it at trace
    time. Returns (d_use, W, parents, mask, positions, retrieve, valid,
    slot_depth, slot_rank) with the arrays as device tensors; slot s >= 1
    carries head (depth - 1)'s rank-``slot_rank`` candidate.

    ``t.medusa_choices`` gives the tree's paths (prefix-closed, each cut to
    the 1 + medusa_heads draftable depths, depth-major, the budget cut to
    num_nodes - 1: prefixes sort first, so the cut keeps the closure);
    otherwise ``t.medusa_widths`` does, each depth's candidates branching
    off the previous depth's rank-0 node (backbone chain)."""
    K, D, N = t.top_k, t.max_depth, t.num_nodes
    d_cap = min(D, 1 + medusa_heads)
    if t.medusa_choices is not None:
        closed = set()
        for p in t.medusa_choices:
            p = tuple(int(r) for r in p)[:d_cap]
            closed.update(p[:i] for i in range(1, len(p) + 1))
        paths = sorted(closed, key=lambda p: (len(p), p))[:N - 1]
    else:
        widths = list(t.medusa_widths) if t.medusa_widths is not None \
            else [K] * D
        # fit the width plan into the node budget, shallow depths first
        budget, fitted = N - 1, []
        for wd in widths[:d_cap]:
            take = min(wd, budget)
            if take <= 0:
                break
            fitted.append(take)
            budget -= take
        paths = [(0,) * (d - 1) + (r,)
                 for d in range(1, len(fitted) + 1)
                 for r in range(fitted[d - 1])]
    d_use = max((len(p) for p in paths), default=0)
    w = 1 + max((p[-1] for p in paths), default=0)
    slot_of = {p: i + 1 for i, p in enumerate(paths)}

    P = t.max_path_len
    depth = np.zeros((N,), np.int32)
    par = np.zeros((N,), np.int32)
    rank = np.zeros((N,), np.int32)
    valid = np.zeros((N,), bool)
    valid[0] = True
    mask = np.eye(N, dtype=bool)
    mask[:, 0] = True
    ret = np.full((N, P), -1, np.int32)
    ret[0, 0] = 0
    for p, s in slot_of.items():
        d = len(p)
        depth[s] = d
        par[s] = slot_of[p[:-1]] if d > 1 else 0
        rank[s] = p[-1]
        valid[s] = True
        ret[s, 0] = 0
        for a in range(1, d + 1):
            mask[s, slot_of[p[:a]]] = True
            ret[s, a] = slot_of[p[:a]]

    def dev(a):
        return torch.from_numpy(a).to(device)

    return (d_use, w, dev(par), dev(mask), dev(depth), dev(ret), dev(valid),
            dev(np.maximum(depth - 1, 0).astype(np.int64)),
            dev(rank.astype(np.int64)))


def _attn_rows(st: Statics, t_rows: int, valid_rows) -> torch.Tensor:
    """The rows of a draft forward's [Hq, T, S] attention probabilities
    that ``_attn_feature_vec`` reads: row min(k, T - 1) for each child slot
    k ("reference"), or the last valid row ("last_row"). valid_rows: 0-dim
    int tensor on the device."""
    if st.attn_feature_mode == "last_row":
        return torch.clamp(valid_rows.long() - 1, 0, t_rows - 1).reshape(1)
    return torch.clamp(torch.arange(st.tree.top_k, device=valid_rows.device),
                       max=t_rows - 1)


def _attn_feature_vec(st: Statics, attn_probs: torch.Tensor,
                      img_pos: torch.Tensor, valid_rows: torch.Tensor,
                      t_rows: int) -> torch.Tensor:
    """[TOP_K] mean attention of row child_idx over the image span.

    attn_probs: [Hq, R, S], the rows ``_attn_rows(st, t_rows, valid_rows)``
    of a T = t_rows draft prefix/suffix forward. Faithful to
    cnets.py:516-575: candidate_idx indexes ROWS of the latest prefix
    forward (rows beyond the valid length give 0.0), span = [img_pos-1,
    img_pos-1+n_img), its start clamped into the cache as
    ``lax.dynamic_slice`` clamps it.
    """
    K = st.tree.top_k
    n_img = max(st.n_img, 1)
    mean_h = attn_probs.mean(dim=0)                               # [R, S]
    start = torch.clamp(img_pos - 1, min=0)
    span = mean_h.index_select(1, L.update_rows(mean_h.shape[1], start,
                                                n_img, mean_h.device))
    row_mean = span.mean(dim=1)                                   # [R]
    if st.attn_feature_mode == "last_row":
        ok = (valid_rows > 0) & (st.n_img > 0)
        return torch.where(ok, row_mean.expand(K), 0.0)
    k_idx = torch.arange(K, device=row_mean.device)
    ok = (k_idx < valid_rows) & (k_idx < t_rows) & (st.n_img > 0)
    return torch.where(ok, row_mean, 0.0)


def _rerank(st: Statics, params: Dict, logits: torch.Tensor,
            cand_ids: torch.Tensor, cand_probs: torch.Tensor,
            attn_feat: torch.Tensor, depth: torch.Tensor):
    """Calibrated rerank of per-row candidate sets, each row reordered
    within its own candidates.

    logits/cand_ids/cand_probs: [R, V] / [R, K] / [R, K]; depth: [R]
    per-row depths. Implements cnets.py:1286-1339: calibrated logit bias
    scatter-added at the candidate ids, re-softmax, reselect K within each
    row's candidate set (lowest column first on ties, as ``lax.top_k``).
    Returns (new_ids, new_probs, margin_row).
    """
    R, K = cand_ids.shape
    # K is 1 for width-1 medusa plans: the top1-top2 margin degrades to the
    # top1 prob (no runner-up), cnets.py's single-candidate fallback
    margin_row = cand_probs[:, 0] - cand_probs[:, 1] if K > 1 \
        else cand_probs[:, 0]                                     # [R]
    if attn_feat.shape[0] < K:  # medusa width can exceed the top_k slots
        attn_feat = torch.cat([attn_feat, attn_feat.new_zeros(
            K - attn_feat.shape[0])])

    def per_candidate(row_values):
        return row_values[:, None].expand(R, K).reshape(-1)

    bias = calibration_bias(
        params["calib"], cand_ids.reshape(-1), cand_probs.reshape(-1),
        attn_feat[:K].repeat(R), per_candidate(depth),
        per_candidate(margin_row)).reshape(R, K)
    ids = cand_ids.long()
    logits_c = logits.scatter_add(1, ids, bias.to(logits.dtype))
    probs_c = torch.softmax(logits_c.float(), dim=-1)
    scores = torch.gather(probs_c, 1, ids)                        # [R, K]
    new_scores, order = _top_k(scores, K)
    return torch.gather(cand_ids, 1, order), new_scores, margin_row


def _draft_expand_medusa(st: Statics, params: Dict, last_hidden: torch.Tensor,
                         root_token: torch.Tensor,
                         attn_feat: Optional[torch.Tensor] = None,
                         features: Optional[Dict] = None) -> Tree:
    """Medusa expansion: depth-1 candidates from head(last_hidden), depth
    d >= 2 from resblock head d-2 over the same last_hidden, all through one
    stacked lm_head product. The tree layout is static (_medusa_layout);
    only the tokens are data.

    With ``st.use_calibration`` each depth's candidate row is reranked
    (``_rerank``, over ``attn_feat``). ``features``, a dict, receives the
    per-node collection features ``local_conf``, ``attn`` and ``margin``
    ([N] fp32; the root and unused slots 0)."""
    d_use, w, par, mask, depth, ret, valid, slot_depth, slot_rank = \
        _medusa_layout(st.tree, st.dcfg.medusa_heads, str(last_hidden.device))
    dp = params["draft"]
    head = params["target"]["lm_head"]
    mh = draft_mod.medusa_hiddens(dp["medusa"], last_hidden)     # [Km, H]
    xs = torch.cat([last_hidden[None], mh[:d_use - 1]], dim=0)
    logits = (xs @ head).float()                                 # [d_use, V]
    probs = torch.softmax(logits, dim=-1)
    wts, idx = _top_k(probs, w)                                  # [d_use, W]
    # pre-rerank top1-top2 margin of each depth's candidate row
    margin = wts[:, 0] - wts[:, 1] if w > 1 else wts.new_zeros(d_use)
    if st.use_calibration:
        # row r holds depth r + 1
        idx, wts, _ = _rerank(st, params, logits, idx, wts, attn_feat,
                              torch.arange(1, d_use + 1, device=idx.device))
    cand = idx[slot_depth, slot_rank].to(torch.int32)            # [N]
    tokens = torch.where(valid, cand, torch.full_like(cand, -1))
    tokens[0] = root_token
    if features is not None:
        node = valid & (depth > 0)
        af = attn_feat[torch.clamp(slot_rank, max=attn_feat.shape[0] - 1)]
        features.update(
            local_conf=torch.where(node, wts[slot_depth, slot_rank], 0.0),
            attn=torch.where(node, af, 0.0),
            margin=torch.where(node, margin[slot_depth], 0.0))
    return Tree(tokens=tokens, parents=par, mask=mask, positions=depth,
                retrieve=ret, valid=valid)


def _frontier_bias(s_d: int, write: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, s_d] bias of a frontier forward written at ``write``: row i
    sees the cache below ``write`` (the stable prefix and the frontiers
    written before it) and its own slot write + i (cnets.py:1183-1202)."""
    dev = write.device
    kpos = torch.arange(s_d, device=dev)[None, :]
    self_pos = write + torch.arange(rows, device=dev)[:, None]
    keep = (kpos < write) | (kpos == self_pos)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _draft_expand_eagle(st: Statics, params: Dict, kv: Dict, E: torch.Tensor,
                        last_hidden: torch.Tensor, root_token: torch.Tensor,
                        attn_feat: torch.Tensor,
                        features: Optional[Dict] = None) -> Tree:
    """EAGLE recursion with the OPT-Tree frontier (cnets.py:1066-1427):
    layer 0 = top-k of head(last_hidden); each further layer forwards the
    K-node frontier at scratch rows E + d*K of the draft cache ``kv``
    (identity tree mask, ``_frontier_bias``), path weight = parent weight x
    child prob, global top-K over the [K, K] candidates; the early stop
    fires when the top-``num_draft`` weight-sum increment over the layers
    before the newest is at most ``early_stop_threshold``, and the newest
    layer is dropped (cnets.py:1401-1437). ``finalize_tree`` packs the
    tree.

    The JAX ``lax.while_loop`` ends on the data; a captured step has a
    fixed kernel list and may not read ``stop`` on the host, so the loop
    runs all max_depth - 1 layers: ``stop`` is sticky and ``use_depth`` is
    frozen once it is set, so ``finalize_tree`` sees the layers below it
    as JAX computes them. The layers past the stop write scratch rows that
    nothing reads: layer d reads keys below E + d*K, all written in this
    step, and the next step's suffix forward rewrites from its draft
    length.

    With ``st.use_calibration`` the candidates are reranked at depth 1 and
    at depth layer + 1 (``_rerank``); ``features`` (a dict) receives the
    per-node ``local_conf``, ``attn`` and ``margin``."""
    t = st.tree
    K, D, n_draft = t.top_k, t.max_depth, t.num_draft
    dp, head = params["draft"], params["target"]["lm_head"]
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    dev = last_hidden.device
    logits0 = (last_hidden @ head).float()
    w0, ids0 = _top_k(torch.softmax(logits0, dim=-1), K)
    margin0 = w0[0] - w0[1]
    if st.use_calibration:
        ids0, w0, _ = _rerank(st, params, logits0[None], ids0[None],
                              w0[None], attn_feat,
                              torch.ones(1, dtype=torch.int32, device=dev))
        ids0, w0 = ids0[0], w0[0]
    slots = torch.arange(K, device=dev)
    wm, tm, pm = [w0], [ids0.to(torch.int32)], [slots.to(torch.int32)]
    ex = None
    if features is not None:
        ex = {"local_conf": [w0], "attn": [attn_feat[:K]],
              "margin": [margin0.expand(K)]}

    f_tok, f_hid = ids0, last_hidden.expand(K, -1)
    s_prev = torch.zeros((), device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    use_depth = torch.full((), D, dtype=torch.long, device=dev)
    for layer in range(1, D):
        d = layer - 1   # scratch slot of the frontier being forwarded
        write = E + d * K
        hin = draft_mod.draft_fuse(dp, dp["embed_tokens"][f_tok.long()],
                                   f_hid)
        pos = (E + d).to(torch.int32).expand(K)
        out, _ = draft_mod.draft_forward(
            dp, st.dcfg, hin, pos, kv, write,
            _frontier_bias(st.s_draft, write, K), cos_t, sin_t)
        logits = (out @ head).float()                             # [K, V]
        cw, cid = _top_k(torch.softmax(logits, dim=-1), K)        # [K, K]
        margin_row = cw[:, 0] - cw[:, 1]
        if st.use_calibration:
            cid, cw, margin_row = _rerank(
                st, params, logits, cid, cw, attn_feat,
                torch.full((K,), layer + 1, dtype=torch.int32, device=dev))
        pathw = wm[-1][:, None] * cw
        gw, gidx = _top_k(pathw.reshape(-1), K)
        sel_par = gidx // K
        f_tok = cid.reshape(-1)[gidx]
        wm.append(gw)
        tm.append(f_tok.to(torch.int32))
        pm.append(sel_par.to(torch.int32))
        if ex is not None:
            ex["local_conf"].append(cw.reshape(-1)[gidx])
            ex["attn"].append(attn_feat[gidx % K])
            ex["margin"].append(margin_row[sel_par])
        # early stop on the weight-sum increment over layers [0, layer)
        explored = torch.cat(wm[:layer])
        if n_draft < explored.numel():
            explored = _top_k(explored, n_draft)[0]
        s_now = explored.sum()
        stop_now = (s_now - s_prev) <= t.early_stop_threshold
        use_depth = torch.where(stop, use_depth,
                                torch.where(stop_now, layer, layer + 1))
        stop = stop | stop_now
        s_prev = s_now
        f_hid = out[sel_par]
    extra = None if ex is None else \
        {name: torch.stack(rows) for name, rows in ex.items()}
    return tree_mod.finalize_tree(t, root_token, torch.stack(wm),
                                  torch.stack(tm), torch.stack(pm),
                                  use_depth, extra, features)


def _draft_expand_static(st: Statics, params: Dict, kv: Dict,
                         E: torch.Tensor, last_hidden: torch.Tensor,
                         root_token: torch.Tensor) -> Tree:
    """Static-tree drafting (utils.py:115-233 + choices.py): the tree's
    shape is ``st.tree.static_choices``; the node at path [..., s] takes
    its parent distribution's rank-s token. One draft forward per level
    whose children are drafted (the deepest level's forward feeds nothing
    and is skipped; its output was unused in the JAX version as well):
    the level's rows attend to the stable prefix plus their static
    ancestors, self included, node i's K/V at scratch row E + i - 1.
    Padded to num_nodes (``static_tree.static_plan``)."""
    t = st.tree
    dev = last_hidden.device
    plan = static_tree.static_plan(t.static_choices, t.max_path_len,
                                   t.num_nodes, str(dev))
    dp, head = params["draft"], params["target"]["lm_head"]
    kpos = torch.arange(st.s_draft, device=dev)[None, :]
    rel = kpos - E + 1                  # node id whose scratch row is kpos
    relc = torch.clamp(rel, 0, plan.n - 1)
    in_tree = (rel >= 1) & (rel < plan.n)
    prefix = kpos < E
    top = _top_k((last_hidden @ head).float(), plan.max_slot)[1][None]
    hid = last_hidden[None]
    tokens = [root_token.reshape(1).to(torch.int32)]
    for lv in plan.levels:
        toks = top[lv.parent_row, lv.slot]                        # [W]
        tokens.append(toks.to(torch.int32))
        if lv is plan.levels[-1]:
            break
        hin = draft_mod.draft_fuse(dp, dp["embed_tokens"][toks],
                                   hid[lv.parent_row])
        pos = (E + lv.depth - 1).to(torch.int32).expand(lv.width)
        anc = torch.gather(lv.anc, 1, relc.expand(lv.width, -1))
        bias = torch.where(prefix | (in_tree & anc), 0.0,
                           NEG_INF).to(torch.float32)
        hid, _ = draft_mod.draft_forward(dp, st.dcfg, hin, pos, kv,
                                         E + lv.first - 1, bias,
                                         params["cos_t"], params["sin_t"])
        top = _top_k((hid @ head).float(), plan.max_slot)[1]
    pad = plan.tree.tokens[plan.n:]
    return plan.tree._replace(tokens=torch.cat(tokens + [pad]))


def _draft_expand(st: Statics, params: Dict, last_hidden: torch.Tensor,
                  root_token: torch.Tensor,
                  attn_feat: Optional[torch.Tensor] = None,
                  features: Optional[Dict] = None,
                  kv: Optional[Dict] = None,
                  E: Optional[torch.Tensor] = None) -> Tree:
    """The step's draft tree, by the JAX package's precedence: a static
    choices tree when ``static_choices`` is set, else medusa heads when
    the draft has them, else EAGLE recursion. ``kv`` (the draft cache) and
    ``E`` (its stable length) are what the modes that run the draft layer
    (static, EAGLE) read and write."""
    if st.tree.static_choices is not None:
        return _draft_expand_static(st, params, kv, E, last_hidden,
                                    root_token)
    if st.dcfg.medusa_heads > 0:
        return _draft_expand_medusa(st, params, last_hidden, root_token,
                                    attn_feat, features)
    return _draft_expand_eagle(st, params, kv, E, last_hidden, root_token,
                               attn_feat, features)


def _draft_suffix_forward(st: Statics, params: Dict, s: EngineState,
                          cos_t, sin_t) -> torch.Tensor:
    """Extend the draft stable KV (in place, at ``draft_len``) with the
    accepted rows. Always runs MAX_PATH rows (suffix_len of them valid).
    With calibration or collection, also refreshes ``s.attn_feat`` from
    the rows' layer-0 attention when any row is valid. Returns the draft
    hidden of the last valid row (the previous one when no row is
    valid)."""
    dp = params["draft"]
    P = st.tree.max_path_len
    dev = s.suffix_tokens.device
    emb = dp["embed_tokens"][torch.clamp(s.suffix_tokens, min=0).long()]
    hin = draft_mod.draft_fuse(dp, emb, s.suffix_hidden)
    pos = s.draft_len + torch.arange(P, device=dev, dtype=torch.int32)
    # causal over the growing prefix: row i sees cache slots [0, draft_len+i]
    kpos = torch.arange(st.s_draft, device=dev)[None, :]
    bias = torch.where(kpos <= pos[:, None], 0.0, NEG_INF).to(torch.float32)
    if st.need_attn:
        out, _, attn_p = draft_mod.draft_forward(
            dp, st.dcfg, hin, pos, s.draft_kv, s.draft_len, bias, cos_t,
            sin_t, return_attn=True,
            attn_rows=_attn_rows(st, P, s.suffix_len))
        attn_new = _attn_feature_vec(st, attn_p, s.img_pos, s.suffix_len, P)
        s.attn_feat.copy_(torch.where(s.suffix_len > 0, attn_new,
                                      s.attn_feat))
    else:
        out, _ = draft_mod.draft_forward(dp, st.dcfg, hin, pos, s.draft_kv,
                                         s.draft_len, bias, cos_t, sin_t)
    idx = torch.clamp(s.suffix_len - 1, min=0).reshape(1)
    return torch.where(s.suffix_len > 0, out.index_select(0, idx)[0],
                       s.last_draft_hidden)


# ---------------------------------------------------------------------------
# Target verification and commit
# ---------------------------------------------------------------------------

def verify_forward(tp: Dict, tcfg: LlamaConfig, kv: Dict, E: torch.Tensor,
                   tr: Tree, cos_t, sin_t) -> torch.Tensor:
    """The verify step's target forward over every node of ``tr`` (their
    K/V rows written at E into ``kv`` in place), with window-canonical
    attention: node i's last W = MAX_PATH logical positions (committed
    tail for l < E, tree ancestors/self for l >= E) reduce through fixed
    window slots and the cache product sees only columns below the window,
    so node i's logits are a function of its token and logical prefix
    alone, whatever the draft proposed around it. Returns the final-normed
    hidden [N, H]."""
    dev = tr.tokens.device
    s_target = kv["k"].shape[1]
    emb = tp["embed_tokens"][torch.clamp(tr.tokens, min=0).long()]
    pos = E + tr.positions
    W = tr.retrieve.shape[1]
    win_start = E + tr.positions - (W - 1)                           # [N]
    l = win_start[:, None] + torch.arange(W, device=dev)[None, :]    # [N, W]
    rel = l - E
    anc = torch.gather(tr.retrieve.long(), 1, torch.clamp(rel, 0, W - 1))
    row = torch.where(rel >= 0, E + torch.clamp(anc, min=0), l)
    win_idx = torch.clamp(row, 0, s_target - 1).long()
    win_bias = torch.where(l >= 0, 0.0, NEG_INF).to(torch.float32)
    cols = torch.arange(s_target, device=dev)[None, :]
    bias = torch.where(cols < win_start[:, None], 0.0,
                       NEG_INF).to(torch.float32)
    hidden, _ = L.llama_forward(tp, tcfg, emb, pos, kv, E, bias, cos_t,
                                sin_t, kv_len=E + tr.tokens.shape[0],
                                win=(win_idx, win_bias, win_start))
    return hidden


def _verify(st: Statics, params: Dict, s: EngineState, tr: Tree, cos_t,
            sin_t):
    """One target forward over every tree node (``verify_forward``, into
    ``s.target_kv`` at E = ``s.cur_len``) + lossless acceptance: greedy,
    or speculative sampling over the step's draws in ``s.rand`` with the
    repetition penalty over the committed ids. Returns (hidden, logits,
    best, accept_len, next_token)."""
    tp = params["target"]
    E = s.cur_len
    hidden = verify_forward(tp, st.tcfg, s.target_kv, E, tr, cos_t, sin_t)
    logits = L.lm_head(tp, hidden)                                   # [N, V]
    if st.sp.greedy:
        best, acc_len, next_tok = tree_mod.evaluate_greedy(
            tr, canon_logits(logits, st.sp.greedy_round_bits))
        return hidden, logits, best, acc_len, next_tok
    plogits = logits
    if st.sp.repetition_penalty != 1.0:
        plogits = apply_repetition_penalty(plogits, s.ids, E,
                                           st.sp.repetition_penalty)
    probs = torch.softmax(process_logits(plogits, st.sp), dim=-1)
    uniforms, gumbel = _step_draws(st, s)
    best, acc_len, next_tok = tree_mod.evaluate_sampling(
        tr, probs, uniforms, gumbel, top_k=st.tree.top_k)
    return hidden, logits, best, acc_len, next_tok


def _collect_step(st: Statics, s: EngineState, tr: Tree,
                  logits: torch.Tensor, best, acc_len, features: Dict):
    """Record per-node calibration features + labels for this verify step
    in row ``s.steps`` of ``s.calib_log``.

    The verify pass already computed the target's conditional distribution
    at every tree node, so base_confidence / base_top1 / base_margin come
    from ``logits[parent]`` (the JAX package's replacement for the
    reference's per-parent-path re-forwards, cnets.py:577-716)."""
    N, P = st.tree.num_nodes, st.tree.max_path_len
    dev = logits.device
    p_node = torch.softmax(logits, dim=-1)                        # [N, V]
    # values only: their tie order does not matter
    top2 = torch.topk(p_node, 2, dim=-1).values                   # [N, 2]
    argmax_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    par = tr.parents.long()
    tok = torch.clamp(tr.tokens, min=0).long()
    base_conf = p_node[par, tok]
    base_top1 = (argmax_tok[par] == tr.tokens).to(torch.int32)
    base_margin = top2[par, 0] - top2[par, 1]

    # accept[n]: node n on the accepted path. The JAX package scatters
    # (slot <= accept_len) & (path >= 0) at max(path, 0); the padding slots
    # of a shallow path land on the root too, and the last write wins, as
    # XLA applies a scatter's updates in order
    path = tree_mod.accepted_path(tr, best).long()                # [P]
    slot = torch.arange(P, device=dev)
    on = (slot <= acc_len) & (path >= 0)
    hits = torch.clamp(path, min=0)[None, :] == \
        torch.arange(N, device=dev)[:, None]                      # [N, P]
    last = (P - 1) - torch.argmax(hits.flip(1).to(torch.int32), dim=1)
    accept = (hits.any(dim=1) & on[last]).to(torch.int32)

    node = torch.arange(N, device=dev)
    row = {"token": tr.tokens, "depth": tr.positions.to(torch.int32),
           "draft_conf": features["local_conf"], "attn": features["attn"],
           "margin": features["margin"], "base_conf": base_conf,
           "base_top1": base_top1, "base_margin": base_margin,
           "accept": accept,
           "valid": (tr.valid & (node > 0)).to(torch.int32)}
    i = s.steps.long().reshape(1)
    for key, val in row.items():
        s.calib_log[key].index_copy_(0, i, val[None].to(
            s.calib_log[key].dtype))


def _commit(st: Statics, s: EngineState, tr: Tree, hidden: torch.Tensor,
            best, acc_len, next_tok):
    """Commit the accepted path in place: write its tokens into ids, gather
    its KV rows into the prefix rows [E, E+P), stage the next draft suffix
    (with ``st.collect_hiddens`` also its hiddens into ``traj_hidden`` at
    E), advance the length and counters and set ``done``."""
    P = st.tree.max_path_len
    E = s.cur_len
    dev = hidden.device
    path = tree_mod.accepted_path(tr, best).long()        # [P], -1 padded
    pc = torch.clamp(path, min=0)
    slot = torch.arange(P, device=dev)
    ct = torch.where(slot <= acc_len, tr.tokens[pc],
                     torch.zeros_like(tr.tokens[pc]))
    _write(s.ids, ct, E)

    # the source rows E + pc and the destination rows [E, E+P) overlap:
    # gather into a temporary first, then write
    src = E + pc
    for kv in s.target_kv.values():
        _write(kv, kv[:, src], E, dim=1)                  # [L, P, Hkv, D]

    zero = torch.zeros_like(ct)
    ct_shift = torch.cat([ct[1:], zero[:1]])
    s.suffix_tokens.copy_(torch.where(
        slot < acc_len, ct_shift,
        torch.where(slot == acc_len, next_tok.to(ct.dtype), zero)))
    s.suffix_hidden.copy_(hidden[pc])
    if st.collect_hiddens:
        # rows past the accepted path are overwritten by the next commit
        _write(s.traj_hidden, s.suffix_hidden, E)
    n_new = (acc_len + 1).to(torch.int32)
    eos_hit = torch.any((ct == st.eos_id) & (slot <= acc_len)) \
        | (next_tok == st.eos_id)
    # E is s.cur_len: every read of E comes before it advances
    s.cur_len.add_(n_new)
    s.new_tokens.add_(n_new)
    s.done.copy_(eos_hit | (s.new_tokens >= s.max_new)
                 | (s.cur_len >= st.step_limit))
    s.alpha_hist.index_add_(0, torch.clamp(n_new, max=15).reshape(1),
                            torch.ones_like(n_new).reshape(1))
    s.bonus.copy_(next_tok)
    s.suffix_len.copy_(n_new)
    s.steps.add_(1)
    s.acc_sum.add_(n_new)


# ---------------------------------------------------------------------------
# Public programs
# ---------------------------------------------------------------------------

def _fuse_prompt(st: Statics, params: Dict, ids: torch.Tensor,
                 img_feats: Optional[torch.Tensor], img_pos: int):
    """(fused [P_exp, H], expanded ids [P_exp], image-row mask [P_exp])."""
    tp = params["target"]
    n_img = st.n_img if img_feats is not None else 0
    P_exp = ids.shape[0] + max(n_img - 1, 0)
    if n_img > 0:
        fused = fuse_embeddings(tp["embed_tokens"], ids, img_feats, img_pos,
                                P_exp)
        exp_ids = expand_ids(torch.clamp(ids, min=0), img_pos, n_img, P_exp)
        j = torch.arange(P_exp, device=ids.device)
        img_rows = (j >= img_pos) & (j < img_pos + n_img)
    else:
        fused = tp["embed_tokens"][torch.clamp(ids, min=0).long()]
        exp_ids = ids
        img_rows = torch.zeros(P_exp, dtype=torch.bool, device=ids.device)
    return fused, exp_ids, img_rows


def _target_prefill(st: Statics, params: Dict, state: EngineState,
                    fused: torch.Tensor, exp_ids: torch.Tensor, E0: int,
                    rng: Optional[torch.Generator]):
    """Reset the state, run the target over the prompt (its KV rows into
    ``target_kv``), commit the prompt ids and E0, and sample the first new
    token into ``bonus`` (with Gumbel noise drawn from ``rng`` when
    sampling). Returns the target hidden [P_exp, H]."""
    _reset(st, state)
    tp = params["target"]
    dev = fused.device
    P_exp = fused.shape[0]
    positions = torch.arange(P_exp, device=dev, dtype=torch.int32)
    bias = causal_prefill_bias(P_exp, st.s_target, device=dev)
    hidden, _ = L.llama_forward(tp, st.tcfg, fused, positions,
                                state.target_kv, 0, bias, params["cos_t"],
                                params["sin_t"])
    gumbel = None if st.sp.greedy else gumbel_noise(torch.rand(
        st.tcfg.vocab_size, generator=rng, device=dev))
    state.bonus.copy_(sample_token(L.lm_head(tp, hidden[E0 - 1][None])[0],
                                   st.sp, gumbel))
    state.ids[:P_exp].copy_(exp_ids)
    state.cur_len.fill_(E0)
    return hidden


def prefill(st: Statics, params: Dict, state: EngineState, ids: torch.Tensor,
            prompt_len: int, img_feats: Optional[torch.Tensor], img_pos: int,
            bonus_override: Optional[int] = None,
            rng: Optional[torch.Generator] = None):
    """Target + draft prefill over a padded prompt, into ``state``.

    ids: [P_pad] int32 on the device (IMAGE_TOKEN_INDEX at img_pos when an
    image is given); img_feats: [n_img, H] projected image rows.
    bonus_override: pin the first new token (e.g. to the AR prefill's).
    rng: the request's generator (sampling).
    """
    fused, exp_ids, img_rows = _fuse_prompt(st, params, ids, img_feats,
                                            img_pos)
    n_img = st.n_img if img_feats is not None else 0
    e0 = prompt_len + max(n_img - 1, 0)
    _prefill_core(st, params, state, fused, exp_ids, e0, img_rows, img_pos,
                  bonus_override, rng)


def _prefill_core(st: Statics, params: Dict, state: EngineState,
                  fused: torch.Tensor, exp_ids: torch.Tensor, E0: int,
                  img_rows: torch.Tensor, img_pos: int,
                  bonus_override: Optional[int] = None,
                  rng: Optional[torch.Generator] = None):
    dev = fused.device
    P_exp = fused.shape[0]
    dp = params["draft"]
    hidden = _target_prefill(st, params, state, fused, exp_ids, E0, rng)
    if st.collect_hiddens:
        _write(state.traj_hidden, hidden, 0)
    if bonus_override is not None and bonus_override >= 0:
        state.bonus.fill_(bonus_override)
    state.img_pos.fill_(img_pos)

    # draft prefill: row j pairs emb(token j+1) with the target hidden at j;
    # rows whose NEXT position is an image row take the fused image
    # embedding and bypass the fc
    j = torch.arange(P_exp, device=dev)
    zero_id = torch.zeros(1, dtype=exp_ids.dtype, device=dev)
    exp_shift = torch.cat([exp_ids[1:], zero_id])
    se = dp["embed_tokens"][torch.clamp(exp_shift, min=0).long()]
    img_next = torch.cat([img_rows[1:],
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    fused_shift = torch.cat([fused[1:], torch.zeros_like(fused[:1])])
    se = torch.where(img_next[:, None], fused_shift, se)
    se = torch.where((j == E0 - 1)[:, None],
                     dp["embed_tokens"][state.bonus.long().reshape(1)], se)
    dh_in = draft_mod.draft_fuse(dp, se, hidden, image_row_mask=img_next)
    positions = torch.arange(P_exp, device=dev, dtype=torch.int32)
    d_bias = causal_prefill_bias(P_exp, st.s_draft, device=dev)
    if st.need_attn:
        # the feature reads at most TOP_K rows of the prompt's attention
        # probabilities: only those are computed (at 7B width all P_exp
        # rows would be ~108 MB of fp32)
        valid_rows = torch.full((), P_exp, dtype=torch.int32, device=dev)
        d_out, _, attn_p = draft_mod.draft_forward(
            dp, st.dcfg, dh_in, positions, state.draft_kv, 0, d_bias,
            params["cos_t"], params["sin_t"], return_attn=True,
            attn_rows=_attn_rows(st, P_exp, valid_rows))
        state.attn_feat.copy_(_attn_feature_vec(st, attn_p, state.img_pos,
                                                valid_rows, P_exp))
    else:
        d_out, _ = draft_mod.draft_forward(dp, st.dcfg, dh_in, positions,
                                           state.draft_kv, 0, d_bias,
                                           params["cos_t"], params["sin_t"])
    state.last_draft_hidden.copy_(d_out[E0 - 1])
    state.draft_len.fill_(E0)


def decode_step(st: Statics, params: Dict, s: EngineState):
    """One verify step, in place: draft suffix -> draft tree (calibrated
    with ``st.use_calibration``) -> verify -> (``st.collect_calibration``:
    record the step's features) -> commit. Reads and writes only ``s`` and
    the weights, with no host sync and no host-to-device copy (what a
    CUDA-graph capture needs); a sampling step takes its draws from
    ``s.rand``."""
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    last_hidden = _draft_suffix_forward(st, params, s, cos_t, sin_t)
    s.draft_len.add_(s.suffix_len)
    s.last_draft_hidden.copy_(last_hidden)
    features = {} if st.collect_calibration else None
    tr = _draft_expand(st, params, s.last_draft_hidden, s.bonus, s.attn_feat,
                       features, s.draft_kv, s.draft_len)
    hidden, logits, best, acc_len, next_tok = _verify(st, params, s, tr,
                                                      cos_t, sin_t)
    if st.collect_calibration:
        _collect_step(st, s, tr, logits, best, acc_len, features)
    _commit(st, s, tr, hidden, best, acc_len, next_tok)


def decode(st: Statics, params: Dict, state: EngineState,
           step: Optional[Callable[[], None]] = None,
           rng: Optional[torch.Generator] = None):
    """The speculative decode loop: steps until ``done`` (EOS, max_new or
    the cache limit), reading ``done`` on the host once per step. ``step``
    runs one step over ``state`` (a graph replay); by default the eager
    ``decode_step``. When sampling, each step's draws come from ``rng``
    first (``draw``)."""
    step = step or functools.partial(decode_step, st, params, state)
    while not bool(state.done):
        if not st.sp.greedy:
            draw(state, rng)
        step()
    # surface the final pending token so hosts can read ids[:cur_len + 1]
    _write(state.ids, state.bonus[None], state.cur_len)


# ---------------------------------------------------------------------------
# Autoregressive baseline
# ---------------------------------------------------------------------------

def ar_prefill(st: Statics, params: Dict, state: EngineState,
               ids: torch.Tensor, prompt_len: int,
               img_feats: Optional[torch.Tensor], img_pos: int,
               rng: Optional[torch.Generator] = None):
    """Target-only prefill + first token, into ``state`` (its ids, target
    KV, cur_len and bonus)."""
    fused, exp_ids, _ = _fuse_prompt(st, params, ids, img_feats, img_pos)
    n_img = st.n_img if img_feats is not None else 0
    E0 = prompt_len + max(n_img - 1, 0)
    _target_prefill(st, params, state, fused, exp_ids, E0, rng)


def ar_step(st: Statics, params: Dict, s: EngineState):
    """One AR token, in place: the target forward of ``bonus`` at E (its
    one query row through the decode-attention kernel, kv_len = E + 1 on
    the device), the next token (greedy, or sampled with the repetition
    penalty over ids[:E + 1] and the Gumbel noise of ``s.rand``) into
    ``bonus`` and ids[E + 1], E advanced, ``done`` set on EOS or the cache
    limit. No host sync."""
    tp = params["target"]
    cur = s.cur_len
    kpos = torch.arange(st.s_target, device=cur.device)
    emb = tp["embed_tokens"][s.bonus.long().reshape(1)]
    bias = torch.where(kpos <= cur, 0.0, NEG_INF).to(torch.float32)[None]
    hidden, _ = L.llama_forward(tp, st.tcfg, emb, cur[None], s.target_kv,
                                cur, bias, params["cos_t"], params["sin_t"],
                                kv_len=cur + 1)
    logits = L.lm_head(tp, hidden)[0]
    gumbel = None
    if not st.sp.greedy:
        if st.sp.repetition_penalty != 1.0:
            logits = apply_repetition_penalty(logits, s.ids, cur + 1,
                                              st.sp.repetition_penalty)
        gumbel = _step_draws(st, s)[1]
    tok = sample_token(logits, st.sp, gumbel)
    s.cur_len.add_(1)
    _write(s.ids, tok[None], s.cur_len)
    s.bonus.copy_(tok)
    s.done.copy_((tok == st.eos_id) | (s.cur_len >= st.eng.max_seq_len - 2))


def ar_decode(st: Statics, params: Dict, state: EngineState,
              step: Optional[Callable[[], None]] = None,
              rng: Optional[torch.Generator] = None) -> int:
    """Plain AR decode from either prefill's state (after the MSD
    ``prefill`` the AR baseline and MSD start from the same KV cache and
    first token): write the pending first token at E, then one token per
    step until EOS, max_new (the first token counts as one; at least one
    step runs, as in the JAX while_loop) or the cache limit, reading
    ``done`` on the host once per step (not at all once max_new is
    reached). ``step`` runs one ``ar_step`` over ``state`` (a graph
    replay); by default eagerly; when sampling, each step's draws come
    from ``rng`` first. Returns the token count; the tokens are
    ids[E0 : cur_len + 1]."""
    _write(state.ids, state.bonus[None], state.cur_len)
    step = step or functools.partial(ar_step, st, params, state)
    n_new = 1
    while True:
        if not st.sp.greedy:
            draw(state, rng)
        step()
        n_new += 1
        if n_new >= st.max_new or bool(state.done):
            return n_new
