"""The MSD decode engine: greedy medusa speculative decoding and the AR
baseline.

The port of the JAX package's ``engine/spec_engine.py`` for the main path:

  prefill : fused multimodal embedding -> target prefill -> first token ->
            draft prefill (EAGLE shift-by-one pairing, image rows bypassing
            the fusion fc).
  decode  : a host loop over one verify step: extend the draft KV with the
            accepted rows, expand the static medusa tree, verify all nodes
            in one target forward with window-canonical attention, accept
            greedily, gather the accepted path's KV into place. The JAX
            ``lax.while_loop`` becomes a loop with one host read per step,
            of ``done``; on the card each step is one CUDA-graph replay
            (``engine/graphs.py``).
  ar      : the AR baseline, one token per target forward (``ar_step``),
            whose single query row goes to the CUDA decode-attention kernel.

All engine state lives in one ``EngineState`` of static buffers, allocated
once per generator (``alloc_state``) and updated IN PLACE: the prefills
zero and refill it, ``decode_step`` and ``ar_step`` read and write only its
tensors and the weights. Engine scalars (committed length E, lengths,
counters, the request's token limit) are 0-dim device tensors, as the
traced scalars of the JAX programs, so a step issues no host sync and no
host-to-device copy, and one captured step serves every request.

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

from msd_tpu_torch.configs import (DraftConfig, EngineConfig, LlamaConfig,
                                   TreeConfig)
from msd_tpu_torch.engine import tree as tree_mod
from msd_tpu_torch.engine.tree import Tree
from msd_tpu_torch.models import draft as draft_mod
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import expand_ids, fuse_embeddings
from msd_tpu_torch.ops.attention import NEG_INF, causal_prefill_bias
from msd_tpu_torch.ops.sampling import (SamplingParams, canon_logits,
                                        sample_token)


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


def alloc_state(st: Statics, dtype: torch.dtype, device) -> EngineState:
    """Zeroed static buffers for engines of ``st``'s capacity; hiddens and
    KV caches in ``dtype`` (the weights' dtype)."""
    P = st.tree.max_path_len

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
        done=scalar(torch.bool))


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
# Draft tree expansion (medusa heads, static layout)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _medusa_layout(t: TreeConfig, medusa_heads: int, device: str):
    """Static slot layout of the medusa tree, built once per (tree config,
    head count, device) with numpy as the JAX version builds it at trace
    time. Returns (d_use, W, parents, mask, positions, retrieve, valid,
    slot_depth, slot_rank) with the arrays as device tensors; slot s >= 1
    carries head (depth - 1)'s rank-``slot_rank`` candidate."""
    K, D, N = t.top_k, t.max_depth, t.num_nodes
    widths = list(t.medusa_widths) if t.medusa_widths is not None else [K] * D
    # fit the width plan into the node budget, shallow depths first; depth
    # d's candidates branch off depth d-1's rank-0 node (backbone chain)
    budget, fitted = N - 1, []
    for wd in widths[:min(D, 1 + medusa_heads)]:
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


def _top_k(x: torch.Tensor, k: int):
    """``lax.top_k`` along the last axis: descending, and the lower index
    first on ties (a stable sort; ``torch.topk`` promises no tie order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _draft_expand_medusa(st: Statics, params: Dict, last_hidden: torch.Tensor,
                         root_token: torch.Tensor) -> Tree:
    """Medusa expansion: depth-1 candidates from head(last_hidden), depth
    d >= 2 from resblock head d-2 over the same last_hidden, all through one
    stacked lm_head product. The tree layout is static (_medusa_layout);
    only the tokens are data."""
    d_use, w, par, mask, depth, ret, valid, slot_depth, slot_rank = \
        _medusa_layout(st.tree, st.dcfg.medusa_heads, str(last_hidden.device))
    dp = params["draft"]
    head = params["target"]["lm_head"]
    mh = draft_mod.medusa_hiddens(dp["medusa"], last_hidden)     # [Km, H]
    xs = torch.cat([last_hidden[None], mh[:d_use - 1]], dim=0)
    logits = (xs @ head).float()                                 # [d_use, V]
    probs = torch.softmax(logits, dim=-1)
    _, idx = _top_k(probs, w)                                    # [d_use, W]
    cand = idx[slot_depth, slot_rank].to(torch.int32)            # [N]
    tokens = torch.where(valid, cand, torch.full_like(cand, -1))
    tokens[0] = root_token
    return Tree(tokens=tokens, parents=par, mask=mask, positions=depth,
                retrieve=ret, valid=valid)


def _draft_expand(st: Statics, params: Dict, last_hidden: torch.Tensor,
                  root_token: torch.Tensor) -> Tree:
    if st.dcfg.medusa_heads <= 0:
        raise NotImplementedError(
            "the port drafts with medusa heads only (DraftConfig."
            "medusa_heads > 0); EAGLE recursion and static trees are not "
            "ported yet")
    return _draft_expand_medusa(st, params, last_hidden, root_token)


def _draft_suffix_forward(st: Statics, params: Dict, s: EngineState,
                          cos_t, sin_t) -> torch.Tensor:
    """Extend the draft stable KV (in place, at ``draft_len``) with the
    accepted rows. Always runs MAX_PATH rows (suffix_len of them valid).
    Returns the draft hidden of the last valid row (the previous one when
    no row is valid)."""
    dp = params["draft"]
    P = st.tree.max_path_len
    dev = s.suffix_tokens.device
    emb = dp["embed_tokens"][torch.clamp(s.suffix_tokens, min=0).long()]
    hin = draft_mod.draft_fuse(dp, emb, s.suffix_hidden)
    pos = s.draft_len + torch.arange(P, device=dev, dtype=torch.int32)
    # causal over the growing prefix: row i sees cache slots [0, draft_len+i]
    kpos = torch.arange(st.s_draft, device=dev)[None, :]
    bias = torch.where(kpos <= pos[:, None], 0.0, NEG_INF).to(torch.float32)
    out, _ = draft_mod.draft_forward(dp, st.dcfg, hin, pos, s.draft_kv,
                                     s.draft_len, bias, cos_t, sin_t)
    idx = torch.clamp(s.suffix_len - 1, min=0).reshape(1)
    return torch.where(s.suffix_len > 0, out.index_select(0, idx)[0],
                       s.last_draft_hidden)


# ---------------------------------------------------------------------------
# Target verification and commit
# ---------------------------------------------------------------------------

def _verify(st: Statics, params: Dict, target_kv: Dict, E: torch.Tensor,
            tr: Tree, cos_t, sin_t):
    """One target forward over every tree node (writing their KV rows at
    E in place) + greedy acceptance. Returns (hidden, best, accept_len,
    next_token)."""
    tp = params["target"]
    dev = tr.tokens.device
    emb = tp["embed_tokens"][torch.clamp(tr.tokens, min=0).long()]
    pos = E + tr.positions
    # window-canonical verification: node i's last W logical positions
    # (committed tail for l < E, tree ancestors/self for l >= E) reduce
    # through fixed window slots and the cache product sees only columns
    # below the window, so node i's logits are a function of its token and
    # logical prefix alone, whatever the draft proposed around it
    W = st.tree.max_path_len
    win_start = E + tr.positions - (W - 1)                           # [N]
    l = win_start[:, None] + torch.arange(W, device=dev)[None, :]    # [N, W]
    rel = l - E
    anc = torch.gather(tr.retrieve.long(), 1, torch.clamp(rel, 0, W - 1))
    row = torch.where(rel >= 0, E + torch.clamp(anc, min=0), l)
    win_idx = torch.clamp(row, 0, st.s_target - 1).long()
    win_bias = torch.where(l >= 0, 0.0, NEG_INF).to(torch.float32)
    cols = torch.arange(st.s_target, device=dev)[None, :]
    bias = torch.where(cols < win_start[:, None], 0.0,
                       NEG_INF).to(torch.float32)
    win = (win_idx, win_bias, win_start)
    hidden, _ = L.llama_forward(tp, st.tcfg, emb, pos, target_kv, E, bias,
                                cos_t, sin_t, kv_len=E + st.tree.num_nodes,
                                win=win)
    logits = L.lm_head(tp, hidden)                                   # [N, V]
    best, acc_len, next_tok = tree_mod.evaluate_greedy(
        tr, canon_logits(logits, st.sp.greedy_round_bits))
    return hidden, best, acc_len, next_tok


def _commit(st: Statics, s: EngineState, tr: Tree, hidden: torch.Tensor,
            best, acc_len, next_tok):
    """Commit the accepted path in place: write its tokens into ids, gather
    its KV rows into the prefix rows [E, E+P), stage the next draft suffix,
    advance the length and counters and set ``done``."""
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
    n_new = (acc_len + 1).to(torch.int32)
    eos_hit = torch.any((ct == st.eos_id) & (slot <= acc_len)) \
        | (next_tok == st.eos_id)
    limit = st.eng.max_seq_len - st.tree.num_nodes - P - 2
    # E is s.cur_len: every read of E comes before it advances
    s.cur_len.add_(n_new)
    s.new_tokens.add_(n_new)
    s.done.copy_(eos_hit | (s.new_tokens >= s.max_new)
                 | (s.cur_len >= limit))
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
                    fused: torch.Tensor, exp_ids: torch.Tensor, E0: int):
    """Reset the state, run the target over the prompt (its KV rows into
    ``target_kv``), commit the prompt ids and E0, and sample the first new
    token into ``bonus``. Returns the target hidden [P_exp, H]."""
    _reset(st, state)
    tp = params["target"]
    dev = fused.device
    P_exp = fused.shape[0]
    positions = torch.arange(P_exp, device=dev, dtype=torch.int32)
    bias = causal_prefill_bias(P_exp, st.s_target, device=dev)
    hidden, _ = L.llama_forward(tp, st.tcfg, fused, positions,
                                state.target_kv, 0, bias, params["cos_t"],
                                params["sin_t"])
    state.bonus.copy_(sample_token(L.lm_head(tp, hidden[E0 - 1][None])[0],
                                   st.sp))
    state.ids[:P_exp].copy_(exp_ids)
    state.cur_len.fill_(E0)
    return hidden


def prefill(st: Statics, params: Dict, state: EngineState, ids: torch.Tensor,
            prompt_len: int, img_feats: Optional[torch.Tensor], img_pos: int,
            bonus_override: Optional[int] = None):
    """Target + draft prefill over a padded prompt, into ``state``.

    ids: [P_pad] int32 on the device (IMAGE_TOKEN_INDEX at img_pos when an
    image is given); img_feats: [n_img, H] projected image rows.
    bonus_override: pin the first new token (e.g. to the AR prefill's).
    """
    fused, exp_ids, img_rows = _fuse_prompt(st, params, ids, img_feats,
                                            img_pos)
    n_img = st.n_img if img_feats is not None else 0
    e0 = prompt_len + max(n_img - 1, 0)
    _prefill_core(st, params, state, fused, exp_ids, e0, img_rows,
                  bonus_override)


def _prefill_core(st: Statics, params: Dict, state: EngineState,
                  fused: torch.Tensor, exp_ids: torch.Tensor, E0: int,
                  img_rows: torch.Tensor,
                  bonus_override: Optional[int] = None):
    dev = fused.device
    P_exp = fused.shape[0]
    dp = params["draft"]
    hidden = _target_prefill(st, params, state, fused, exp_ids, E0)
    if bonus_override is not None and bonus_override >= 0:
        state.bonus.fill_(bonus_override)

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
    d_out, _ = draft_mod.draft_forward(dp, st.dcfg, dh_in, positions,
                                       state.draft_kv, 0, d_bias,
                                       params["cos_t"], params["sin_t"])
    state.last_draft_hidden.copy_(d_out[E0 - 1])
    state.draft_len.fill_(E0)


def decode_step(st: Statics, params: Dict, s: EngineState):
    """One verify step, in place: draft suffix -> medusa tree -> verify ->
    commit. Reads and writes only ``s`` and the weights, with no host sync
    and no host-to-device copy (what a CUDA-graph capture needs)."""
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    last_hidden = _draft_suffix_forward(st, params, s, cos_t, sin_t)
    s.draft_len.add_(s.suffix_len)
    s.last_draft_hidden.copy_(last_hidden)
    tr = _draft_expand(st, params, s.last_draft_hidden, s.bonus)
    hidden, best, acc_len, next_tok = _verify(st, params, s.target_kv,
                                              s.cur_len, tr, cos_t, sin_t)
    _commit(st, s, tr, hidden, best, acc_len, next_tok)


def decode(st: Statics, params: Dict, state: EngineState,
           step: Optional[Callable[[], None]] = None):
    """The speculative decode loop: steps until ``done`` (EOS, max_new or
    the cache limit), reading ``done`` on the host once per step. ``step``
    runs one step over ``state`` (a graph replay); by default the eager
    ``decode_step``."""
    step = step or functools.partial(decode_step, st, params, state)
    while not bool(state.done):
        step()
    # surface the final pending token so hosts can read ids[:cur_len + 1]
    _write(state.ids, state.bonus[None], state.cur_len)


# ---------------------------------------------------------------------------
# Autoregressive baseline
# ---------------------------------------------------------------------------

def ar_prefill(st: Statics, params: Dict, state: EngineState,
               ids: torch.Tensor, prompt_len: int,
               img_feats: Optional[torch.Tensor], img_pos: int):
    """Target-only prefill + first token, into ``state`` (its ids, target
    KV, cur_len and bonus)."""
    fused, exp_ids, _ = _fuse_prompt(st, params, ids, img_feats, img_pos)
    n_img = st.n_img if img_feats is not None else 0
    E0 = prompt_len + max(n_img - 1, 0)
    _target_prefill(st, params, state, fused, exp_ids, E0)


def ar_step(st: Statics, params: Dict, s: EngineState):
    """One AR token, in place: the target forward of ``bonus`` at E (its
    one query row through the decode-attention kernel, kv_len = E + 1 on
    the device), the greedy next token into ``bonus`` and ids[E + 1], E
    advanced, ``done`` set on EOS or the cache limit. No host sync."""
    tp = params["target"]
    cur = s.cur_len
    kpos = torch.arange(st.s_target, device=cur.device)
    emb = tp["embed_tokens"][s.bonus.long().reshape(1)]
    bias = torch.where(kpos <= cur, 0.0, NEG_INF).to(torch.float32)[None]
    hidden, _ = L.llama_forward(tp, st.tcfg, emb, cur[None], s.target_kv,
                                cur, bias, params["cos_t"], params["sin_t"],
                                kv_len=cur + 1)
    tok = sample_token(L.lm_head(tp, hidden)[0], st.sp)
    s.cur_len.add_(1)
    _write(s.ids, tok[None], s.cur_len)
    s.bonus.copy_(tok)
    s.done.copy_((tok == st.eos_id) | (s.cur_len >= st.eng.max_seq_len - 2))


def ar_decode(st: Statics, params: Dict, state: EngineState,
              step: Optional[Callable[[], None]] = None) -> int:
    """Plain AR decode from either prefill's state (after the MSD
    ``prefill`` the AR baseline and MSD start from the same KV cache and
    first token): write the pending first token at E, then one token per
    step until EOS, max_new (the first token counts as one; at least one
    step runs, as in the JAX while_loop) or the cache limit, reading
    ``done`` on the host once per step (not at all once max_new is
    reached). ``step`` runs one ``ar_step`` over ``state`` (a graph
    replay); by default eagerly. Returns the token count; the tokens are
    ids[E0 : cur_len + 1]."""
    _write(state.ids, state.bonus[None], state.cur_len)
    step = step or functools.partial(ar_step, st, params, state)
    n_new = 1
    while True:
        step()
        n_new += 1
        if n_new >= st.max_new or bool(state.done):
            return n_new
