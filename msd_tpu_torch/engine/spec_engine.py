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
            ``lax.while_loop`` becomes a Python loop with one host sync per
            step, on ``done``.
  ar      : the AR baseline, one token per target forward, whose single
            query row goes to the CUDA decode-attention kernel.

Engine scalars (committed length E, lengths, counters) stay 0-dim device
tensors, as the traced scalars of the JAX programs, so the step issues no
host sync besides the ``done`` read. KV caches and the id buffer are updated
in place.

Conventions (post image expansion everywhere): E is the committed expanded
length (= target KV length); ``bonus`` is the sampled-but-uncommitted next
token at position E, root of the next tree; draft row j pairs emb(token at
j+1) with the target hidden at j.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

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
    ids: torch.Tensor            # [S_t] int32 expanded committed ids
    cur_len: torch.Tensor        # E
    bonus: torch.Tensor          # pending token at position E
    suffix_tokens: torch.Tensor  # [MAX_PATH] tokens of the next suffix rows
    suffix_hidden: torch.Tensor  # [MAX_PATH, H] target hidden of those rows
    suffix_len: torch.Tensor
    last_draft_hidden: torch.Tensor  # [H]
    target_kv: Dict
    draft_kv: Dict
    draft_len: torch.Tensor      # draft stable KV length
    new_tokens: torch.Tensor
    steps: torch.Tensor
    acc_sum: torch.Tensor        # sum of (accept_len + 1) over verify steps
    alpha_hist: torch.Tensor     # [16] histogram of tokens per step
    done: torch.Tensor


def _i32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=device)


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


def _draft_suffix_forward(st: Statics, params: Dict, dkv: Dict,
                          draft_len: torch.Tensor,
                          suffix_tokens: torch.Tensor,
                          suffix_hidden: torch.Tensor,
                          suffix_len: torch.Tensor,
                          last_hidden_prev: torch.Tensor, cos_t, sin_t):
    """Extend the draft stable KV with the accepted rows. Always runs
    MAX_PATH rows (suffix_len of them valid). Returns (last_hidden, dkv,
    new_draft_len)."""
    dp = params["draft"]
    P = st.tree.max_path_len
    dev = suffix_tokens.device
    emb = dp["embed_tokens"][torch.clamp(suffix_tokens, min=0).long()]
    hin = draft_mod.draft_fuse(dp, emb, suffix_hidden)
    pos = draft_len + torch.arange(P, device=dev, dtype=torch.int32)
    # causal over the growing prefix: row i sees cache slots [0, draft_len+i]
    kpos = torch.arange(st.s_draft, device=dev)[None, :]
    bias = torch.where(kpos <= pos[:, None], 0.0, NEG_INF).to(torch.float32)
    out, dkv = draft_mod.draft_forward(dp, st.dcfg, hin, pos, dkv, draft_len,
                                       bias, cos_t, sin_t)
    idx = torch.clamp(suffix_len - 1, min=0).reshape(1)
    last_hidden = torch.where(suffix_len > 0, out.index_select(0, idx)[0],
                              last_hidden_prev)
    return last_hidden, dkv, draft_len + suffix_len


# ---------------------------------------------------------------------------
# Target verification and commit
# ---------------------------------------------------------------------------

def _verify(st: Statics, params: Dict, target_kv: Dict, E: torch.Tensor,
            tr: Tree, cos_t, sin_t):
    """One target forward over every tree node + greedy acceptance."""
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
    hidden, target_kv = L.llama_forward(tp, st.tcfg, emb, pos, target_kv, E,
                                        bias, cos_t, sin_t,
                                        kv_len=E + st.tree.num_nodes, win=win)
    logits = L.lm_head(tp, hidden)                                   # [N, V]
    best, acc_len, next_tok = tree_mod.evaluate_greedy(
        tr, canon_logits(logits, st.sp.greedy_round_bits))
    return hidden, target_kv, best, acc_len, next_tok


def _commit(st: Statics, state: EngineState, tr: Tree, hidden: torch.Tensor,
            target_kv: Dict, best, acc_len, next_tok) -> EngineState:
    """Commit the accepted path: write its tokens into ids, gather its KV
    rows into the prefix rows [E, E+P), stage the next draft suffix."""
    P = st.tree.max_path_len
    E = state.cur_len
    dev = hidden.device
    path = tree_mod.accepted_path(tr, best).long()        # [P], -1 padded
    pc = torch.clamp(path, min=0)
    slot = torch.arange(P, device=dev)
    ct = torch.where(slot <= acc_len, tr.tokens[pc],
                     torch.zeros_like(tr.tokens[pc]))
    _write(state.ids, ct, E)

    # the source rows E + pc and the destination rows [E, E+P) overlap:
    # gather into a temporary first, then write
    src = E + pc
    for name in ("k", "v"):
        gathered = target_kv[name][:, src]               # [L, P, Hkv, D]
        _write(target_kv[name], gathered, E, dim=1)

    zero = torch.zeros_like(ct)
    ct_shift = torch.cat([ct[1:], zero[:1]])
    suffix_tokens = torch.where(slot < acc_len, ct_shift,
                                torch.where(slot == acc_len,
                                            next_tok.to(ct.dtype), zero))
    suffix_hidden = hidden[pc]
    n_new = (acc_len + 1).to(torch.int32)
    new_len = E + n_new
    eos_hit = torch.any((ct == st.eos_id) & (slot <= acc_len)) \
        | (next_tok == st.eos_id)
    new_tokens = state.new_tokens + n_new
    limit = st.eng.max_seq_len - st.tree.num_nodes - P - 2
    done = eos_hit | (new_tokens >= st.max_new) | (new_len >= limit)
    state.alpha_hist.index_add_(0, torch.clamp(n_new, max=15).reshape(1),
                                torch.ones_like(n_new).reshape(1))
    return state._replace(
        cur_len=new_len, bonus=next_tok.to(torch.int32),
        suffix_tokens=suffix_tokens, suffix_hidden=suffix_hidden,
        suffix_len=n_new, target_kv=target_kv, new_tokens=new_tokens,
        steps=state.steps + 1, acc_sum=state.acc_sum + n_new, done=done)


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


def prefill(st: Statics, params: Dict, ids: torch.Tensor, prompt_len: int,
            img_feats: Optional[torch.Tensor], img_pos: int,
            bonus_override: Optional[int] = None) -> EngineState:
    """Target + draft prefill over a padded prompt.

    ids: [P_pad] int32 on the device (IMAGE_TOKEN_INDEX at img_pos when an
    image is given); img_feats: [n_img, H] projected image rows.
    bonus_override: pin the first new token (e.g. to the AR prefill's).
    """
    fused, exp_ids, img_rows = _fuse_prompt(st, params, ids, img_feats,
                                            img_pos)
    n_img = st.n_img if img_feats is not None else 0
    e0 = prompt_len + max(n_img - 1, 0)
    return _prefill_core(st, params, fused, exp_ids, e0, img_rows,
                         bonus_override)


def _prefill_core(st: Statics, params: Dict, fused: torch.Tensor,
                  exp_ids: torch.Tensor, E0: int, img_rows: torch.Tensor,
                  bonus_override: Optional[int] = None) -> EngineState:
    tcfg, dcfg = st.tcfg, st.dcfg
    dev = fused.device
    P_exp = fused.shape[0]
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    tp, dp = params["target"], params["draft"]

    positions = torch.arange(P_exp, device=dev, dtype=torch.int32)
    bias = causal_prefill_bias(P_exp, st.s_target, device=dev)
    target_kv = L.init_kv_cache(tcfg, st.s_target, fused.dtype, dev)
    hidden, target_kv = L.llama_forward(tp, tcfg, fused, positions, target_kv,
                                        0, bias, cos_t, sin_t)
    last_logits = L.lm_head(tp, hidden[E0 - 1][None])[0]
    bonus = sample_token(last_logits, st.sp)
    if bonus_override is not None and bonus_override >= 0:
        bonus = _i32(bonus_override, dev)

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
                     dp["embed_tokens"][bonus.long().reshape(1)], se)
    dh_in = draft_mod.draft_fuse(dp, se, hidden, image_row_mask=img_next)
    d_bias = causal_prefill_bias(P_exp, st.s_draft, device=dev)
    draft_kv = draft_mod.init_draft_kv(dcfg, st.s_draft, fused.dtype, dev)
    d_out, draft_kv = draft_mod.draft_forward(dp, dcfg, dh_in, positions,
                                              draft_kv, 0, d_bias, cos_t,
                                              sin_t)

    P = st.tree.max_path_len
    ids_buf = torch.zeros(st.s_target, dtype=torch.int32, device=dev)
    ids_buf[:P_exp] = exp_ids
    e0 = _i32(E0, dev)
    return EngineState(
        ids=ids_buf, cur_len=e0, bonus=bonus,
        suffix_tokens=torch.zeros(P, dtype=torch.int32, device=dev),
        suffix_hidden=torch.zeros(P, hidden.shape[1], dtype=hidden.dtype,
                                  device=dev),
        suffix_len=_i32(0, dev), last_draft_hidden=d_out[E0 - 1],
        target_kv=target_kv, draft_kv=draft_kv, draft_len=e0.clone(),
        new_tokens=_i32(0, dev), steps=_i32(0, dev), acc_sum=_i32(0, dev),
        alpha_hist=torch.zeros(16, dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev))


def decode_step(st: Statics, params: Dict, s: EngineState) -> EngineState:
    """One verify step: draft suffix -> medusa tree -> verify -> commit."""
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    last_hidden, dkv, dlen = _draft_suffix_forward(
        st, params, s.draft_kv, s.draft_len, s.suffix_tokens,
        s.suffix_hidden, s.suffix_len, s.last_draft_hidden, cos_t, sin_t)
    tr = _draft_expand(st, params, last_hidden, s.bonus)
    hidden, tkv, best, acc_len, next_tok = _verify(
        st, params, s.target_kv, s.cur_len, tr, cos_t, sin_t)
    s = s._replace(draft_kv=dkv, draft_len=dlen, target_kv=tkv,
                   last_draft_hidden=last_hidden)
    return _commit(st, s, tr, hidden, tkv, best, acc_len, next_tok)


def decode(st: Statics, params: Dict, state: EngineState) -> EngineState:
    """The speculative decode loop: steps until ``done`` (EOS, max_new or
    the cache limit), reading ``done`` on the host once per step."""
    while not bool(state.done):
        state = decode_step(st, params, state)
    # surface the final pending token so hosts can read ids[:cur_len + 1]
    _write(state.ids, state.bonus[None], state.cur_len)
    return state


# ---------------------------------------------------------------------------
# Autoregressive baseline
# ---------------------------------------------------------------------------

def ar_prefill(st: Statics, params: Dict, ids: torch.Tensor, prompt_len: int,
               img_feats: Optional[torch.Tensor], img_pos: int):
    """Target-only prefill + first token. Returns the AR carry
    (ids_buf, target_kv, E0, first_token)."""
    fused, exp_ids, _ = _fuse_prompt(st, params, ids, img_feats, img_pos)
    n_img = st.n_img if img_feats is not None else 0
    E0 = prompt_len + max(n_img - 1, 0)
    dev = fused.device
    P_exp = fused.shape[0]
    positions = torch.arange(P_exp, device=dev, dtype=torch.int32)
    bias = causal_prefill_bias(P_exp, st.s_target, device=dev)
    target_kv = L.init_kv_cache(st.tcfg, st.s_target, fused.dtype, dev)
    hidden, target_kv = L.llama_forward(params["target"], st.tcfg, fused,
                                        positions, target_kv, 0, bias,
                                        params["cos_t"], params["sin_t"])
    logits = L.lm_head(params["target"], hidden[E0 - 1][None])[0]
    tok = sample_token(logits, st.sp)
    ids_buf = torch.zeros(st.s_target, dtype=torch.int32, device=dev)
    ids_buf[:P_exp] = exp_ids
    _write(ids_buf, tok[None], E0)
    return ids_buf, target_kv, _i32(E0, dev), tok


def ar_decode_from_state(st: Statics, params: Dict, state: EngineState):
    """AR decode from the MSD ``prefill``'s state: the AR baseline and MSD
    then start from the same KV cache and first token."""
    _write(state.ids, state.bonus[None], state.cur_len)
    return ar_decode(st, params, (state.ids, state.target_kv, state.cur_len,
                                  state.bonus))


def ar_decode(st: Statics, params: Dict, carry):
    """Plain AR decode: one target forward per token until EOS, max_new
    (the carried first token counts as one; at least one step runs, as in
    the JAX while_loop) or the cache limit. The one
    query row attends through the decode-attention kernel (kv_len = cur+1,
    a device tensor). Returns (ids_buf, cur, n_new); ids and KV are
    updated in place."""
    ids_buf, kv, cur, tok = carry
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    tp = params["target"]
    kpos = torch.arange(st.s_target, device=ids_buf.device)
    cur = cur.clone()
    n_new, done = 1, False
    while not done:
        emb = tp["embed_tokens"][tok.long().reshape(1)]
        bias = torch.where(kpos <= cur, 0.0, NEG_INF).to(torch.float32)[None]
        hidden, kv = L.llama_forward(tp, st.tcfg, emb, cur[None], kv, cur,
                                     bias, cos_t, sin_t, kv_len=cur + 1)
        tok = sample_token(L.lm_head(tp, hidden)[0], st.sp)
        cur = cur + 1
        _write(ids_buf, tok[None], cur)
        n_new += 1
        stop = (tok == st.eos_id) | (cur >= st.eng.max_seq_len - 2)
        done = n_new >= st.max_new or bool(stop)
    return ids_buf, cur, n_new
