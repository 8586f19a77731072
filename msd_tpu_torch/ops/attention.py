"""Attention over a preallocated seq-major KV cache with an additive bias.

One routine serves prefill, tree verification and the draft; only the bias
differs (the JAX package's ``ops/attention.py``). Scores and the value
product accumulate in fp32, as the JAX einsums do with
``preferred_element_type=float32``: the inputs are widened to fp32 before
each product, so bf16 operands multiply exactly and sum in fp32. The
probabilities are cast to the value dtype before the value product, as in
JAX.

Layouts: q [T, Hq, D]; k, v [S, Hkv, D]; bias [T, S] fp32 (0 or NEG_INF).
GQA regroups queries as [T, Hkv, G, D], query head = kv head * G + g.
Every function also takes a leading lane dimension on all of its tensors
(q [B, T, Hq, D], k [B, S, Hkv, D], ...): the batched engine's B requests,
each attending over its own cache, in one batched product.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite large-negative: avoids NaN from (-inf) - (-inf)


def _lane_rows(x: torch.Tensor, idx: torch.Tensor):
    """(x's rows as one [rows, ...] view, idx as indices into it) for x
    [B, S, ...] and per-lane row indices idx [B, *I]: a lane's rows start
    a whole number of rows after the previous lane's (a lane of a layer of
    a [B, L, S, ...] cache lies L*S rows on), so one 1-D gather or copy
    serves every lane. None when the strides do not allow it."""
    b, s = x.shape[:2]
    lane, row = x.stride(0), x.stride(1)
    if row == 0 or lane % row:
        return None
    step = lane // row
    rows = x.as_strided(((b - 1) * step + s,) + x.shape[2:],
                        (row,) + x.stride()[2:])
    if b > 1 and step:
        offset = torch.arange(0, b * step, step, device=x.device)
        idx = idx + offset.view((-1,) + (1,) * (idx.dim() - 1))
    return rows, idx


def take_rows(x: torch.Tensor, idx: torch.Tensor, lanes: int) -> torch.Tensor:
    """Rows ``idx`` of ``x`` along dim ``lanes``, each lane its own: x
    [S, ...] or [B, S, ...], idx [*I] or [B, *I] -> [*I, ...] or
    [B, *I, ...] (``lanes`` is 0 or 1). One ``index_select`` over all the
    lanes' rows where the strides allow it (the vectorized gather, not the
    general two-index kernel)."""
    flat = _lane_rows(x, idx) if lanes else (x, idx)
    if flat is None:
        b = torch.arange(x.shape[0], device=x.device)
        return x[b.view((-1,) + (1,) * (idx.dim() - 1)), idx]
    rows, idx = flat
    return rows.index_select(0, idx.reshape(-1)).view(
        idx.shape + rows.shape[1:])


def put_rows(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
             lanes: int) -> None:
    """In place: rows ``idx`` of ``x`` along dim ``lanes`` (distinct within
    a lane) take ``val``, the inverse of ``take_rows``."""
    flat = _lane_rows(x, idx) if lanes else (x, idx)
    if flat is None:
        b = torch.arange(x.shape[0], device=x.device)
        x[b.view((-1,) + (1,) * (idx.dim() - 1)), idx] = val
        return
    rows, idx = flat
    rows.index_copy_(0, idx.reshape(-1), val.reshape((-1,) + rows.shape[1:]))


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """qg [..., T, Hkv, G, D] x k [..., S, Hkv, D] -> [..., Hkv, G, T, S]
    fp32."""
    return torch.einsum("...thgd,...shd->...hgts", qg.float(),
                        k.float()) * scale


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """[..., T, Hq, D] -> [..., T, Hkv, G, D]."""
    return q.unflatten(-2, (hkv, q.shape[-2] // hkv))


def _heads_bias(bias: torch.Tensor) -> torch.Tensor:
    """[..., T, S] -> [..., 1, 1, T, S] fp32, broadcast over the heads."""
    return bias.float().unsqueeze(-3).unsqueeze(-3)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [..., Hkv, G, T, S] x v [..., S, Hkv, D] -> [..., T, Hkv, G, D]
    fp32, with p rounded to v's dtype first."""
    return torch.einsum("...hgts,...shd->...thgd", p.to(v.dtype).float(),
                        v.float())


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v per head. Returns [T, Hq, D] in
    q.dtype."""
    d, hkv = q.shape[-1], k.shape[-2]
    scores = _scores(_group(q, hkv), k, 1.0 / (d ** 0.5)) + _heads_bias(bias)
    probs = torch.softmax(scores, dim=-1)
    return _pv(probs, v).flatten(-3, -2).to(q.dtype)


def windowed_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor, win_idx: torch.Tensor,
                       win_bias: torch.Tensor, win_start: torch.Tensor,
                       compact: bool = False) -> torch.Tensor:
    """Window-canonical attention: layout-invariant tree verification.

    Row i reduces its last W logical positions through fixed window slots
    (``win_idx`` [T, W] cache rows, ``win_bias`` [T, W]) and everything
    below the window through the bias-masked cache product (``bias`` must
    mask every column >= win_start[i]). Each row's floating-point
    association then depends only on its logical prefix, so a committed
    greedy trajectory is bitwise invariant to the draft that proposed it.

    compact=True: every window row lies inside one [T + W]-row span of the
    cache (the engine's verify path keeps it so), so that span is sliced
    once and the window rows are taken from it. Same rows, same bits. With
    lanes each lane slices its own span.
    ``win_start`` is unused by the reduction (the bias encodes it); it is
    kept for API parity with the JAX function.
    """
    del win_start
    t, d = q.shape[-3], q.shape[-1]
    s, hkv = k.shape[-3], k.shape[-2]
    lanes = q.dim() - 3
    scale = 1.0 / (d ** 0.5)
    qg = _group(q, hkv)

    sc_c = _scores(qg, k, scale) + _heads_bias(bias)

    if compact:
        w = win_idx.shape[-1]
        cw = min(s, t + w)
        cbase = torch.clamp(win_idx.amin(dim=(-2, -1)), 0, s - cw)
        span = cbase[..., None] + torch.arange(cw, device=k.device)
        kc, vc = take_rows(k, span, lanes), take_rows(v, span, lanes)
        loc = torch.clamp(win_idx - cbase[..., None, None], 0, cw - 1)
        kw, vw = take_rows(kc, loc, lanes), take_rows(vc, loc, lanes)
    else:
        kw, vw = take_rows(k, win_idx, lanes), take_rows(v, win_idx, lanes)
    # kw, vw: [..., T, W, Hkv, D]
    sc_w = torch.einsum("...thgd,...twhd->...hgtw", qg.float(),
                        kw.float()) * scale
    sc_w = sc_w + _heads_bias(win_bias)

    m = torch.maximum(sc_c.amax(dim=-1), sc_w.amax(dim=-1))
    m = torch.clamp(m, min=NEG_INF)[..., None]
    e_c = torch.exp(sc_c - m)                        # exact 0 where masked
    e_w = torch.exp(sc_w - m)
    denom = (e_c.sum(dim=-1) + e_w.sum(dim=-1))[..., None]
    p_c = e_c / denom
    p_w = e_w / denom

    out = _pv(p_c, v)
    out = out + torch.einsum("...hgtw,...twhd->...thgd",
                             p_w.to(v.dtype).float(), vw.float())
    return out.flatten(-3, -2).to(q.dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention probabilities (no value product): [..., Hq, T, S]
    fp32, scores accumulated in fp32 whatever the operand dtype.

    Used by the calibration feature path (visual-attention intensity over
    the image span; reference cnets.py:516-575 reads draft-layer
    attentions).
    """
    d, hkv = q.shape[-1], k.shape[-2]
    scores = _scores(_group(q, hkv), k, 1.0 / (d ** 0.5)) + _heads_bias(bias)
    return torch.softmax(scores, dim=-1).flatten(-4, -3)


def length_mask_bias(positions_k: torch.Tensor, valid_len,
                     num_q: int) -> torch.Tensor:
    """Bias [num_q, S] admitting keys with index < valid_len."""
    keep = positions_k < valid_len
    row = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    return row[None, :].expand(num_q, -1).contiguous()


def causal_prefill_bias(seq_len: int, cache_len: int, start: int = 0,
                        device="cuda") -> torch.Tensor:
    """Bias [seq_len, cache_len] for a prefill written at
    [start, start + seq_len)."""
    qpos = start + torch.arange(seq_len, device=device)[:, None]
    kpos = torch.arange(cache_len, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, NEG_INF).to(torch.float32)


def tree_bias(tree_mask: torch.Tensor, prefix_len,
              cache_len: int) -> torch.Tensor:
    """Bias [N, cache_len] for tree verification: key j is visible to node
    i iff j < prefix_len, or j - prefix_len is an ancestor-or-self of i in
    ``tree_mask`` [N, N] bool. With lanes: tree_mask [B, N, N] and
    prefix_len [B] give [B, N, cache_len]. ``prefix_len`` is an int or a
    tensor on the mask's device (read there: no host sync)."""
    n = tree_mask.shape[-1]
    kpos = torch.arange(cache_len, device=tree_mask.device)
    if isinstance(prefix_len, torch.Tensor):
        prefix_len = prefix_len[..., None, None]
    rel = kpos - prefix_len                                  # [..., 1, S]
    rel_clamped = torch.clamp(rel, 0, n - 1).expand(
        tree_mask.shape[:-1] + (cache_len,))
    tree_vis = torch.gather(tree_mask, -1, rel_clamped)
    keep = (rel < 0) | ((rel < n) & tree_vis)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)
