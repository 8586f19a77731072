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
"""

from __future__ import annotations

import torch

NEG_INF = -1e30  # finite large-negative: avoids NaN from (-inf) - (-inf)


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """qg [T, Hkv, G, D] x k [S, Hkv, D] -> [Hkv, G, T, S] fp32."""
    return torch.einsum("thgd,shd->hgts", qg.float(), k.float()) * scale


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p [Hkv, G, T, S] x v [S, Hkv, D] -> [T, Hkv, G, D] fp32, with p
    rounded to v's dtype first."""
    return torch.einsum("hgts,shd->thgd", p.to(v.dtype).float(), v.float())


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v per head. Returns [T, Hq, D] in
    q.dtype."""
    t, hq, d = q.shape
    s, hkv, _ = k.shape
    qg = q.reshape(t, hkv, hq // hkv, d)
    scores = _scores(qg, k, 1.0 / (d ** 0.5)) + bias.float()[None, None]
    probs = torch.softmax(scores, dim=-1)
    return _pv(probs, v).reshape(t, hq, d).to(q.dtype)


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
    once and the window rows are taken from it. Same rows, same bits.
    ``win_start`` is unused by the reduction (the bias encodes it); it is
    kept for API parity with the JAX function.
    """
    del win_start
    t, hq, d = q.shape
    s, hkv, _ = k.shape
    scale = 1.0 / (d ** 0.5)
    qg = q.reshape(t, hkv, hq // hkv, d)

    sc_c = _scores(qg, k, scale) + bias.float()[None, None]

    if compact:
        w = win_idx.shape[1]
        cw = min(s, t + w)
        cbase = torch.clamp(win_idx.min(), 0, s - cw)
        span = cbase + torch.arange(cw, device=k.device)
        kc = k.index_select(0, span)
        vc = v.index_select(0, span)
        loc = torch.clamp(win_idx - cbase, 0, cw - 1)
        kw, vw = kc[loc], vc[loc]                    # [T, W, Hkv, D]
    else:
        kw, vw = k[win_idx], v[win_idx]
    sc_w = torch.einsum("thgd,twhd->hgtw", qg.float(), kw.float()) * scale
    sc_w = sc_w + win_bias.float()[None, None]

    m = torch.maximum(sc_c.amax(dim=-1), sc_w.amax(dim=-1))
    m = torch.clamp(m, min=NEG_INF)[..., None]
    e_c = torch.exp(sc_c - m)                        # exact 0 where masked
    e_w = torch.exp(sc_w - m)
    denom = (e_c.sum(dim=-1) + e_w.sum(dim=-1))[..., None]
    p_c = e_c / denom
    p_w = e_w / denom

    out = _pv(p_c, v)
    out = out + torch.einsum("hgtw,twhd->thgd", p_w.to(v.dtype).float(),
                             vw.float())
    return out.reshape(t, hq, d).to(q.dtype)


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention probabilities (no value product): [Hq, T, S] fp32,
    scores accumulated in fp32 whatever the operand dtype.

    Used by the calibration feature path (visual-attention intensity over
    the image span; reference cnets.py:516-575 reads draft-layer
    attentions).
    """
    t, hq, d = q.shape
    s, hkv, _ = k.shape
    qg = q.reshape(t, hkv, hq // hkv, d)
    scores = _scores(qg, k, 1.0 / (d ** 0.5)) + bias.float()[None, None]
    return torch.softmax(scores, dim=-1).reshape(hq, t, s)


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
    ``tree_mask`` [N, N] bool."""
    n = tree_mask.shape[0]
    kpos = torch.arange(cache_len, device=tree_mask.device)[None, :]
    in_prefix = kpos < prefix_len
    rel = kpos - prefix_len
    rel_clamped = torch.clamp(rel, 0, n - 1).expand(n, cache_len)
    tree_vis = torch.gather(tree_mask, 1, rel_clamped)
    keep = in_prefix | ((rel >= 0) & (rel < n) & tree_vis)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)
