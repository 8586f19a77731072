"""Sequence parallelism for long-prompt prefill: the port of the JAX
package's ``parallel/sequence.py``.

The token axis is split over a ``seq`` mesh axis: each rank projects q/k/v
for its block of T/K rows, and attention and the MLP run on that block
alone. Causal attention needs every earlier row's K/V: ``mode="gather"``
all-gathers K and V per layer; ``mode="ring"`` passes K/V blocks around
the ring with flash-style fp32 accumulation (``_ring_attention``). The
hidden blocks are gathered at the end, so every rank returns the full
[T, H], bitwise the same.

Memory and traffic: ``comm`` builds ``all_gather`` and ``ppermute`` on an
all-reduce of a [K, Tk, Hkv, D] buffer, so each of them holds the whole
T rows of K (or V) on every rank and moves K blocks' bytes. ``gather``
makes one such collective for K and one for V per layer; ``ring`` makes
K - 1 of each, and so costs K - 1 times gather's traffic at the same
O(T) memory. Ring's O(T/K) memory, the reason to prefer it for long
contexts, needs a native send/recv ``ppermute`` (NCCL, one card per rank).
"""

from __future__ import annotations

from typing import Dict

import torch

from msd_tpu_torch.configs import LlamaConfig
from msd_tpu_torch.models.llama import _layer, _layer_post_attn, _layer_qkv
from msd_tpu_torch.ops.attention import masked_attention
from msd_tpu_torch.ops.norms import rms_norm
from msd_tpu_torch.parallel import comm
from msd_tpu_torch.parallel.comm import Mesh


def _ring_attention(q, k, v, bias_rows, sid: int, K: int, Tk: int,
                    mesh: Mesh, seq_axis: str, n_rep: int) -> torch.Tensor:
    """Blockwise ring attention: K/V blocks rotate around the ring while
    each rank accumulates flash-style (running max, rescaled sum): the
    scores stay [Tq, Hq, Tk] per round. Each rotation is a ``comm.
    ppermute``, whose all-reduce holds and moves all K blocks (module
    header). q [Tq, Hq, D]; k, v [Tk, Hkv, D]; bias_rows: this rank's
    [Tq, T] bias rows."""
    Tq, Hq, D = q.shape
    qf = q.float()
    m = torch.full((Tq, Hq, 1), float("-inf"), device=q.device)
    l = torch.zeros((Tq, Hq, 1), device=q.device)
    acc = torch.zeros((Tq, Hq, D), device=q.device)
    ring = [(i, (i + 1) % K) for i in range(K)]
    for r in range(K):
        src = (sid - r) % K           # whose block this rank holds now
        kb = k.float().repeat_interleave(n_rep, dim=1)      # GQA expand
        vb = v.float().repeat_interleave(n_rep, dim=1)
        bias_blk = bias_rows[:, src * Tk:(src + 1) * Tk].float()
        s = (torch.einsum("thd,shd->ths", qf, kb) * (D ** -0.5)
             + bias_blk[:, None, :])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        scale = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        acc = acc * scale + torch.einsum("ths,shd->thd", p, vb)
        l = l * scale + p.sum(dim=-1, keepdim=True)
        m = m_new
        if r + 1 < K:
            k = comm.ppermute(k, mesh, seq_axis, ring)
            v = comm.ppermute(v, mesh, seq_axis, ring)
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def sequence_parallel_forward(params: Dict, cfg: LlamaConfig,
                              embeds: torch.Tensor, bias: torch.Tensor,
                              cos_t, sin_t, mesh: Mesh,
                              seq_axis: str = "seq",
                              mode: str = "gather") -> torch.Tensor:
    """[T, H] prefill forward with T split over ``seq_axis``.

    embeds: [T, H] (T % K == 0; every rank passes them, each reads its
    block); bias: [T, T] (each rank takes its rows); params replicated.
    Returns the final-normed hidden [T, H] on every rank, the unsharded
    forward's."""
    if mode not in ("gather", "ring"):
        raise ValueError(f"mode {mode!r}: 'gather' or 'ring'")
    K, sid = mesh.shape[seq_axis], mesh.coords[seq_axis]
    T = embeds.shape[0]
    if T % K:
        raise ValueError(f"seq len {T} must divide shards {K}")
    Tk = T // K
    n_rep = cfg.num_attention_heads // cfg.num_key_value_heads
    rows = slice(sid * Tk, (sid + 1) * Tk)
    x_dtype = embeds.dtype
    h = embeds[rows]
    if cfg.residual_dtype is not None:
        h = h.to(getattr(torch, cfg.residual_dtype))
    positions = torch.arange(sid * Tk, (sid + 1) * Tk, dtype=torch.int32,
                             device=embeds.device)
    bias_local = bias[rows]
    layers = params["layers"]
    for li in range(layers["q_proj"].shape[0]):
        lp = _layer(layers, li)
        q, k, v = _layer_qkv(lp, cfg, h, positions, cos_t, sin_t, False)
        if mode == "ring":
            attn = _ring_attention(q, k, v, bias_local, sid, K, Tk, mesh,
                                   seq_axis, n_rep)
        else:
            attn = masked_attention(q, comm.all_gather(k, mesh, seq_axis),
                                    comm.all_gather(v, mesh, seq_axis),
                                    bias_local)
        h = _layer_post_attn(lp, cfg, h, attn)
    h = comm.all_gather(h, mesh, seq_axis)
    return rms_norm(h, params["norm"], cfg.rms_norm_eps).to(x_dtype)
