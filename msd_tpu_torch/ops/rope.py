"""Rotary position embeddings (LLaMA rotate-half convention).

The cos/sin table is built once in fp32 and gathered by (possibly
tree-shaped) position ids, as in the JAX package's ``ops/rope.py``.
"""

from __future__ import annotations

import torch


def rope_table(max_pos: int, head_dim: int, theta: float = 10000.0,
               device="cuda"):
    """Returns (cos, sin), each [max_pos, head_dim] fp32 (half-duplicated)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    inv_freq = 1.0 / (theta ** exps)
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos_t: torch.Tensor,
               sin_t: torch.Tensor, positions: torch.Tensor):
    """q: [T, Hq, D], k: [T, Hkv, D], positions: [T] int. fp32 math, cast
    back to the input dtypes."""
    cos = cos_t[positions.long()][:, None, :]
    sin = sin_t[positions.long()][:, None, :]
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
