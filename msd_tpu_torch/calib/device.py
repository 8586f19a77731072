"""Device-side calibrated reranking: table lookup + adaptive alpha.

The port of the JAX package's ``calib/device.py``: fixed-shape gathers over
the exported tables of a fitted ``GroupedIsotonicCalibrator``, which run
inside the captured verify step (no host sync, no upload). The percentiles
of ``adaptive_alpha`` sort the candidate batch and interpolate linearly at
static indices, the method of ``jnp.percentile``, so nothing is read back
to the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

MAX_CALIB_LOGIT = 3.0
PROB_FLOOR = 1e-3


class CalibTables(NamedTuple):
    """Device-resident export of a fitted GroupedIsotonicCalibrator."""

    table: torch.Tensor             # [3, 5, 2, 3, B] fp32
    attn_quantiles: torch.Tensor    # [4]
    margin_quantiles: torch.Tensor  # [2]
    global_mean: torch.Tensor       # scalar
    vocab_class: torch.Tensor       # [V] int64 token category table
    base_alpha: torch.Tensor        # scalar fusion strength

    @staticmethod
    def from_host(export: Dict, vocab_class, base_alpha: float = 1.0,
                  device="cuda") -> "CalibTables":
        def f32(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(device)

        return CalibTables(
            table=f32(export["table"]),
            attn_quantiles=f32(export["attn_quantiles"]),
            margin_quantiles=f32(export["margin_quantiles"]),
            global_mean=f32(export["global_mean"]),
            vocab_class=torch.from_numpy(
                np.asarray(vocab_class, np.int64)).to(device),
            base_alpha=f32(base_alpha))


def _bin(x: torch.Tensor, quantiles: torch.Tensor) -> torch.Tensor:
    """searchsorted(side='left'): count of quantiles strictly below x."""
    return (x[..., None] > quantiles).sum(dim=-1)


def _token_class(ct: CalibTables, token_ids: torch.Tensor) -> torch.Tensor:
    v = ct.vocab_class.shape[0]
    return ct.vocab_class[torch.clamp(token_ids.long(), 0, v - 1)]


def predict_proba(ct: CalibTables, token_ids: torch.Tensor,
                  conf: torch.Tensor, attn: torch.Tensor, depth: torch.Tensor,
                  margin: torch.Tensor) -> torch.Tensor:
    """Vectorized calibrated acceptance probability. All inputs same shape.

    conf: draft probability; attn: visual-attention intensity; depth: tree
    depth (1-based); margin: draft top1-top2 margin (per parent row).
    """
    t = _token_class(ct, token_ids)
    a = _bin(attn, ct.attn_quantiles)
    p = (depth > 2).long()
    m = _bin(margin, ct.margin_quantiles)

    B = ct.table.shape[-1]
    pos = torch.clamp(conf, 0.0, 1.0) * (B - 1)
    # a NaN conf converts to an arbitrary integer; the clamp keeps the
    # gather in bounds and the valid mask below replaces the result
    lo = torch.clamp(torch.floor(pos).long(), 0, B - 2)
    frac = pos - lo.float()
    v_lo = ct.table[t, a, p, m, lo]
    v_hi = ct.table[t, a, p, m, lo + 1]
    out = v_lo + frac * (v_hi - v_lo)

    valid = torch.isfinite(conf) & (conf >= 0.0) & (conf <= 1.0)
    return torch.where(valid, out, ct.global_mean)


def _percentile(x: torch.Tensor, pct: float) -> torch.Tensor:
    """``jnp.percentile(x, pct)`` of a 1-D fp32 tensor (linear method):
    sort, then interpolate between the two ranks around pct/100 * (n - 1),
    with the rank and weights computed in fp32 as JAX computes them; NaN
    if any element is NaN."""
    n = x.shape[0]
    q = np.float32(np.float32(pct) / np.float32(100.0)) * np.float32(n - 1)
    low, high = int(np.floor(q)), int(np.ceil(q))
    w_high = np.float32(q - np.float32(low))
    w_low = np.float32(1.0) - w_high
    xs = torch.sort(x).values
    out = xs[low] * float(w_low) + xs[high] * float(w_high)
    return torch.where(torch.isnan(x).any(), torch.nan, out)


def adaptive_alpha(ct: CalibTables, token_ids: torch.Tensor,
                   conf: torch.Tensor, attn: torch.Tensor,
                   depth: torch.Tensor, margin: torch.Tensor) -> torch.Tensor:
    """Per-candidate alpha (cnets.py:826-927 _compute_adaptive_alpha).

    Percentile normalization (10/90) is computed within the candidate batch
    (the inputs are 1-D), as the reference normalizes within each layer's
    data_list.
    """
    def pctl_norm(x):
        lo = _percentile(x, 10.0)
        hi = _percentile(x, 90.0)
        hi = torch.where(hi <= lo, x.max() + 1e-8, hi)
        lo = torch.where(hi <= lo, x.min(), lo)
        return torch.clamp((x - lo) / (hi - lo + 1e-8), 0.0, 1.0)

    margin_factor = 1.0 - pctl_norm(margin)
    depth_factor = torch.clamp(depth.float() / 6.0, 0.0, 1.0)
    attn_factor = 1.0 - pctl_norm(attn)

    t = _token_class(ct, token_ids)
    tok_boost = torch.where(t == 2, 1.40, 1.00)  # 'number' boost

    combo = 0.2 * margin_factor + 0.4 * depth_factor + 0.4 * attn_factor
    combo = torch.clamp(torch.clamp(combo * tok_boost, 0.0, 1.2), 0.2, 0.8)
    return ct.base_alpha * combo


def calibration_bias(ct: CalibTables, token_ids: torch.Tensor,
                     conf: torch.Tensor, attn: torch.Tensor,
                     depth: torch.Tensor, margin: torch.Tensor
                     ) -> torch.Tensor:
    """alpha * clip(logit(p_cal), +-3) — the additive logit correction
    (cnets.py:1294-1321)."""
    p = torch.clamp(predict_proba(ct, token_ids, conf, attn, depth, margin),
                    PROB_FLOOR, 1.0 - PROB_FLOOR)
    logit = torch.log(p) - torch.log1p(-p)
    logit = torch.clamp(logit, -MAX_CALIB_LOGIT, MAX_CALIB_LOGIT)
    alpha = adaptive_alpha(ct, token_ids, conf, attn, depth, margin)
    return alpha * logit
