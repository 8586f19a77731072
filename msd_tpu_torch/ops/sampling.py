"""Token selection: canonical greedy argmax and sampling (temperature,
top-k, top-p, repetition penalty).

The port of the JAX package's ``ops/sampling.py``. Greedy decoding is
``temperature == 0``. ``jax.random.categorical`` is the argmax of the
logits plus Gumbel noise; here the caller passes that noise in
(``sample_token(..., gumbel)``), drawn from its own ``torch.Generator``
(``gumbel_noise``), so a step that samples draws nothing itself and can be
replayed as a CUDA graph over fresh draws.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0
    top_p: float = 1.0
    top_k: int = 0
    repetition_penalty: float = 1.0
    # Canonical greedy argmax: round logits to this many mantissa bits before
    # every greedy argmax (0 = off, exact fp32 argmax). See canon_logits.
    greedy_round_bits: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature < 1e-5


def process_logits(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """Apply temperature/top-k/top-p filtering to [..., V] fp32 logits."""
    if sp.greedy:
        return logits
    x = logits / sp.temperature
    if sp.top_k and sp.top_k > 0:
        kth = torch.sort(x, dim=-1).values[..., -sp.top_k, None]
        x = torch.where(x < kth, NEG_INF, x)
    if sp.top_p < 1.0:
        sorted_x = torch.sort(x, dim=-1, descending=True).values
        probs = torch.softmax(sorted_x, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until cumulative prob exceeds top_p (always keep top-1)
        keep_sorted = (cum - probs) < sp.top_p
        cutoff = keep_sorted.sum(dim=-1, keepdim=True)            # num kept
        kth = torch.gather(sorted_x, -1, torch.clamp(cutoff - 1, min=0))
        x = torch.where(x < kth, NEG_INF, x)
    return x


def apply_repetition_penalty(logits: torch.Tensor, ids_buf: torch.Tensor,
                             cur_len, penalty: float) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor over the committed context.

    logits: [..., V]; ids_buf: [S] committed token buffer; tokens at index
    >= cur_len (an int or a 0-dim device tensor) are ignored.
    """
    v = logits.shape[-1]
    s = ids_buf.shape[0]
    pos = torch.arange(s, device=ids_buf.device)
    safe = torch.where(pos < cur_len, ids_buf.long(), v)     # v = dropped
    present = torch.zeros(v + 1, dtype=torch.bool, device=logits.device)
    present = present.scatter_(0, safe, True)[:v]
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(present, pen, logits)


def canon_logits(logits: torch.Tensor, bits: int) -> torch.Tensor:
    """Round fp32 logits to ``bits`` mantissa bits (round to nearest even).

    Bitwise the same as JAX's ``lax.reduce_precision(x, exponent_bits=8,
    mantissa_bits=bits)`` on fp32: the exponent range is fp32's own, so only
    the mantissa is rounded, by the same integer arithmetic XLA emits. A
    carry out of the mantissa rounds up the exponent (the largest finite
    values round to inf), +-0, inf and subnormals go through the same
    arithmetic, and NaN passes through unchanged.

    Rounding to a grid much coarser than bf16 reduction noise makes the
    greedy argmax a function of (prefix, weights) alone, not of the program
    shape that computed the logits.
    """
    if not bits or bits >= 23:
        return logits
    if logits.dtype != torch.float32:
        raise TypeError(f"canon_logits takes fp32 logits, got {logits.dtype}")
    x = logits.contiguous()
    xi = x.view(torch.int32)
    shift = 23 - bits
    last_bit = (xi >> shift) & 1
    bias = last_bit + ((1 << (shift - 1)) - 1)
    rounded = ((xi + bias) & ~((1 << shift) - 1)).view(torch.float32)
    return torch.where(torch.isnan(x), x, rounded)


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel noise from uniforms in [0, 1): -log(-log(u)), with u
    raised to fp32's smallest normal as ``jax.random.gumbel`` bounds it."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def sample_token(logits: torch.Tensor, sp: SamplingParams,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., V] logits -> token id(s), int32. Greedy: the argmax of the
    canonically rounded logits, the lowest index winning a tie, as in
    ``jnp.argmax``. Sampling: the argmax of the processed logits plus the
    Gumbel noise ``gumbel`` [..., V] (``jax.random.categorical``)."""
    if sp.greedy:
        return torch.argmax(canon_logits(logits, sp.greedy_round_bits),
                            dim=-1).to(torch.int32)
    return torch.argmax(gumbel + process_logits(logits, sp),
                        dim=-1).to(torch.int32)
