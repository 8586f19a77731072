"""Greedy token selection with canonical logit rounding.

The port's counterpart of the JAX package's ``ops/sampling.py`` for greedy
decoding. Sampling mode (temperature, top-k, top-p, speculative sampling)
comes with a later slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplingParams:
    # Canonical greedy argmax: round logits to this many mantissa bits before
    # every greedy argmax (0 = off, exact fp32 argmax). See canon_logits.
    greedy_round_bits: int = 0


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


def sample_token(logits: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """[..., V] logits -> greedy token id(s), int32. The lowest index wins
    a tie, as in ``jnp.argmax``."""
    return torch.argmax(canon_logits(logits, sp.greedy_round_bits),
                        dim=-1).to(torch.int32)
