"""Weight-only int8/int4 quantization (the JAX package's ``ops/quant.py``).

Symmetric per-output-channel integer weights, dequantized where they are
read: ``w ~= q * scale`` with ``scale = amax / qmax`` over the contraction
axis. int4 stores two nibbles per int8 byte, packed along the LAST axis of
the weight (whatever the contraction axis), sign-extended on unpacking.
The values are bitwise the JAX package's: ``torch.round`` rounds half to
even as ``jnp.round`` does, and the products are fp32.

Dequantization is stock torch, as it was an XLA fusion in JAX: the
dequantized weight is a bf16 temporary that the matmul then reads. Under
a CUDA graph the unpack runs at every replay by construction (JAX needed
an optimization barrier to keep it inside its decode loop).
"""

from __future__ import annotations

import torch

QMAX = {8: 127.0, 4: 7.0}


def quantize_tensor(w: torch.Tensor, axis: int, bits: int = 8):
    """Symmetric per-channel int8/int4 quantization.

    axis: the CONTRACTION axis of the matmul this weight feeds (amax is
    taken over it, keepdim, so ``dequantize`` broadcasts for any layout).
    bits=4 additionally packs value pairs along the last axis (which must
    be even-sized). Returns (w_q int8 [possibly packed], scale fp32 with a
    singleton contraction dim)."""
    qmax = QMAX[bits]
    w32 = w.float()
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    w_q = torch.clamp(torch.round(w32 / scale), -qmax, qmax).to(torch.int8)
    if bits == 4:
        w_q = pack_int4(w_q)
    return w_q, scale


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 values in [-7, 7] -> two per byte along the last axis."""
    lo, hi = q[..., 0::2], q[..., 1::2]
    return torch.bitwise_or(torch.bitwise_and(lo, 0x0F),
                            torch.bitwise_left_shift(hi, 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4: [..., N/2] int8 -> [..., N] int8 in [-7, 7]."""
    lo = torch.bitwise_right_shift(torch.bitwise_left_shift(packed, 4), 4)
    hi = torch.bitwise_right_shift(packed, 4)          # arithmetic shift
    out = torch.stack([lo, hi], dim=-1)
    return out.reshape(packed.shape[:-1] + (packed.shape[-1] * 2,))


def dequantize(w_q: torch.Tensor, scale: torch.Tensor,
               dtype=torch.bfloat16) -> torch.Tensor:
    """int8 * per-channel scale -> dtype, in one elementwise kernel: the
    product is computed in fp32 (the operands' common dtype) and rounded
    to ``dtype`` as it is written, so no fp32 copy of the weight is made."""
    out = torch.empty(w_q.shape, dtype=dtype, device=w_q.device)
    return torch.mul(w_q, scale, out=out)


def dequantize_int4(w_q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """Packed int4 -> dtype, unpacked at every use."""
    return dequantize(unpack_int4(w_q), scale, dtype)
