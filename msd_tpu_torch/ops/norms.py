"""Normalization ops. fp32 moments regardless of activation dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """LLaMA RMSNorm: x * rsqrt(mean(x^2) + eps) * w, moments in fp32."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Standard LayerNorm (CLIP tower), fp32 moments, as the JAX package's
    ``layer_norm`` computes it."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    xf = (xf - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * weight.float() + bias.float()).to(x.dtype)
