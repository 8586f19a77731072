"""GPipe pipeline parallelism for the stacked decoder forward: the port of
the JAX package's ``parallel/pipeline.py``.

The layer axis of the stacked weights is split over a ``stage`` mesh axis
(``shard_layers_for_pipeline``: each rank keeps its L/S contiguous
layers) and microbatch activations pass from stage to stage around the
ring by ``comm.ppermute``. Microbatch j runs on stage s at tick t = j + s;
a stage with no microbatch at a tick (warm-up, drain) skips its forward
and passes zeros on. The last stage's outputs are broadcast to every rank
(JAX's masked psum, ``comm.broadcast``), so every rank returns the full
result, bitwise the same.

Traffic: each tick's ``comm.ppermute`` is an all-reduce of an [S, T, H]
buffer (``comm``), so every stage holds and moves S activations per tick
where a send/recv would move one.

For the throughput-bound forwards (prefill, teacher forwards); the
latency-bound decode uses tensor parallelism (``sharding``).
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


def _local_forward(local_layers: Dict, cfg: LlamaConfig, x: torch.Tensor,
                   positions: torch.Tensor, bias: torch.Tensor,
                   cos_t, sin_t) -> torch.Tensor:
    """This stage's stacked layers over x [T, H] (no KV cache)."""
    for li in range(local_layers["q_proj"].shape[0]):
        lp = _layer(local_layers, li)
        q, k, v = _layer_qkv(lp, cfg, x, positions, cos_t, sin_t, False)
        x = _layer_post_attn(lp, cfg, x, masked_attention(q, k, v, bias))
    return x


def shard_layers_for_pipeline(params: Dict, mesh: Mesh,
                              stage_axis: str = "stage") -> Dict:
    """``params`` with its stacked layers cut to this rank's L/S
    contiguous layers (fresh tensors); embed, norm and head as they are
    (replicated)."""
    S, sid = mesh.shape[stage_axis], mesh.coords[stage_axis]
    L = params["layers"]["q_proj"].shape[0]
    if L % S:
        raise ValueError(f"layers {L} must divide stages {S}")
    n = L // S
    out = dict(params)
    out["layers"] = {k: w[sid * n:(sid + 1) * n].clone()
                     for k, w in params["layers"].items()}
    return out


def pipeline_forward(params: Dict, cfg: LlamaConfig, embeds: torch.Tensor,
                     bias: torch.Tensor, cos_t, sin_t, mesh: Mesh,
                     stage_axis: str = "stage") -> torch.Tensor:
    """Pipelined decoder forward over microbatches.

    embeds: [M, T, H] microbatches (every rank passes them; stage 0 reads
    them); bias: [T, T] shared attention bias; ``params`` from
    ``shard_layers_for_pipeline``. Returns the final-normed hidden
    [M, T, H] on every rank, the unpipelined forward's."""
    S, sid = mesh.shape[stage_axis], mesh.coords[stage_axis]
    M, T, H = embeds.shape
    x_dtype = embeds.dtype
    if cfg.residual_dtype is not None:
        embeds = embeds.to(getattr(torch, cfg.residual_dtype))
    positions = torch.arange(T, dtype=torch.int32, device=embeds.device)
    ring = [(i, (i + 1) % S) for i in range(S)]
    carry = torch.zeros_like(embeds[0])
    outs = torch.zeros_like(embeds)
    for t in range(M + S - 1):
        j = t - sid                       # this stage's microbatch
        if 0 <= j < M:
            x = embeds[j] if sid == 0 else carry
            y = _local_forward(params["layers"], cfg, x, positions, bias,
                               cos_t, sin_t)
            if sid == S - 1:
                outs[j] = y
        else:
            y = torch.zeros_like(carry)
        carry = comm.ppermute(y, mesh, stage_axis, ring)
    outs = comm.broadcast(outs, mesh, stage_axis, S - 1)
    return rms_norm(outs, params["norm"], cfg.rms_norm_eps).to(x_dtype)
