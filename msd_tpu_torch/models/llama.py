"""LLaMA decoder (target LM of LLaVA-1.5 and the draft's decoder layer).

The port of the JAX package's ``models/llama.py``: functions over a dict of
stacked per-layer weights, one token axis, and the same layouts. The
activations, positions, biases and caches may carry a leading lane
dimension B (the batched engine's requests, each with its own cache and
write position): every projection then reads its weight once for all
B x T rows.

- q/k/v projections ``[L, out, in]`` (applied as ``h @ W.T``, the JAX
  ``einsum("th,oh->to")``); o/gate/up/down ``[L, in, out]``;
  ``lm_head`` ``[H, V]``; ``embed_tokens`` ``[V, H]``.
- KV cache ``{"k", "v"}`` of ``[L, S, Hkv, D]`` (``[B, L, S, Hkv, D]``
  with lanes), seq-major.

Unlike JAX, the KV cache is updated IN PLACE: ``llama_forward`` writes the
new rows at ``write_pos`` into the caller's cache tensors and returns the
same dict. Matmuls run in the parameter dtype (bf16 at 7B); with
``cfg.residual_dtype="float32"`` the residual stream rides in fp32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import LlamaConfig
from msd_tpu_torch.ops.attention import (masked_attention, put_rows,
                                         windowed_attention)
from msd_tpu_torch.ops.decode_attention import (KERNEL_MAX_GT,
                                                decode_attention)
from msd_tpu_torch.ops.norms import rms_norm
from msd_tpu_torch.ops.rope import apply_rope, rope_table

Params = Dict

_STACKED = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
            "down_proj")


def init_layers(cfg: LlamaConfig, num_layers: int, generator: torch.Generator,
                device="cuda", dtype=torch.bfloat16) -> Params:
    """Stacked random decoder-layer weights, drawn straight in ``dtype`` on
    ``device`` (no host copy, no fp32 temporaries): normal * hidden^-0.5,
    norms at one."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hkv = cfg.num_key_value_heads * cfg.head_dim
    shapes = {"q_proj": (h, h), "k_proj": (hkv, h), "v_proj": (hkv, h),
              "o_proj": (h, h), "gate_proj": (h, inter),
              "up_proj": (h, inter), "down_proj": (inter, h)}
    layers = {
        "input_layernorm": torch.ones(num_layers, h, dtype=dtype,
                                      device=device),
        "post_attention_layernorm": torch.ones(num_layers, h, dtype=dtype,
                                               device=device),
    }
    for name in _STACKED:
        w = torch.randn((num_layers,) + shapes[name], generator=generator,
                        dtype=dtype, device=device)
        layers[name] = w.mul_(h ** -0.5)
    return layers


def init_llama_params(cfg: LlamaConfig, generator: torch.Generator,
                      device="cuda", dtype=torch.bfloat16) -> Params:
    """Random target weights from ``generator`` (the port's counterpart of
    the JAX ``init_llama_params_stacked``, with torch's random stream)."""
    h = cfg.hidden_size
    scale = h ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(scale)

    return {
        "embed_tokens": normal(cfg.vocab_size, h),
        "layers": init_layers(cfg, cfg.num_hidden_layers, generator, device,
                              dtype),
        "norm": torch.ones(h, dtype=dtype, device=device),
        "lm_head": normal(h, cfg.vocab_size),
    }


def init_kv_cache(cfg: LlamaConfig, max_seq_len: int, dtype=torch.float32,
                  device="cuda", num_layers: int | None = None) -> Params:
    nl = cfg.num_hidden_layers if num_layers is None else num_layers
    shape = (nl, max_seq_len, cfg.num_key_value_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def update_rows(size: int, start, n: int, device) -> torch.Tensor:
    """Row indices [start, start + n) for an update of n rows into a buffer
    of ``size`` rows, with the start clamped into [0, size - n] as
    ``lax.dynamic_update_slice`` clamps it. ``start`` may be an int, a
    0-dim device tensor (no host sync; rows [n]) or one start per lane
    ([B] -> rows [B, n])."""
    rows = torch.arange(n, device=device)
    if isinstance(start, torch.Tensor):
        return rows + torch.clamp(start.long(), 0, size - n)[..., None]
    return rows + min(max(int(start), 0), size - n)


def _layer(lp_all: Params, li: int) -> Params:
    return {name: w[li] for name, w in lp_all.items()}


def _layer_qkv(lp: Params, cfg: LlamaConfig, x: torch.Tensor,
               positions: torch.Tensor, cos_t, sin_t, skip_input_norm: bool):
    """Pre-attention projections. Returns (q, k, v) as [..., T, H*, D]."""
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    # the draft's layer 0 skips input_layernorm (EAGLE convention)
    h = x if skip_input_norm else rms_norm(x, lp["input_layernorm"],
                                           cfg.rms_norm_eps)
    # matmuls in the param dtype even when the residual rides in fp32
    h = h.to(lp["input_layernorm"].dtype)
    q = (h @ lp["q_proj"].T).unflatten(-1, (hq, d))
    k = (h @ lp["k_proj"].T).unflatten(-1, (hkv, d))
    v = (h @ lp["v_proj"].T).unflatten(-1, (hkv, d))
    q, k = apply_rope(q, k, cos_t, sin_t, positions)
    return q, k, v


def _layer_post_attn(lp: Params, cfg: LlamaConfig, resid: torch.Tensor,
                     attn: torch.Tensor) -> torch.Tensor:
    x = resid + (attn.flatten(-2) @ lp["o_proj"]).to(resid.dtype)
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    h = h.to(lp["post_attention_layernorm"].dtype)
    gate = F.silu((h @ lp["gate_proj"]).float()).to(h.dtype)
    up = h @ lp["up_proj"]
    return x + ((gate * up) @ lp["down_proj"]).to(resid.dtype)


def _attend(cfg: LlamaConfig, q, kv_k, kv_v, bias, kv_len, win=None):
    """Attention routing.

    - ``win`` given (tree verification): window-canonical attention, so the
      committed trajectory is draft-invariant.
    - ``kv_len`` given and at most KERNEL_MAX_GT grouped query rows
      (G * T; the AR decode row): the decode-attention kernel K1 (its
      plain twin for CPU tensors). On the card a call the kernel does not
      take (head_dim other than 128, another dtype) raises there; nothing
      falls back. This is the JAX "auto" rule without its TPU
      cache-length threshold. With lanes, one call per lane.
    - otherwise (prefill, draft): masked attention.
    """
    if win is not None:
        return windowed_attention(q, kv_k, kv_v, bias, *win, compact=True)
    gt = q.shape[-3] * (cfg.num_attention_heads // cfg.num_key_value_heads)
    if kv_len is not None and gt <= KERNEL_MAX_GT:
        if q.dim() == 3:
            return decode_attention(q, kv_k, kv_v, bias, kv_len)
        return torch.stack([
            decode_attention(q[b], kv_k[b], kv_v[b], bias[b], kv_len[b])
            for b in range(q.shape[0])])
    return masked_attention(q, kv_k, kv_v, bias)


def _layer_forward(lp: Params, cfg: LlamaConfig, x: torch.Tensor,
                   positions: torch.Tensor, kv_k: torch.Tensor,
                   kv_v: torch.Tensor, write_pos, bias: torch.Tensor,
                   cos_t, sin_t, skip_input_norm: bool = False,
                   kv_len=None, win=None) -> torch.Tensor:
    """One decoder layer over x [..., T, H]; writes its K/V rows into
    kv_k/kv_v [..., S, Hkv, D] at write_pos (an int, a 0-dim tensor or one
    start per lane) in place. Returns the new x."""
    q, k, v = _layer_qkv(lp, cfg, x, positions, cos_t, sin_t,
                         skip_input_norm)
    lanes = x.dim() - 2
    rows = update_rows(kv_k.shape[-3], write_pos, x.shape[-2], x.device)
    if rows.dim() == 1:     # the same rows in every lane
        kv_k.index_copy_(lanes, rows, k)
        kv_v.index_copy_(lanes, rows, v)
    else:
        put_rows(kv_k, rows, k, lanes)
        put_rows(kv_v, rows, v, lanes)
    attn = _attend(cfg, q, kv_k, kv_v, bias, kv_len, win)
    return _layer_post_attn(lp, cfg, x, attn)


def llama_forward(params: Params, cfg: LlamaConfig, embeds: torch.Tensor,
                  positions: torch.Tensor, kv: Params, write_pos,
                  bias: torch.Tensor, cos_t: torch.Tensor,
                  sin_t: torch.Tensor, kv_len=None,
                  win=None) -> Tuple[torch.Tensor, Params]:
    """All decoder layers over embeds [T, H] at positions [T].

    kv: {'k','v'} [L, S, Hkv, D]; bias [T, S]; write_pos: int or 0-dim
    tensor. Each layer writes its new K/V rows into ``kv`` at write_pos IN
    PLACE (the JAX version returns an updated copy); the returned dict is
    ``kv`` itself. Returns (final-normed hidden [T, H] in embeds.dtype, kv).
    With lanes: embeds [B, T, H], positions [B, T], kv [B, L, S, Hkv, D],
    bias [B, T, S], write_pos and kv_len [B] (or an int), win's arrays
    with a leading B.
    """
    out_dtype = embeds.dtype
    x = embeds
    if cfg.residual_dtype is not None:
        x = x.to(getattr(torch, cfg.residual_dtype))
    layers = params["layers"]
    for li in range(layers["q_proj"].shape[0]):
        x = _layer_forward(_layer(layers, li), cfg, x, positions,
                           kv["k"].select(-4, li), kv["v"].select(-4, li),
                           write_pos, bias, cos_t,
                           sin_t, kv_len=kv_len, win=win)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps).to(out_dtype)
    return x, kv


def lm_head(params: Params, hidden: torch.Tensor) -> torch.Tensor:
    """[T, H] -> [T, V] logits in fp32."""
    return (hidden @ params["lm_head"]).float()


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids.long()]


def make_rope(cfg: LlamaConfig, max_seq_len: int, device="cuda"):
    return rope_table(max_seq_len, cfg.head_dim, cfg.rope_theta, device)
