"""EAGLE-style MSD draft head: embed + fc([emb, hidden]) + one decoder
layer, plus medusa resblock heads.

The port of the JAX package's ``models/draft.py``. The draft input at
expanded position j pairs the embedding of the NEXT token with the target
hidden at j; rows inside the image span bypass fc and carry the shifted
fused image embedding directly. Layouts: ``fc_w`` [2H, H], ``fc_b`` [H],
``layers`` stacked as in ``models/llama``, medusa ``mw`` [K, H, H] and
``mb`` [K, H].
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import DraftConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.attention import (attention_probs, masked_attention,
                                         put_rows, take_rows)
from msd_tpu_torch.ops.rope import apply_rope

Params = Dict


def init_draft_params(cfg: DraftConfig, generator: torch.Generator,
                      device="cuda", dtype=torch.bfloat16) -> Params:
    """Random draft weights from ``generator``."""
    tc = cfg.text
    h = tc.hidden_size
    p = {
        "embed_tokens": torch.randn(tc.vocab_size, h, generator=generator,
                                    dtype=dtype, device=device)
        .mul_(h ** -0.5),
        "fc_w": torch.randn(2 * h, h, generator=generator, dtype=dtype,
                            device=device).mul_((2 * h) ** -0.5),
        "layers": L.init_layers(tc, cfg.num_layers, generator, device, dtype),
        "fc_b": torch.zeros(h, dtype=dtype, device=device),
    }
    return p


def init_medusa_params(cfg: DraftConfig, generator: torch.Generator,
                       device="cuda", dtype=torch.bfloat16) -> Params:
    """Per-depth residual-block heads: head k predicts the token k+2 steps
    ahead of the current position."""
    h, k = cfg.text.hidden_size, cfg.medusa_heads
    return {
        "mw": torch.randn(k, h, h, generator=generator, dtype=dtype,
                          device=device).mul_(h ** -0.5 * 0.1),
        "mb": torch.zeros(k, h, dtype=dtype, device=device),
    }


def medusa_hiddens(mp: Params, x: torch.Tensor) -> torch.Tensor:
    """x: [..., H] depth-1 draft hidden -> [K, ..., H] per-depth hiddens,
    h_k = x + silu(x @ mw[k] + mb[k]). All K heads read the same x."""
    mw, mb = mp["mw"], mp["mb"]
    y = torch.einsum("...h,khg->k...g", x.to(mw.dtype), mw)
    y = y + mb.reshape((mb.shape[0],) + (1,) * (x.dim() - 1) + (mb.shape[-1],))
    return x[None] + F.silu(y.float()).to(x.dtype)


def draft_fuse(params: Params, emb_next: torch.Tensor,
               target_hidden: torch.Tensor,
               image_row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """fc([emb_next, target_hidden]) with image rows passing emb_next
    through. emb_next, target_hidden: [T, H]; image_row_mask: [T] bool."""
    x = torch.cat([emb_next, target_hidden.to(emb_next.dtype)], dim=-1)
    fc_w = params["fc_w"]
    fused = x.to(fc_w.dtype) @ fc_w
    if "fc_b" in params:
        fused = fused + params["fc_b"]
    if image_row_mask is not None:
        fused = torch.where(image_row_mask[:, None], emb_next, fused)
    return fused


def draft_forward(params: Params, cfg: DraftConfig, hidden_in: torch.Tensor,
                  positions: torch.Tensor, kv: Params, write_pos,
                  bias: torch.Tensor, cos_t: torch.Tensor,
                  sin_t: torch.Tensor, return_attn: bool = False,
                  attn_rows: Optional[torch.Tensor] = None):
    """Run the draft decoder layer(s) over pre-fused hidden states.

    kv: {'k','v'} [num_layers, S, Hkv, D], written at write_pos IN PLACE.
    Layer 0 skips input_layernorm (EAGLE convention). Returns (hidden, kv)
    or, with ``return_attn``, (hidden, kv, attn_probs): layer 0's attention
    probabilities [Hq, T, S], used for visual-attention calibration
    features; ``attn_rows`` ([R] row indices) limits them to those query
    rows, [Hq, R, S], with the same values. Takes a leading lane dimension
    as ``llama.llama_forward`` does (kv [B, num_layers, S, Hkv, D],
    attn_rows [B, R]).
    """
    x = hidden_in
    attn_p = None
    for i in range(cfg.num_layers):
        lp = L._layer(params["layers"], i)
        x_in = x
        x = L._layer_forward(lp, cfg.text, x, positions,
                             kv["k"].select(-4, i), kv["v"].select(-4, i),
                             write_pos, bias, cos_t, sin_t,
                             skip_input_norm=(i == 0))
        if return_attn and i == 0:
            attn_p = _layer_attn_probs(lp, cfg.text, x_in, positions,
                                       kv["k"].select(-4, 0), write_pos,
                                       bias, cos_t, sin_t, attn_rows)
    if return_attn:
        return x, kv, attn_p
    return x, kv


def _layer_attn_probs(lp: Params, tc, x: torch.Tensor,
                      positions: torch.Tensor, kv_k: torch.Tensor, write_pos,
                      bias: torch.Tensor, cos_t, sin_t,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Layer-0 attention probabilities, recomputed as the JAX package's
    ``_layer_attn_probs`` computes them: queries and keys from x through
    ``q_proj`` and ``k_proj`` as stored, ``x @ W`` (the layer itself applies
    ``x @ W.T``), the keys written over a copy of the cache ``kv_k``
    [S, Hkv, D] at write_pos. The calibration feature is defined by these
    values, so the port keeps them. ``rows`` limits the query rows."""
    hq, hkv, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    lanes = x.dim() - 2
    q = (x @ lp["q_proj"]).unflatten(-1, (hq, d))
    k = (x @ lp["k_proj"]).unflatten(-1, (hkv, d))
    q, k = apply_rope(q, k, cos_t, sin_t, positions)
    keys = kv_k.clone()
    wrows = L.update_rows(kv_k.shape[-3], write_pos, x.shape[-2], x.device)
    if wrows.dim() == 1:
        keys.index_copy_(lanes, wrows, k)
    else:
        put_rows(keys, wrows, k, lanes)
    if rows is not None:
        q, bias = take_rows(q, rows, lanes), take_rows(bias, rows, lanes)
    return attention_probs(q, keys, bias)


def draft_forward_nocache(params: Params, cfg: DraftConfig,
                          hidden_in: torch.Tensor, positions: torch.Tensor,
                          bias: torch.Tensor, cos_t: torch.Tensor,
                          sin_t: torch.Tensor) -> torch.Tensor:
    """Training-mode forward: full-sequence causal attention, no KV cache.

    hidden_in: [T, H] (already through draft_fuse); bias: [T, T] additive.
    Built from the layer's functional parts, with no in-place write on
    autograd's path (``_layer_forward`` writes K/V into a cache)."""
    tc = cfg.text
    x = hidden_in
    for i in range(cfg.num_layers):
        lp = L._layer(params["layers"], i)
        q, k, v = L._layer_qkv(lp, tc, x, positions, cos_t, sin_t, i == 0)
        x = L._layer_post_attn(lp, tc, x, masked_attention(q, k, v, bias))
    return x


def init_draft_kv(cfg: DraftConfig, max_len: int, dtype=torch.float32,
                  device="cuda") -> Params:
    return L.init_kv_cache(cfg.text, max_len, dtype, device,
                           num_layers=cfg.num_layers)
