"""EAGLE-style MSD draft head: embed + fc([emb, hidden]) + one decoder
layer, plus medusa resblock heads.

The port of the JAX package's ``models/draft.py``. The draft input at
expanded position j pairs the embedding of the NEXT token with the target
hidden at j; rows inside the image span bypass fc and carry the shifted
fused image embedding directly. Layouts: ``fc_w`` [2H, H], ``fc_b`` [H]
(none with ``DraftConfig.fc_bias=False``), ``layers`` stacked as in
``models/llama``, medusa ``mw`` [K, H, H] and ``mb`` [K, H].
``quantize_draft_params`` stores the layer, ``fc_w`` and ``mw`` as
int8/int4 (read through ``llama._w``). A tensor-parallel draft
(``parallel/sharding.draft_param_specs``) carries its mesh under
``"mesh"``: its layer runs sharded like the target's, fc and the medusa
heads replicated, ``embed_tokens`` gathered on its hidden columns, and
the calibration feature's probabilities computed per local head and
gathered (``_layer_attn_probs``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import DraftConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.attention import (attention_probs, masked_attention,
                                         put_rows, take_rows)
from msd_tpu_torch.ops.quant import quantize_tensor
from msd_tpu_torch.ops.rope import apply_rope
from msd_tpu_torch.parallel import comm

Params = Dict


def init_draft_params(cfg: DraftConfig, generator: torch.Generator,
                      device="cuda", dtype=torch.bfloat16) -> Params:
    """Random draft weights from ``generator`` (``fc_b`` only with
    ``cfg.fc_bias``; it draws nothing)."""
    tc = cfg.text
    h = tc.hidden_size
    p = {
        "embed_tokens": torch.randn(tc.vocab_size, h, generator=generator,
                                    dtype=dtype, device=device)
        .mul_(h ** -0.5),
        "fc_w": torch.randn(2 * h, h, generator=generator, dtype=dtype,
                            device=device).mul_((2 * h) ** -0.5),
        "layers": L.init_layers(tc, cfg.num_layers, generator, device, dtype),
    }
    if cfg.fc_bias:
        p["fc_b"] = torch.zeros(h, dtype=dtype, device=device)
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
    mw, mb = L._w(mp, "mw"), mp["mb"]
    y = torch.einsum("...h,khg->k...g", x.to(mw.dtype), mw)
    y = y + mb.reshape((mb.shape[0],) + (1,) * (x.dim() - 1) + (mb.shape[-1],))
    return x[None] + F.silu(y.float()).to(x.dtype)


def draft_fuse(params: Params, emb_next: torch.Tensor,
               target_hidden: torch.Tensor,
               image_row_mask: torch.Tensor | None = None) -> torch.Tensor:
    """fc([emb_next, target_hidden]) with image rows passing emb_next
    through. emb_next, target_hidden: [T, H]; image_row_mask: [T] bool."""
    x = torch.cat([emb_next, target_hidden.to(emb_next.dtype)], dim=-1)
    fc_w = L._w(params, "fc_w")
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
    mesh = params.get("mesh")
    x = hidden_in
    attn_p = None
    for i in range(cfg.num_layers):
        lp = L._layer(params["layers"], i)
        x_in = x
        x = L._layer_forward(lp, cfg.text, x, positions,
                             kv["k"].select(-4, i), kv["v"].select(-4, i),
                             write_pos, bias, cos_t, sin_t,
                             skip_input_norm=(i == 0), mesh=mesh)
        if return_attn and i == 0:
            attn_p = _layer_attn_probs(lp, cfg.text, x_in, positions,
                                       kv["k"].select(-4, 0), write_pos,
                                       bias, cos_t, sin_t, attn_rows, mesh)
    if return_attn:
        return x, kv, attn_p
    return x, kv


def stored_proj(lp: Params, name: str, x: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """``x @ W`` of weight ``name`` as stored ([out, in] for q/k/v: the
    product contracts over the weight's output axis, the JAX feature's
    quirk), [..., T, in]. Under a ``mesh`` the stored weight holds this
    rank's rows of that axis, which is the one tensor parallelism splits:
    this rank's columns of x times its rows give a partial product of the
    whole [..., T, in], summed over ``model`` in fp32 and rounded once
    (``llama._row_sum``)."""
    w = L._w(lp, name, x.dtype)
    if L.tp_size(mesh) == 1:
        return x @ w
    lo = mesh.coords["model"] * w.shape[0]
    return L._row_sum(x[..., lo:lo + w.shape[0]] @ w, mesh)


def _layer_attn_probs(lp: Params, tc, x: torch.Tensor,
                      positions: torch.Tensor, kv_k: torch.Tensor, write_pos,
                      bias: torch.Tensor, cos_t, sin_t,
                      rows: Optional[torch.Tensor] = None,
                      mesh=None) -> torch.Tensor:
    """Layer-0 attention probabilities, recomputed as the JAX package's
    ``_layer_attn_probs`` computes them: queries and keys from x through
    ``q_proj`` and ``k_proj`` as stored, ``x @ W`` (the layer itself applies
    ``x @ W.T``; ``stored_proj``), the keys written over a copy of the
    cache ``kv_k`` [S, Hkv, D] at write_pos. The calibration feature is
    defined by these values, so the port keeps them. ``rows`` limits the
    query rows.

    Under tensor parallelism (``mesh``) the cache holds this rank's KV
    heads: each rank takes its heads of the summed queries and keys,
    computes their probabilities over its cache, and the ranks' heads are
    gathered over ``model`` (bitwise, in head order), so every rank
    returns all [Hq, R, S]: R query rows of fp32 probabilities per head,
    where gathering the cache would move all S rows of every KV head."""
    hq, hkv, d = tc.num_attention_heads, tc.num_key_value_heads, tc.head_dim
    lanes = x.dim() - 2
    q = stored_proj(lp, "q_proj", x, mesh).unflatten(-1, (hq, d))
    k = stored_proj(lp, "k_proj", x, mesh).unflatten(-1, (hkv, d))
    tp = L.tp_size(mesh)
    if tp > 1:
        m, lq, lkv = mesh.coords["model"], hq // tp, hkv // tp
        q, k = q[..., m * lq:(m + 1) * lq, :], k[..., m * lkv:(m + 1) * lkv, :]
    q, k = apply_rope(q, k, cos_t, sin_t, positions)
    keys = kv_k.clone()
    wrows = L.update_rows(kv_k.shape[-3], write_pos, x.shape[-2], x.device)
    if wrows.dim() == 1:
        keys.index_copy_(lanes, wrows, k)
    else:
        put_rows(keys, wrows, k, lanes)
    if rows is not None:
        q, bias = take_rows(q, rows, lanes), take_rows(bias, rows, lanes)
    probs = attention_probs(q, keys, bias)
    if tp > 1:
        probs = comm.all_gather(probs, mesh, "model", dim=-3)
    return probs


def draft_forward_nocache(params: Params, cfg: DraftConfig,
                          hidden_in: torch.Tensor, positions: torch.Tensor,
                          bias: torch.Tensor, cos_t: torch.Tensor,
                          sin_t: torch.Tensor) -> torch.Tensor:
    """Training-mode forward: full-sequence causal attention, no KV cache.

    hidden_in: [T, H] (already through draft_fuse); bias: [T, T] additive.
    Built from the layer's functional parts, with no in-place write on
    autograd's path (``_layer_forward`` writes K/V into a cache). Under a
    mesh the layer's column-parallel inputs pass ``comm.copy_to``, so the
    gradient that reaches ``fc`` (and, through the loss's heads, the
    medusa heads) is the whole of it on every rank."""
    tc, mesh = cfg.text, params.get("mesh")
    x = hidden_in
    for i in range(cfg.num_layers):
        lp = L._layer(params["layers"], i)
        q, k, v = L._layer_qkv(lp, tc, x, positions, cos_t, sin_t, i == 0,
                               mesh=mesh)
        x = L._layer_post_attn(lp, tc, x, masked_attention(q, k, v, bias),
                               mesh=mesh)
    return x


def init_draft_kv(cfg: DraftConfig, max_len: int, dtype=torch.float32,
                  device="cuda") -> Params:
    return L.init_kv_cache(cfg.text, max_len, dtype, device,
                           num_layers=cfg.num_layers)


def quantize_draft_params(params: Params, bits: int = 8) -> Params:
    """Weight-only int8/int4 transform of the draft (decoder layers, the fc
    fuse, the medusa resblocks). Lossless for committed tokens: the draft
    only proposes and the target decides, so it may change alpha, never
    the greedy trajectory. ``embed_tokens`` (a gather, usually the
    target's own), biases and norms stay as they are."""
    out = dict(params)
    out["layers"] = L.quantize_layer(params["layers"], bits)
    sfx = L.quant_suffix(bits)
    if "fc_w" in out:
        out["fc_w"], out["fc_w" + sfx] = quantize_tensor(out["fc_w"], -2,
                                                         bits)
    if "medusa" in out and "mw" in out["medusa"]:
        med = dict(out["medusa"])
        med["mw"], med["mw" + sfx] = quantize_tensor(med["mw"], -2, bits)
        out["medusa"] = med
    return out


def params_from_torch_draft(state: Dict[str, torch.Tensor], cfg: DraftConfig,
                            dtype=torch.float32, device="cuda") -> Params:
    """The draft param dict from a reference draft checkpoint (the
    cnets.Model state_dict layout: ``layers.{i}.*`` as HF LLaMA layers,
    layer 0 without ``input_layernorm``, ``fc.weight`` [H, 2H],
    ``fc.bias``, ``embed_tokens.weight``)."""
    h = cfg.text.hidden_size
    layers = {}
    for ours, (theirs, transpose) in L._HF_LAYER_MAP.items():
        rows = []
        for i in range(cfg.num_layers):
            key = f"layers.{i}.{theirs}"
            if ours == "input_layernorm" and key not in state:
                rows.append(torch.ones(h, dtype=dtype, device=device))
                continue
            rows.append(L.upload(state[key], device, dtype, transpose))
        layers[ours] = torch.stack(rows)
    p = {
        "embed_tokens": L.upload(state["embed_tokens.weight"], device, dtype),
        "fc_w": L.upload(state["fc.weight"], device, dtype, True),
        "layers": layers,
    }
    if "fc.bias" in state:
        p["fc_b"] = L.upload(state["fc.bias"], device, dtype)
    return p
