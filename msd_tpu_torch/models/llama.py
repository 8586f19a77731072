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
- With lanes, a product named in ``per_lane`` is computed one lane at a
  time, so each lane's rows round as its one-lane product rounds them
  (``lane_variant`` finds the products that need it on the device).
- Weight-only int8/int4 weights (``quantize_llama_params``): the integers
  under the weight's name, the fp32 scales under ``<name>_qs`` (int8) or
  ``<name>_qs4`` (int4, packed along the last axis); every weight read
  goes through ``_w``, which dequantizes.
- Qwen2 layers carry q/k/v biases ``q_bias`` [L, Hq*D], ``k_bias`` and
  ``v_bias`` [L, Hkv*D] (``models/qwen2vl``), added after the projections
  and before the head split and the rope; they are never quantized and
  never computed per lane (no product).

Unlike JAX, the KV cache is updated IN PLACE: ``llama_forward`` writes the
new rows at ``write_pos`` into the caller's cache tensors and returns the
same dict. Training runs ``llama_forward_nocache`` instead, which leaves
autograd fresh tensors and computes the same bits. Matmuls run in the
parameter dtype (bf16 at 7B); with ``cfg.residual_dtype="float32"`` the
residual stream rides in fp32.
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
from msd_tpu_torch.ops.quant import (dequantize, dequantize_int4,
                                     quantize_tensor)
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


def _w(lp: Params, name: str, dtype=None) -> torch.Tensor:
    """Weight ``name`` of ``lp``, dequantized (bf16, as in JAX) when it is
    stored int8 or int4, then cast to ``dtype`` (the activation dtype of
    the product: torch does not promote a bf16 weight against fp32
    activations as JAX does)."""
    if name + "_qs4" in lp:
        w = dequantize_int4(lp[name], lp[name + "_qs4"])
    elif name + "_qs" in lp:
        w = dequantize(lp[name], lp[name + "_qs"])
    else:
        w = lp[name]
    return w if dtype is None else w.to(dtype)


_TRANSPOSED = ("q_proj", "k_proj", "v_proj")


def _proj(lp: Params, name: str, h: torch.Tensor,
          per_lane=frozenset()) -> torch.Tensor:
    """h @ weight ``name`` of ``lp`` (``h @ W.T`` for q/k/v), in h's dtype.
    With lanes (h [B, T, K]) and ``name`` in ``per_lane``: one product per
    lane, each over the T rows a one-lane forward multiplies, instead of
    one product over B x T rows, whose kernel may round a lane's rows
    otherwise (``lane_variant``)."""
    w = _w(lp, name, h.dtype)
    if name in _TRANSPOSED:
        w = w.T
    if name not in per_lane or h.dim() < 3:
        return h @ w
    out = h.new_empty(h.shape[:-1] + (w.shape[-1],))
    for b in range(h.shape[0]):
        torch.matmul(h[b], w, out=out[b])
    return out


def lane_variant(params: Params, lanes: int, rows: int) -> frozenset:
    """The target's products (the layer weights and ``lm_head``) that give
    a lane of ``lanes`` x ``rows`` rows other bits than the lane's own
    ``rows``-row product does: on the card, cuBLAS may pick another kernel
    (tile, split of K) for another row count. Found by trial: one product
    each on seeded inputs of the real shapes, dtypes and weights (layer 0),
    whole against per lane, which is exact, as the kernel a shape gets does
    not depend on the values. The batched engine's verify forward computes
    these one lane at a time, so a batched lane commits the tokens of its
    run alone."""
    if lanes == 1:
        return frozenset()
    lp = _layer(params["layers"], 0)
    dtype = lp["input_layernorm"].dtype
    dev = lp["input_layernorm"].device
    g = torch.Generator(device=dev).manual_seed(0)
    out = set()
    for name in _STACKED + ("lm_head",):
        src = params if name == "lm_head" else lp
        w = _w(src, name, dtype)
        k = w.shape[-1] if name in _TRANSPOSED else w.shape[0]
        x = torch.randn(lanes, rows, k, generator=g, device=dev, dtype=dtype)
        if not torch.equal(_proj(src, name, x),
                           _proj(src, name, x, frozenset({name}))):
            out.add(name)
    return frozenset(out)


def _layer_qkv(lp: Params, cfg: LlamaConfig, x: torch.Tensor,
               positions: torch.Tensor, cos_t, sin_t, skip_input_norm: bool,
               per_lane=frozenset()):
    """Pre-attention projections. Returns (q, k, v) as [..., T, H*, D]."""
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    # the draft's layer 0 skips input_layernorm (EAGLE convention)
    h = x if skip_input_norm else rms_norm(x, lp["input_layernorm"],
                                           cfg.rms_norm_eps)
    # matmuls in the param dtype even when the residual rides in fp32
    h = h.to(lp["input_layernorm"].dtype)
    q = _proj(lp, "q_proj", h, per_lane)
    k = _proj(lp, "k_proj", h, per_lane)
    v = _proj(lp, "v_proj", h, per_lane)
    if "q_bias" in lp:  # Qwen2 attention carries qkv biases
        q = q + lp["q_bias"]
        k = k + lp["k_bias"]
        v = v + lp["v_bias"]
    q = q.unflatten(-1, (hq, d))
    k = k.unflatten(-1, (hkv, d))
    v = v.unflatten(-1, (hkv, d))
    q, k = apply_rope(q, k, cos_t, sin_t, positions)
    return q, k, v


def _layer_post_attn(lp: Params, cfg: LlamaConfig, resid: torch.Tensor,
                     attn: torch.Tensor, per_lane=frozenset()) -> torch.Tensor:
    x = resid + _proj(lp, "o_proj", attn.flatten(-2), per_lane) \
        .to(resid.dtype)
    h = rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
    h = h.to(lp["post_attention_layernorm"].dtype)
    gate = F.silu(_proj(lp, "gate_proj", h, per_lane).float()).to(h.dtype)
    up = _proj(lp, "up_proj", h, per_lane)
    return x + _proj(lp, "down_proj", gate * up, per_lane).to(resid.dtype)


def _attend(cfg: LlamaConfig, q, kv_k, kv_v, bias, kv_len, win=None):
    """Attention routing.

    - ``win`` given (tree verification): window-canonical attention, so the
      committed trajectory is draft-invariant.
    - ``kv_len`` given and either at most KERNEL_MAX_GT grouped query
      rows (G * T) or one query row (T = 1: the AR decode row, whatever
      the GQA group G, e.g. Qwen2-VL-7B's 7): the decode-attention kernel
      K1 (its plain twin for CPU tensors). On the card a call the kernel
      does not take (head_dim other than 128, another dtype) raises
      there; nothing falls back. This is the JAX "auto" rule without its
      TPU cache-length threshold, plus the row JAX's ``attn_impl=
      "pallas"`` sends to the kernel's MXU regime. With lanes, one call
      per lane.
    - otherwise (prefill, draft): masked attention.
    """
    if win is not None:
        return windowed_attention(q, kv_k, kv_v, bias, *win, compact=True)
    t = q.shape[-3]
    gt = t * (cfg.num_attention_heads // cfg.num_key_value_heads)
    if kv_len is not None and (gt <= KERNEL_MAX_GT or t == 1):
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
                   kv_len=None, win=None, per_lane=frozenset()
                   ) -> torch.Tensor:
    """One decoder layer over x [..., T, H]; writes its K/V rows into
    kv_k/kv_v [..., S, Hkv, D] at write_pos (an int, a 0-dim tensor or one
    start per lane) in place. Returns the new x."""
    q, k, v = _layer_qkv(lp, cfg, x, positions, cos_t, sin_t,
                         skip_input_norm, per_lane)
    lanes = x.dim() - 2
    rows = update_rows(kv_k.shape[-3], write_pos, x.shape[-2], x.device)
    if rows.dim() == 1:     # the same rows in every lane
        kv_k.index_copy_(lanes, rows, k)
        kv_v.index_copy_(lanes, rows, v)
    else:
        put_rows(kv_k, rows, k, lanes)
        put_rows(kv_v, rows, v, lanes)
    attn = _attend(cfg, q, kv_k, kv_v, bias, kv_len, win)
    return _layer_post_attn(lp, cfg, x, attn, per_lane)


def llama_forward(params: Params, cfg: LlamaConfig, embeds: torch.Tensor,
                  positions: torch.Tensor, kv: Params, write_pos,
                  bias: torch.Tensor, cos_t: torch.Tensor,
                  sin_t: torch.Tensor, kv_len=None, win=None,
                  per_lane=frozenset()) -> Tuple[torch.Tensor, Params]:
    """All decoder layers over embeds [T, H] at positions [T].

    kv: {'k','v'} [L, S, Hkv, D]; bias [T, S]; write_pos: int or 0-dim
    tensor. Each layer writes its new K/V rows into ``kv`` at write_pos IN
    PLACE (the JAX version returns an updated copy); the returned dict is
    ``kv`` itself. Returns (final-normed hidden [T, H] in embeds.dtype, kv).
    With lanes: embeds [B, T, H], positions [B, T], kv [B, L, S, Hkv, D],
    bias [B, T, S], write_pos and kv_len [B] (or an int), win's arrays
    with a leading B; ``per_lane`` names the products computed one lane at
    a time (``_proj``).
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
                           sin_t, kv_len=kv_len, win=win,
                           per_lane=per_lane)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps).to(out_dtype)
    return x, kv


def llama_forward_nocache(params: Params, cfg: LlamaConfig,
                          embeds: torch.Tensor, positions: torch.Tensor,
                          bias: torch.Tensor, cos_t: torch.Tensor,
                          sin_t: torch.Tensor) -> torch.Tensor:
    """All decoder layers over embeds [T, H] with no KV cache, for
    training: each layer attends over its own T rows of K/V (a prefill
    written at row 0), so autograd holds fresh tensors. ``llama_forward``
    writes every layer's K/V in place into views of one [L, S, Hkv, D]
    buffer, whose shared version counter invalidates what the earlier
    layers saved for the backward. The stacked layer weights are unbound
    once, so the backward stacks each weight's L layer gradients once
    (a per-layer ``select`` would materialise a gradient of the whole
    stack per layer). bias [T, T]. Equals ``llama_forward`` over a T-row
    cache written at 0, bitwise. Returns the final-normed hidden [T, H]
    in embeds.dtype."""
    out_dtype = embeds.dtype
    x = embeds
    if cfg.residual_dtype is not None:
        x = x.to(getattr(torch, cfg.residual_dtype))
    layers = params["layers"]
    names = list(layers)
    for ws in zip(*(torch.unbind(layers[n]) for n in names)):
        lp = dict(zip(names, ws))
        q, k, v = _layer_qkv(lp, cfg, x, positions, cos_t, sin_t, False)
        x = _layer_post_attn(lp, cfg, x, masked_attention(q, k, v, bias))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps).to(out_dtype)


def lm_head(params: Params, hidden: torch.Tensor,
            per_lane=frozenset()) -> torch.Tensor:
    """[..., T, H] -> [..., T, V] logits in fp32."""
    return _proj(params, "lm_head", hidden, per_lane).float()


def embed_tokens(params: Params, ids: torch.Tensor) -> torch.Tensor:
    return params["embed_tokens"][ids.long()]


def make_rope(cfg: LlamaConfig, max_seq_len: int, device="cuda"):
    return rope_table(max_seq_len, cfg.head_dim, cfg.rope_theta, device)


# weight-only quantization: the contraction axis of each weight. q/k/v
# stacks are [L, out, in] (in contracted); the rest [L, in, out] or
# [in, out]. Norms, biases and embeddings stay as they are (few bytes; the
# embedding is a gather, not a product).
_QUANT_AXES = {"q_proj": -1, "k_proj": -1, "v_proj": -1,
               "o_proj": -2, "gate_proj": -2, "up_proj": -2, "down_proj": -2}


def quant_suffix(bits: int) -> str:
    return "_qs" if bits == 8 else "_qs4"


def quantize_layer(lp: Params, bits: int = 8) -> Params:
    """The weight-only int8/int4 transform of one layer's (or one stack of
    layers') weights: each weight of ``_QUANT_AXES`` in ``lp`` becomes its
    integers plus its scales."""
    out = dict(lp)
    for name, axis in _QUANT_AXES.items():
        if name in lp:
            out[name], out[name + quant_suffix(bits)] = quantize_tensor(
                lp[name], axis, bits)
    return out


def quantize_layers(layer, n: int, bits: int = 8) -> Params:
    """Stacked int8/int4 decoder-layer weights made one layer at a time:
    ``layer(i)`` gives layer i's full-precision weights (views of a stack,
    or made on the spot, as a 13B init from seeds makes them), which are
    quantized (``quantize_layer``) and copied into stacks allocated at the
    first layer. So the temporaries are one layer's, never a stack's."""
    out = {}
    for i in range(n):
        for k, v in quantize_layer(layer(i), bits).items():
            if k not in out:
                out[k] = torch.empty((n,) + tuple(v.shape), dtype=v.dtype,
                                     device=v.device)
            out[k][i].copy_(v)
    return out


def quantize_llama_params(params: Params, quant_lm_head: bool = True,
                          bits: int = 8) -> Params:
    """Weight-only int8/int4 transform of a stacked LLaMA param dict (the
    JAX ``quantize_llama_params``; the reference's load-8bit/load-4bit
    serving), layer by layer (``quantize_layers``). int4 scales live under
    ``_qs4`` keys so ``_w`` unpacks."""
    layers = params["layers"]
    out = dict(params)
    out["layers"] = quantize_layers(lambda i: _layer(layers, i),
                                    layers["q_proj"].shape[0], bits)
    if quant_lm_head:
        out["lm_head"], out["lm_head" + quant_suffix(bits)] = \
            quantize_tensor(params["lm_head"], -2, bits)
    return out


# ---------------------------------------------------------------------------
# HF weight import (a flat state dict of host tensors -> the stacked dict)
# ---------------------------------------------------------------------------

_HF_LAYER_MAP = {
    "input_layernorm": ("input_layernorm.weight", False),
    "post_attention_layernorm": ("post_attention_layernorm.weight", False),
    "q_proj": ("self_attn.q_proj.weight", False),  # kept [out, in]
    "k_proj": ("self_attn.k_proj.weight", False),
    "v_proj": ("self_attn.v_proj.weight", False),
    "o_proj": ("self_attn.o_proj.weight", True),
    "gate_proj": ("mlp.gate_proj.weight", True),
    "up_proj": ("mlp.up_proj.weight", True),
    "down_proj": ("mlp.down_proj.weight", True),
}
_HF_BIAS_MAP = {
    "q_bias": ("self_attn.q_proj.bias", False),
    "k_bias": ("self_attn.k_proj.bias", False),
    "v_bias": ("self_attn.v_proj.bias", False),
}


def upload(t: torch.Tensor, device, dtype, transpose: bool = False
           ) -> torch.Tensor:
    """A host tensor on ``device`` in ``dtype``: one copy in its source
    dtype, then the cast and the transpose of its last two axes on the
    device (made contiguous, so products read it as a freshly made
    weight)."""
    x = t.to(device).to(dtype)
    return x.transpose(-1, -2).contiguous() if transpose else x


def params_from_hf(state: Dict[str, torch.Tensor], cfg: LlamaConfig,
                   prefix: str = "model.", dtype=torch.float32,
                   device="cuda") -> Params:
    """The stacked param dict from a HF-LLaMA flat state dict of host
    tensors (HF Linear stores [out, in]; o/gate/up/down and lm_head are
    kept [in, out]).

    Per weight, the L layers are stacked into one host tensor in the
    SOURCE dtype (plain copies), uploaded with one copy, then cast and
    transposed on the device, as the JAX version does (its 7B load took 23
    minutes converting tensor by tensor, one minute this way). A state
    with q/k/v projection biases (Qwen2) gets them stacked too."""
    L = cfg.num_hidden_layers
    stacked = {}
    biases = f"{prefix}layers.0.self_attn.q_proj.bias" in state
    layer_map = dict(_HF_LAYER_MAP, **(_HF_BIAS_MAP if biases else {}))
    for ours, (theirs, transpose) in layer_map.items():
        first = state[f"{prefix}layers.0.{theirs}"]
        buf = torch.empty((L,) + tuple(first.shape), dtype=first.dtype)
        for i in range(L):
            buf[i] = state[f"{prefix}layers.{i}.{theirs}"]
        stacked[ours] = upload(buf, device, dtype, transpose)
        del buf
    return {
        "embed_tokens": upload(state[f"{prefix}embed_tokens.weight"], device,
                               dtype),
        "layers": stacked,
        "norm": upload(state[f"{prefix}norm.weight"], device, dtype),
        "lm_head": upload(state["lm_head.weight"], device, dtype, True),
    }
