"""Qwen-VL (v1): the OpenCLIP-style ViT-bigG tower with its 256-query
cross-attention resampler, and the Qwen-1 decoder's checkpoint layout.

The port of the JAX package's ``models/qwen_vl_v1.py`` (reference:
lmms-eval's ``qwen_vl_eagle`` adapter over the public Qwen/Qwen-VL remote
code, ``visual.py`` and ``modeling_qwen.py``). The tower is a pre-LN ViT
(448px, patch 14, width 1664, 48 layers, exact-GELU MLP) whose output a
resampler pools into 256 learned queries by one cross-attention with 2-D
sincos positions, then projects to the LM's hidden size. The 256 image rows
sit inline in the prompt under ordinary 1-D positions (no mrope), so the
engine serves them with ``image_mode="inline"``, ``mrope_section=None`` and
the v1 tokenizer's ``<imgpad>`` id as ``inline_pad_ids``.

Layouts (the JAX package's, bitwise through ``bridge.to_torch``; the public
checkpoint's names through ``params_from_hf_qwen_vl_vision``):
- every matrix kept [out, in] as torch stores it (``x @ W.T``), ``conv1``
  [width, 3*P*P] (channel-major within a patch);
- ``nn.MultiheadAttention``'s packed ``in_proj_w`` [3E, E] (q, k, v rows)
  with ``in_proj_b`` [3E], and ``out_proj``;
- the blocks stacked along a leading layer axis;
- the resampler's queries get its sincos table ``pos_embed`` (grid
  n_queries ** 0.5); its keys get that table bicubic-resized to the ViT's
  grid; its values carry no positions;
- the ViT's learned ``pos_embed`` is bicubic-resized when the input grid
  differs from the checkpoint's.

The decoder is ``models/llama``'s with q/k/v biases (the Qwen2 layer without
mrope and without GQA): ``params_from_hf_qwen_v1`` splits the fused
``c_attn`` into q/k/v and their biases. The tower computes in its weights'
dtype (the pixels are cast to it), as the port's other towers do; its ops
are XLA einsums in JAX, not Pallas kernels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import LlamaConfig
from msd_tpu_torch.ops.norms import layer_norm

Params = Dict


@dataclass(frozen=True)
class QwenVLVisionConfig:
    image_size: int = 448
    patch_size: int = 14
    width: int = 1664
    layers: int = 48
    heads: int = 16
    mlp_size: int = 8192
    output_dim: int = 4096      # LM hidden (= resampler embed dim)
    n_queries: int = 256
    resampler_heads: int = 32
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @staticmethod
    def tiny(width=32, layers=2, heads=4, out=48, queries=4,
             image_size=56) -> "QwenVLVisionConfig":
        return QwenVLVisionConfig(image_size=image_size, width=width,
                                  layers=layers, heads=heads,
                                  mlp_size=width * 4, output_dim=out,
                                  n_queries=queries, resampler_heads=4)


def sincos_2d(embed_dim: int, grid: int) -> np.ndarray:
    """[grid*grid, embed_dim] 2-D sincos table (MAE's
    get_2d_sincos_pos_embed), in float64 on the host, returned float32."""
    def _1d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gh = np.arange(grid, dtype=np.float64)
    gw = np.arange(grid, dtype=np.float64)
    ww, hh = np.meshgrid(gw, gh)
    # MAE's quirk: its meshgrid(grid_w, grid_h) makes the first half of
    # the table encode the w coordinate, so the table is [w-half, h-half]
    emb_w = _1d(embed_dim // 2, ww)
    emb_h = _1d(embed_dim // 2, hh)
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)


def _torch_bicubic_matrix(src: int, tgt: int) -> np.ndarray:
    """[tgt, src] 1-D resize matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)``: half-pixel centres, the Keys kernel with A =
    -0.75 (``jax.image.resize``'s is A = -0.5), edge-clamped taps."""
    A = -0.75

    def w(d):
        d = abs(d)
        if d <= 1.0:
            return ((A + 2) * d - (A + 3)) * d * d + 1
        if d < 2.0:
            return A * (((d - 5) * d + 8) * d - 4)
        return 0.0

    M = np.zeros((tgt, src), np.float64)
    for i in range(tgt):
        x = (i + 0.5) * src / tgt - 0.5
        base = int(np.floor(x))
        frac = x - base
        for k, dist in ((-1, 1 + frac), (0, frac), (1, 1 - frac),
                        (2, 2 - frac)):
            M[i, min(max(base + k, 0), src - 1)] += w(dist)
    return M.astype(np.float32)


def interp_abs_pos(pos: torch.Tensor, tgt_len: int) -> torch.Tensor:
    """The remote code's get_abs_pos: a [S, D] grid table bicubic-resized
    to ``tgt_len`` rows (both square grids), in fp32, returned in the
    table's dtype; the table itself when the grids agree."""
    src = int(round(pos.shape[0] ** 0.5))
    tgt = int(round(tgt_len ** 0.5))
    if src == tgt:
        return pos
    d = pos.shape[1]
    M = torch.from_numpy(_torch_bicubic_matrix(src, tgt)).to(pos.device)
    x = pos.reshape(src, src, d).float()
    x = torch.einsum("ts,suv->tuv", M, x)
    x = torch.einsum("us,tsv->tuv", M, x)
    return x.reshape(tgt * tgt, d).to(pos.dtype)


def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, p: Params,
         heads: int) -> torch.Tensor:
    """``nn.MultiheadAttention``'s forward over batch-free [T, E] rows:
    the packed ``in_proj`` [3E, E], scores and softmax in fp32, the
    probabilities cast to V's dtype, the product accumulated in fp32."""
    e = q.shape[-1]
    d = e // heads
    wq, wk, wv = p["in_proj_w"].chunk(3, dim=0)
    bq, bk, bv = p["in_proj_b"].chunk(3, dim=0)
    qh = (q @ wq.T + bq).reshape(-1, heads, d)
    kh = (k @ wk.T + bk).reshape(-1, heads, d)
    vh = (v @ wv.T + bv).reshape(-1, heads, d)
    scores = torch.einsum("qhd,khd->hqk", qh.float(), kh.float()) \
        * d ** -0.5
    probs = torch.softmax(scores, dim=-1).to(vh.dtype)
    out = torch.einsum("hqk,khd->qhd", probs.float(),
                       vh.float()).to(q.dtype)
    return out.reshape(-1, e) @ p["out_proj_w"].T + p["out_proj_b"]


def init_qwen_vl_vision_params(cfg: QwenVLVisionConfig,
                               generator: torch.Generator, device="cuda",
                               dtype=torch.bfloat16) -> Params:
    """Random tower weights from ``generator``, drawn in ``dtype`` on
    ``device`` at the JAX init's scales: each matrix normal * fan_in^-0.5,
    the ViT positions and the queries normal * 0.02, the resampler's
    sincos table, LayerNorms at one, biases zero."""
    w, m, o, n = cfg.width, cfg.mlp_size, cfg.output_dim, cfg.layers

    def mat(*shape, scale=None):
        s = shape[-1] ** -0.5 if scale is None else scale
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(s)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    blocks = {"ln1_w": const(1.0, n, w), "ln1_b": const(0.0, n, w),
              "ln2_w": const(1.0, n, w), "ln2_b": const(0.0, n, w),
              "in_proj_w": mat(n, 3 * w, w),
              "in_proj_b": const(0.0, n, 3 * w),
              "out_proj_w": mat(n, w, w), "out_proj_b": const(0.0, n, w),
              "fc_w": mat(n, m, w), "fc_b": const(0.0, n, m),
              "proj_w": mat(n, w, m), "proj_b": const(0.0, n, w)}
    table = sincos_2d(o, int(round(cfg.n_queries ** 0.5)))
    return {
        "conv1": mat(w, 3 * cfg.patch_size ** 2),
        "pos_embed": mat(cfg.grid ** 2, w, scale=0.02),
        "ln_pre_w": const(1.0, w), "ln_pre_b": const(0.0, w),
        "blocks": blocks,
        "resampler": {
            "pos_embed": torch.from_numpy(table).to(device=device,
                                                    dtype=dtype),
            "query": mat(cfg.n_queries, o, scale=0.02),
            "kv_proj_w": mat(o, w),
            "ln_q_w": const(1.0, o), "ln_q_b": const(0.0, o),
            "ln_kv_w": const(1.0, o), "ln_kv_b": const(0.0, o),
            "attn": {"in_proj_w": mat(3 * o, o),
                     "in_proj_b": const(0.0, 3 * o),
                     "out_proj_w": mat(o, o),
                     "out_proj_b": const(0.0, o)},
        },
        "ln_post_w": const(1.0, o), "ln_post_b": const(0.0, o),
        "proj": mat(o, o),
    }


def qwen_vl_vit(params: Params, cfg: QwenVLVisionConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """The ViT over [3, H, W] pixels -> [gh*gw, width] rows: conv1 as a
    matmul over row-major patch rows, the learned positions (resized when
    the grid differs), ``ln_pre``, the pre-LN blocks."""
    p, eps, heads = cfg.patch_size, cfg.layer_norm_eps, cfg.heads
    _, H, W = pixels.shape
    gh, gw = H // p, W // p
    w = params["conv1"]
    x = pixels.to(w.dtype).reshape(3, gh, p, gw, p).permute(1, 3, 0, 2, 4)
    x = x.reshape(gh * gw, 3 * p * p) @ w.T
    x = x + interp_abs_pos(params["pos_embed"], gh * gw)
    x = layer_norm(x, params["ln_pre_w"], params["ln_pre_b"], eps)
    blocks = params["blocks"]
    for i in range(blocks["fc_w"].shape[0]):
        bp = {k: t[i] for k, t in blocks.items()}
        y = layer_norm(x, bp["ln1_w"], bp["ln1_b"], eps)
        x = x + _mha(y, y, y, bp, heads)
        y = layer_norm(x, bp["ln2_w"], bp["ln2_b"], eps)
        y = F.gelu((y @ bp["fc_w"].T + bp["fc_b"]).float()).to(x.dtype)
        x = x + y @ bp["proj_w"].T + bp["proj_b"]
    return x


def qwen_vl_resample(params: Params, cfg: QwenVLVisionConfig,
                     x: torch.Tensor) -> torch.Tensor:
    """The resampler and the output projection over the ViT's rows x
    [gh*gw, width] -> [n_queries, output_dim]: ``kv_proj``, ``ln_kv``,
    ``ln_q(query)``; the queries with the sincos table, the keys with it
    resized to the ViT's grid, the values without positions; ``ln_post``
    and ``@ proj``."""
    r, eps = params["resampler"], cfg.layer_norm_eps
    kv = layer_norm(x @ r["kv_proj_w"].T, r["ln_kv_w"], r["ln_kv_b"], eps)
    q = layer_norm(r["query"], r["ln_q_w"], r["ln_q_b"], eps)
    k_pos = interp_abs_pos(r["pos_embed"], kv.shape[0])
    out = _mha(q + r["pos_embed"], kv + k_pos, kv, r["attn"],
               cfg.resampler_heads)
    out = layer_norm(out, params["ln_post_w"], params["ln_post_b"], eps)
    return out @ params["proj"]


def qwen_vl_vision_encode(params: Params, cfg: QwenVLVisionConfig,
                          pixels: torch.Tensor) -> torch.Tensor:
    """[3, H, W] (normalized pixels) -> [n_queries, output_dim] image
    rows in the weights' dtype."""
    return qwen_vl_resample(params, cfg, qwen_vl_vit(params, cfg, pixels))


def params_from_hf_qwen_vl_vision(state: Dict[str, torch.Tensor],
                                  cfg: QwenVLVisionConfig,
                                  prefix: str = "transformer.visual.",
                                  dtype=torch.float32,
                                  device="cuda") -> Params:
    """The tower's param dict from the public Qwen/Qwen-VL checkpoint
    names (``visual.py``) in a flat state dict of host tensors; each
    block weight stacked over the layers in its source dtype, then
    uploaded and cast on the device."""
    from msd_tpu_torch.models.llama import upload

    def get(name):
        return state[prefix + name]

    names = {"ln1_w": "ln_1.weight", "ln1_b": "ln_1.bias",
             "ln2_w": "ln_2.weight", "ln2_b": "ln_2.bias",
             "in_proj_w": "attn.in_proj_weight",
             "in_proj_b": "attn.in_proj_bias",
             "out_proj_w": "attn.out_proj.weight",
             "out_proj_b": "attn.out_proj.bias",
             "fc_w": "mlp.c_fc.weight", "fc_b": "mlp.c_fc.bias",
             "proj_w": "mlp.c_proj.weight", "proj_b": "mlp.c_proj.bias"}
    blocks = {ours: upload(torch.stack(
        [get(f"transformer.resblocks.{i}.{theirs}")
         for i in range(cfg.layers)]), device, dtype)
        for ours, theirs in names.items()}

    def up(name):
        return upload(get(name), device, dtype)

    attn = "attn_pool.attn."
    return {
        "conv1": upload(get("conv1.weight").reshape(cfg.width, -1), device,
                        dtype),
        "pos_embed": up("positional_embedding"),
        "ln_pre_w": up("ln_pre.weight"), "ln_pre_b": up("ln_pre.bias"),
        "blocks": blocks,
        "resampler": {
            "pos_embed": up("attn_pool.pos_embed"),
            "query": up("attn_pool.query"),
            "kv_proj_w": up("attn_pool.kv_proj.weight"),
            "ln_q_w": up("attn_pool.ln_q.weight"),
            "ln_q_b": up("attn_pool.ln_q.bias"),
            "ln_kv_w": up("attn_pool.ln_kv.weight"),
            "ln_kv_b": up("attn_pool.ln_kv.bias"),
            "attn": {"in_proj_w": up(attn + "in_proj_weight"),
                     "in_proj_b": up(attn + "in_proj_bias"),
                     "out_proj_w": up(attn + "out_proj.weight"),
                     "out_proj_b": up(attn + "out_proj.bias")},
        },
        "ln_post_w": up("ln_post.weight"), "ln_post_b": up("ln_post.bias"),
        "proj": up("proj"),
    }


# ---------------------------------------------------------------------------
# the Qwen (v1) language model: the llama machinery, fused-qkv checkpoints
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QwenVLV1TextConfig:
    """Qwen-VL (v1) LM shapes, the Qwen-1 architecture: RMSNorm, 1-D
    rotary, SwiGLU (w1/w2 halves), fused c_attn q/k/v with a bias, no GQA.
    Served by the llama decoder with q/k/v biases."""

    vocab_size: int = 151936
    hidden_size: int = 4096
    intermediate_size: int = 11008    # the HF config's 22016 // 2
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_attention_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta)

    @staticmethod
    def tiny(vocab=512, hidden=64, layers=2, heads=4,
             inter=128) -> "QwenVLV1TextConfig":
        return QwenVLV1TextConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads,
            max_position_embeddings=2048)


def params_from_hf_qwen_v1(state: Dict[str, torch.Tensor],
                           cfg: QwenVLV1TextConfig, dtype=torch.float32,
                           device="cuda") -> Params:
    """The llama param dict (q/k/v biases included) from the public
    Qwen/Qwen-VL LM names (``modeling_qwen.py``): transformer.wte,
    h.{i}.{ln_1, attn.c_attn (fused q/k/v rows, with a bias), attn.c_proj,
    ln_2, mlp.{w1 (up), w2 (the silu-gated half), c_proj}}, transformer.ln_f,
    lm_head. q/k/v stay [out, in]; o/gate/up/down and lm_head become
    [in, out] (``models/llama``'s layout). Each weight is stacked over the
    layers in its source dtype, then uploaded, cast and transposed on the
    device."""
    from msd_tpu_torch.models.llama import upload

    h, n = cfg.hidden_size, cfg.num_hidden_layers

    def stack(name, rows=None):
        ts = [state[f"transformer.h.{i}.{name}"] for i in range(n)]
        if rows is not None:
            ts = [t[rows] for t in ts]
        return torch.stack(ts)

    qkv = {"q": slice(0, h), "k": slice(h, 2 * h), "v": slice(2 * h, None)}
    layers = {}
    for x, rows in qkv.items():
        layers[f"{x}_proj"] = upload(stack("attn.c_attn.weight", rows),
                                     device, dtype)
        layers[f"{x}_bias"] = upload(stack("attn.c_attn.bias", rows),
                                     device, dtype)
    for ours, theirs in (("o_proj", "attn.c_proj.weight"),
                         ("gate_proj", "mlp.w2.weight"),
                         ("up_proj", "mlp.w1.weight"),
                         ("down_proj", "mlp.c_proj.weight")):
        layers[ours] = upload(stack(theirs), device, dtype, True)
    layers["input_layernorm"] = upload(stack("ln_1.weight"), device, dtype)
    layers["post_attention_layernorm"] = upload(stack("ln_2.weight"),
                                                device, dtype)
    return {
        "embed_tokens": upload(state["transformer.wte.weight"], device,
                               dtype),
        "norm": upload(state["transformer.ln_f.weight"], device, dtype),
        "lm_head": upload(state["lm_head.weight"], device, dtype, True),
        "layers": layers,
    }
