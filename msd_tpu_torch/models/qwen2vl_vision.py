"""Qwen2-VL vision tower (Qwen2VisionTransformer), as functions over a dict
of stacked per-block weights like ``models/clip_vit``.

The port of the JAX package's ``models/qwen2vl_vision.py`` (image path):
the patch "conv" as a matmul, the 2-D rotary position embedding,
full-attention pre-LN blocks with quick_gelu, and the 2x2 PatchMerger
(LayerNorm, then an exact-GELU MLP) producing LM-space image tokens.

Layouts (``x @ W``; HF checkpoint compatible through
``params_from_hf_qwen_vision``):
- The patch sequence is 2x2-merge-window-major: window (R, C), then (r, c)
  within the window (modeling_qwen2_vl.py rot_pos_emb:673-695 builds
  hpos/wpos in this order, and PatchMerger groups 4 consecutive patches).
- Rotary: head_dim/4 frequencies over the h position, concatenated with the
  same over w, duplicated to head_dim (apply_rotary_pos_emb_vision).
- A single image is repeated over the temporal_patch_size (2) axis; each
  patch row is [C, Tp, P, P].
- ``patch_embed`` [C*Tp*P*P, E]; blocks: ``qkv_w`` [L, E, 3E], ``proj_w``
  [L, E, E], ``fc1_w`` [L, E, 4E], ``fc2_w`` [L, 4E, E] with their biases
  and ``norm1``/``norm2`` LayerNorms; merger ``ln_q``, ``merge_fc1``
  [4E, 4E], ``merge_fc2`` [4E, hidden].

The tower computes in its weights' dtype (the pixels are cast to it), as
the CLIP tower does. Its attention is a plain softmax einsum (an XLA op in
JAX, not a Pallas kernel). Videos (temporal blocks, block-diagonal
attention) are not ported yet: M15b.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from msd_tpu_torch.models.clip_vit import quick_gelu
from msd_tpu_torch.ops.norms import layer_norm

Params = Dict


@dataclass(frozen=True)
class Qwen2VisionConfig:
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    temporal_patch_size: int = 2
    spatial_merge_size: int = 2
    in_channels: int = 3
    hidden_size: int = 3584   # LM hidden (merger output)
    layer_norm_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_hidden(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @staticmethod
    def tiny(embed=32, depth=2, heads=4, hidden=64) -> "Qwen2VisionConfig":
        return Qwen2VisionConfig(embed_dim=embed, depth=depth,
                                 num_heads=heads, hidden_size=hidden)


def init_qwen_vision_params(cfg: Qwen2VisionConfig,
                            generator: torch.Generator, device="cuda",
                            dtype=torch.bfloat16) -> Params:
    """Random tower weights from ``generator``, drawn in ``dtype`` on
    ``device``: each matrix normal * fan_in^-0.5 (the JAX init's scale),
    LayerNorms at one, biases zero."""
    e, mh, n = cfg.embed_dim, cfg.mlp_hidden, cfg.depth
    merge_in = e * cfg.spatial_merge_size ** 2
    patch_in = cfg.in_channels * cfg.temporal_patch_size \
        * cfg.patch_size ** 2

    def mat(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(shape[-2] ** -0.5)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    blocks = {"norm1_w": const(1.0, n, e), "norm1_b": const(0.0, n, e),
              "norm2_w": const(1.0, n, e), "norm2_b": const(0.0, n, e),
              "qkv_w": mat(n, e, 3 * e), "qkv_b": const(0.0, n, 3 * e),
              "proj_w": mat(n, e, e), "proj_b": const(0.0, n, e),
              "fc1_w": mat(n, e, mh), "fc1_b": const(0.0, n, mh),
              "fc2_w": mat(n, mh, e), "fc2_b": const(0.0, n, e)}
    return {
        "patch_embed": mat(patch_in, e),
        "blocks": blocks,
        "ln_q_w": const(1.0, e), "ln_q_b": const(0.0, e),
        "merge_fc1": mat(merge_in, merge_in),
        "merge_fc1_b": const(0.0, merge_in),
        "merge_fc2": mat(merge_in, cfg.hidden_size),
        "merge_fc2_b": const(0.0, cfg.hidden_size),
    }


def window_major_patches(pixels: torch.Tensor, cfg: Qwen2VisionConfig
                         ) -> torch.Tensor:
    """[3, H, W] -> [gh*gw, C*Tp*P*P] patch rows in merge-window-major
    order (a single image: the frame is repeated over the temporal axis)."""
    p, m = cfg.patch_size, cfg.spatial_merge_size
    c, H, W = pixels.shape
    gh, gw = H // p, W // p
    x = pixels.reshape(c, gh // m, m, p, gw // m, m, p)
    # order: (R, C, r, c) windows-major, patch pixels (ch, ph, pw)
    x = x.permute(1, 4, 2, 5, 0, 3, 6).reshape(gh * gw, c, 1, p * p)
    # temporal repeat: HF flattens each patch as [C, Tp, P, P]
    x = x.expand(gh * gw, c, cfg.temporal_patch_size, p * p)
    return x.reshape(gh * gw, c * cfg.temporal_patch_size * p * p)


def vision_rotary(cfg: Qwen2VisionConfig, gh: int, gw: int,
                  theta: float = 10000.0, device="cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin [gh*gw, head_dim] fp32 for the window-major patch order,
    computed in float64 on the host as the JAX version computes them."""
    m = cfg.spatial_merge_size
    dim4 = cfg.head_dim // 4
    inv = 1.0 / (theta ** (np.arange(0, dim4 * 2, 2, dtype=np.float64)
                           / (dim4 * 2)))
    hh = np.arange(gh)[:, None] * np.ones((1, gw))
    ww = np.ones((gh, 1)) * np.arange(gw)[None, :]

    def window_major(a):
        return a.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3) \
            .reshape(-1)

    hpos, wpos = window_major(hh), window_major(ww)
    freqs = np.concatenate([np.outer(hpos, inv), np.outer(wpos, inv)],
                           axis=1)
    emb = np.concatenate([freqs, freqs], axis=1)
    return (torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(emb).astype(np.float32)).to(device))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def _block(bp: Params, cfg: Qwen2VisionConfig, x: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """One pre-LN block over x [n, E] (full attention over the patches)."""
    n = x.shape[0]
    e, nh, d = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    y = layer_norm(x, bp["norm1_w"], bp["norm1_b"], cfg.layer_norm_eps)
    qkv = (y @ bp["qkv_w"] + bp["qkv_b"]).reshape(n, 3, nh, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    qf, kf = q.float(), k.float()
    q = (qf * cos + _rotate_half(qf) * sin).to(x.dtype)
    k = (kf * cos + _rotate_half(kf) * sin).to(x.dtype)
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * d ** -0.5
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    attn = torch.einsum("hqk,khd->qhd", probs.float(), v.float()).to(x.dtype)
    x = x + attn.reshape(n, e) @ bp["proj_w"] + bp["proj_b"]
    y = layer_norm(x, bp["norm2_w"], bp["norm2_b"], cfg.layer_norm_eps)
    y = quick_gelu(y @ bp["fc1_w"] + bp["fc1_b"])
    return x + y @ bp["fc2_w"] + bp["fc2_b"]


def _encode_core(params: Params, cfg: Qwen2VisionConfig, x: torch.Tensor,
                 gh: int, gw: int) -> torch.Tensor:
    """The blocks and the merger over patch embeddings x [gh*gw, E] of one
    image -> [gh*gw/4, hidden]."""
    cos, sin = vision_rotary(cfg, gh, gw, device=x.device)
    cos, sin = cos[:, None, :], sin[:, None, :]
    blocks = params["blocks"]
    for i in range(blocks["qkv_w"].shape[0]):
        x = _block({k: w[i] for k, w in blocks.items()}, cfg, x, cos, sin)
    x = layer_norm(x, params["ln_q_w"], params["ln_q_b"], cfg.layer_norm_eps)
    merge_in = cfg.embed_dim * cfg.spatial_merge_size ** 2
    x = x.reshape(-1, merge_in)
    x = x @ params["merge_fc1"] + params["merge_fc1_b"]
    x = F.gelu(x.float()).to(x.dtype)          # the merger's exact GELU
    return x @ params["merge_fc2"] + params["merge_fc2_b"]


def qwen_vision_encode(params: Params, cfg: Qwen2VisionConfig,
                       pixels: torch.Tensor) -> torch.Tensor:
    """[3, H, W] (normalized pixels) -> merged image tokens
    [(H/P)*(W/P)/4, hidden] in the weights' dtype."""
    p = cfg.patch_size
    _, H, W = pixels.shape
    w = params["patch_embed"]
    x = window_major_patches(pixels.to(w.dtype), cfg) @ w
    return _encode_core(params, cfg, x, H // p, W // p)


def qwen_vision_encode_video(params: Params, cfg: Qwen2VisionConfig,
                             frames: torch.Tensor) -> torch.Tensor:
    """Video frames through the tower: not ported yet (M15b)."""
    raise NotImplementedError(
        "Qwen2-VL video encoding (qwen_vision_encode_video, "
        "window_major_patches_video) is not ported yet: M15b")


def params_from_hf_qwen_vision(state: Dict[str, torch.Tensor],
                               cfg: Qwen2VisionConfig,
                               prefix: str = "visual.",
                               dtype=torch.float32, device="cuda") -> Params:
    """The tower's param dict from a HF Qwen2-VL state dict of host tensors
    (Linear weights [out, in] kept [in, out]; the Conv3d patch kernel
    [E, C, Tp, P, P] flattened to [C*Tp*P*P, E])."""
    from msd_tpu_torch.models.llama import upload

    def get(name):
        return state[prefix + name]

    names = {"norm1_w": ("norm1.weight", False),
             "norm1_b": ("norm1.bias", False),
             "norm2_w": ("norm2.weight", False),
             "norm2_b": ("norm2.bias", False),
             "qkv_w": ("attn.qkv.weight", True),
             "qkv_b": ("attn.qkv.bias", False),
             "proj_w": ("attn.proj.weight", True),
             "proj_b": ("attn.proj.bias", False),
             "fc1_w": ("mlp.fc1.weight", True),
             "fc1_b": ("mlp.fc1.bias", False),
             "fc2_w": ("mlp.fc2.weight", True),
             "fc2_b": ("mlp.fc2.bias", False)}
    blocks = {}
    for ours, (theirs, transpose) in names.items():
        stacked = torch.stack([get(f"blocks.{i}.{theirs}")
                               for i in range(cfg.depth)])
        blocks[ours] = upload(stacked, device, dtype, transpose)
    conv = get("patch_embed.proj.weight")
    return {
        "patch_embed": upload(conv.reshape(cfg.embed_dim, -1), device, dtype,
                              True),
        "blocks": blocks,
        "ln_q_w": upload(get("merger.ln_q.weight"), device, dtype),
        "ln_q_b": upload(get("merger.ln_q.bias"), device, dtype),
        "merge_fc1": upload(get("merger.mlp.0.weight"), device, dtype, True),
        "merge_fc1_b": upload(get("merger.mlp.0.bias"), device, dtype),
        "merge_fc2": upload(get("merger.mlp.2.weight"), device, dtype, True),
        "merge_fc2_b": upload(get("merger.mlp.2.bias"), device, dtype),
    }


def hf_qwen_vision_state(params: Params, cfg: Qwen2VisionConfig,
                         prefix: str = "visual.") -> Dict[str, torch.Tensor]:
    """The HF-layout state dict of a tower param dict (the inverse of
    ``params_from_hf_qwen_vision``), as views and transposes of its
    tensors."""
    names = {"norm1_w": "norm1.weight", "norm1_b": "norm1.bias",
             "norm2_w": "norm2.weight", "norm2_b": "norm2.bias",
             "qkv_w": "attn.qkv.weight", "qkv_b": "attn.qkv.bias",
             "proj_w": "attn.proj.weight", "proj_b": "attn.proj.bias",
             "fc1_w": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
             "fc2_w": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}
    pe = params["patch_embed"]
    st = {prefix + "patch_embed.proj.weight": pe.T.reshape(
        cfg.embed_dim, cfg.in_channels, cfg.temporal_patch_size,
        cfg.patch_size, cfg.patch_size)}
    for i in range(cfg.depth):
        for ours, theirs in names.items():
            w = params["blocks"][ours][i]
            st[f"{prefix}blocks.{i}.{theirs}"] = w.T if w.dim() == 2 else w
    st[prefix + "merger.ln_q.weight"] = params["ln_q_w"]
    st[prefix + "merger.ln_q.bias"] = params["ln_q_b"]
    st[prefix + "merger.mlp.0.weight"] = params["merge_fc1"].T
    st[prefix + "merger.mlp.0.bias"] = params["merge_fc1_b"]
    st[prefix + "merger.mlp.2.weight"] = params["merge_fc2"].T
    st[prefix + "merger.mlp.2.bias"] = params["merge_fc2_b"]
    return st
