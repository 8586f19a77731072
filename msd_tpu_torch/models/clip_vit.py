"""CLIP ViT vision tower (ViT-L/14-336 shapes), as functions over a dict of
stacked per-layer weights like ``models/llama``.

The port of the JAX package's ``models/clip_vit.py`` (reference consumer:
LLaVA/llava/model/multimodal_encoder/clip_encoder.py:7-89): a frozen
CLIPVisionModel whose features are read after block ``select_layer`` (-2),
the CLS token dropped ('patch' mode): 576 patch features. The patch conv is
an unfold + matmul ([num_patches, 3*P*P] @ [3*P*P, H]); pre-LN blocks with
quick_gelu as in OpenAI CLIP. Layouts (``x @ W``): q/k/v/o ``[L, H, H]``,
fc1 ``[L, H, I]``, fc2 ``[L, I, H]``, ``patch_embed`` ``[3*P*P, H]``
(channel-major within a patch), ``pos_embed`` ``[num_patches + 1, H]``.
The tower computes in its weights' dtype (the pixels are cast to it), as
LLaVA runs its tower in the model dtype.
"""

from __future__ import annotations

from typing import Dict

import torch

from msd_tpu_torch.configs import ClipVisionConfig
from msd_tpu_torch.ops.norms import layer_norm

Params = Dict


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def init_clip_params(cfg: ClipVisionConfig, generator: torch.Generator,
                     device="cuda", dtype=torch.bfloat16) -> Params:
    """Random tower weights from ``generator``, drawn in ``dtype`` on
    ``device`` (normal * hidden^-0.5; LayerNorms at one, biases zero)."""
    h, inter = cfg.hidden_size, cfg.intermediate_size
    n, p = cfg.num_hidden_layers, cfg.patch_size
    scale = h ** -0.5

    def mat(*shape):
        return torch.randn(shape, generator=generator, dtype=dtype,
                           device=device).mul_(scale)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {"ln1_w": const(1.0, n, h), "ln1_b": const(0.0, n, h),
              "ln2_w": const(1.0, n, h), "ln2_b": const(0.0, n, h)}
    for name in ("q", "k", "v", "o"):
        layers[f"{name}_proj"] = mat(n, h, h)
        layers[f"{name}_bias"] = const(0.0, n, h)
    layers.update(fc1=mat(n, h, inter), fc1_b=const(0.0, n, inter),
                  fc2=mat(n, inter, h), fc2_b=const(0.0, n, h))
    return {
        "patch_embed": mat(p * p * 3, h),
        "class_embed": mat(h),
        "pos_embed": mat(cfg.num_patches + 1, h),
        "pre_ln_w": const(1.0, h), "pre_ln_b": const(0.0, h),
        "layers": layers,
    }


def _block(lp: Params, cfg: ClipVisionConfig, x: torch.Tensor) -> torch.Tensor:
    """Pre-LN transformer block. x: [T, H]."""
    t, h = x.shape
    nh = cfg.num_attention_heads
    d = h // nh
    scale = d ** -0.5

    resid = x
    y = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
    q = (y @ lp["q_proj"] + lp["q_bias"]).reshape(t, nh, d)
    k = (y @ lp["k_proj"] + lp["k_bias"]).reshape(t, nh, d)
    v = (y @ lp["v_proj"] + lp["v_bias"]).reshape(t, nh, d)
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    attn = torch.einsum("hqk,khd->qhd", probs.float(),
                        v.float()).to(x.dtype)
    x = resid + attn.reshape(t, h) @ lp["o_proj"] + lp["o_bias"]

    resid = x
    y = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
    y = quick_gelu(y @ lp["fc1"] + lp["fc1_b"])
    return resid + y @ lp["fc2"] + lp["fc2_b"]


def clip_encode(params: Params, cfg: ClipVisionConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [3, H, W] (CLIP-normalized) -> patch features
    [num_patches, hidden] in the weights' dtype.

    Features come from hidden_states[select_layer] (HF indexing: index L
    means "after L blocks"; -2 of num_layers+1 entries = after
    num_layers-1 blocks), with the CLS token dropped
    (select_feature='patch'). Only those blocks run.
    """
    p = cfg.patch_size
    g = cfg.image_size // p
    dtype = params["patch_embed"].dtype
    # unfold into [g*g, 3*p*p]: conv-as-matmul, channel-major within a
    # patch, matching Conv2d(3, H, kernel=p, stride=p)
    x = pixels.to(dtype).reshape(3, g, p, g, p)
    x = x.permute(1, 3, 0, 2, 4).reshape(g * g, 3 * p * p)
    x = x @ params["patch_embed"]

    cls = params["class_embed"][None, :]
    x = torch.cat([cls, x], dim=0) + params["pos_embed"]
    x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"],
                   cfg.layer_norm_eps)

    # run blocks up to the selected layer only: the reference discards the
    # rest of the tower anyway (clip_encoder.py:35-56)
    n_run = cfg.num_hidden_layers + 1 + cfg.select_layer  # -2 -> L-1 blocks
    layers = params["layers"]
    for li in range(n_run):
        x = _block({name: w[li] for name, w in layers.items()}, cfg, x)
    return x[1:]  # drop CLS


def params_from_hf_clip(state: Dict[str, torch.Tensor], cfg: ClipVisionConfig,
                        prefix: str = "vision_model.", dtype=torch.float32,
                        device="cuda") -> Params:
    """The tower from HF CLIPVisionModel weights: Linear [out, in] kept as
    ``x @ W`` [in, out]; the patch conv [H, 3, P, P] reshaped to the unfold
    layout [3*P*P, H] (channel-major within a patch)."""
    from msd_tpu_torch.models.llama import upload

    def get(name, transpose=False):
        return upload(state[prefix + name], device, dtype, transpose)

    names = {"ln1_w": ("layer_norm1.weight", False),
             "ln1_b": ("layer_norm1.bias", False),
             "ln2_w": ("layer_norm2.weight", False),
             "ln2_b": ("layer_norm2.bias", False),
             "fc1": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
             "fc2": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False)}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("o", "out_proj")):
        names[f"{ours}_proj"] = (f"self_attn.{theirs}.weight", True)
        names[f"{ours}_bias"] = (f"self_attn.{theirs}.bias", False)
    layers = {ours: torch.stack([
        get(f"encoder.layers.{i}.{theirs}", transpose)
        for i in range(cfg.num_hidden_layers)])
        for ours, (theirs, transpose) in names.items()}
    conv = state[prefix + "embeddings.patch_embedding.weight"]
    return {
        "patch_embed": upload(conv.reshape(cfg.hidden_size, -1), device,
                              dtype, True),
        "class_embed": get("embeddings.class_embedding"),
        "pos_embed": get("embeddings.position_embedding.weight"),
        "pre_ln_w": get("pre_layrnorm.weight"),
        "pre_ln_b": get("pre_layrnorm.bias"),
        "layers": layers,
    }
