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
LLaVA runs its tower in the model dtype. ``clip_encode`` takes a leading
batch of images (the JAX package's ``vmap``); ``clip_encode_s2`` is the S2
multi-scale tower, whose resize (``resize_linear``) reproduces
``jax.image.resize``'s antialiased linear weights.
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
    """Pre-LN transformer block. x: [..., T, H] (a leading dim batches
    images)."""
    h = x.shape[-1]
    nh = cfg.num_attention_heads
    d = h // nh
    scale = d ** -0.5
    heads = x.shape[:-1] + (nh, d)

    resid = x
    y = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_eps)
    q = (y @ lp["q_proj"] + lp["q_bias"]).reshape(heads)
    k = (y @ lp["k_proj"] + lp["k_bias"]).reshape(heads)
    v = (y @ lp["v_proj"] + lp["v_bias"]).reshape(heads)
    scores = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          k.float()) * scale
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    attn = torch.einsum("...hqk,...khd->...qhd", probs.float(),
                        v.float()).to(x.dtype)
    x = resid + attn.reshape(x.shape) @ lp["o_proj"] + lp["o_bias"]

    resid = x
    y = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_eps)
    y = quick_gelu(y @ lp["fc1"] + lp["fc1_b"])
    return resid + y @ lp["fc2"] + lp["fc2_b"]


def clip_encode(params: Params, cfg: ClipVisionConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """pixels: [..., 3, H, W] (CLIP-normalized; a leading dim batches
    images, as the JAX package's ``vmap``) -> patch features
    [..., num_patches, hidden] in the weights' dtype.

    Features come from hidden_states[select_layer] (HF indexing: index L
    means "after L blocks"; -2 of num_layers+1 entries = after
    num_layers-1 blocks), with the CLS token dropped
    (select_feature='patch'). Only those blocks run.
    """
    p = cfg.patch_size
    g = cfg.image_size // p
    dtype = params["patch_embed"].dtype
    lead = pixels.shape[:-3]
    # unfold into [..., g*g, 3*p*p]: conv-as-matmul, channel-major within
    # a patch, matching Conv2d(3, H, kernel=p, stride=p)
    x = pixels.to(dtype).reshape(lead + (3, g, p, g, p))
    n = len(lead)
    x = x.permute(*range(n), n + 1, n + 3, n, n + 2, n + 4)
    x = x.reshape(lead + (g * g, 3 * p * p)) @ params["patch_embed"]

    cls = params["class_embed"].expand(lead + (1, x.shape[-1]))
    x = torch.cat([cls, x], dim=-2) + params["pos_embed"]
    x = layer_norm(x, params["pre_ln_w"], params["pre_ln_b"],
                   cfg.layer_norm_eps)

    # run blocks up to the selected layer only: the reference discards the
    # rest of the tower anyway (clip_encoder.py:35-56)
    n_run = cfg.num_hidden_layers + 1 + cfg.select_layer  # -2 -> L-1 blocks
    layers = params["layers"]
    for li in range(n_run):
        x = _block({name: w[li] for name, w in layers.items()}, cfg, x)
    return x[..., 1:, :]  # drop CLS


def resize_weights(n_in: int, n_out: int, device="cuda") -> torch.Tensor:
    """[n_in, n_out] fp32 weights of ``jax.image.resize(..., "linear")``
    along one axis (jax.image.scale_and_translate with scale n_out / n_in,
    translation 0, antialiased): a triangle filter widened by 1/scale when
    downsampling, each output's weights normalised to sum 1, outputs whose
    sample lies outside the input zeroed."""
    f32 = dict(dtype=torch.float32, device=device)
    inv = 1.0 / torch.tensor(n_out / n_in, **f32)   # fp32, as JAX's
    kernel_scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, **f32) + 0.5) * inv - 0.5
    src = torch.arange(n_in, **f32)
    x = (sample[None, :] - src[:, None]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=0, keepdim=True)
    eps = torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(img: torch.Tensor, size: int) -> torch.Tensor:
    """[C, H, W] -> [C, size, size] in fp32, as ``jax.image.resize(img,
    (C, size, size), "linear")`` resamples: separable antialiased triangle
    weights (``resize_weights``); an axis whose size does not change is
    left as it is."""
    c, h, w = img.shape
    out = img.float()
    if h != size:
        out = torch.einsum("chw,hy->cyw", out,
                           resize_weights(h, size, img.device))
    if w != size:
        out = torch.einsum("cyw,wx->cyx", out,
                           resize_weights(w, size, img.device))
    return out


def clip_encode_s2(params: Params, cfg: ClipVisionConfig,
                   pixels: torch.Tensor, scales) -> torch.Tensor:
    """S2 multi-scale encoding (CLIPVisionTowerS2, clip_encoder.py:92-147;
    the public scaling_on_scales recipe).

    pixels: [3, S_max, S_max] at the largest scale. For each scale s the
    image is resized to s x s (``resize_linear``; not at all at the
    pixels' own size), split into (s/base)^2 base-size tiles, row-major,
    which go through the tower as one batch (each tile is base x base: no
    position-embedding interpolation); the tiles' feature grids are
    reassembled spatially and area-pooled back to the base grid, and the
    scales' features are concatenated channel-wise, smallest scale first:
    [num_patches, hidden * len(scales)]."""
    base = cfg.image_size
    g = base // cfg.patch_size  # base feature grid side
    outs = []
    for s in sorted(scales):
        k = s // base
        if k * base != s:
            raise ValueError(f"scale {s} must be a multiple of base {base}")
        img = pixels if s == pixels.shape[-1] else resize_linear(pixels, s)
        # [3, k*base, k*base] -> [k*k, 3, base, base] row-major tiles
        tiles = img.reshape(3, k, base, k, base).permute(1, 3, 0, 2, 4)
        feats = clip_encode(params, cfg, tiles.reshape(k * k, 3, base, base))
        # reassemble [k, k, g, g, H] -> [k*g, k*g, H], area-pool to [g, g, H]
        H = feats.shape[-1]
        grid = feats.reshape(k, k, g, g, H).permute(0, 2, 1, 3, 4)
        pooled = grid.reshape(g, k, g, k, H).mean(dim=(1, 3))
        outs.append(pooled.reshape(g * g, H))
    return torch.cat(outs, dim=-1)


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
