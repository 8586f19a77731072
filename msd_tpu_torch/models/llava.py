"""LLaVA-1.5 multimodal assembly: vision tower -> projector -> embedding
fusion.

The port of the JAX package's ``models/llava.py`` for one image per prompt
(reference: LLaVA/llava/model/llava_arch.py:145-324 and
multimodal_projector/builder.py:33-50, mlp2x_gelu 1024 -> 4096). An image
is encoded once per request (``encode_image``). Fusion is a gather/select:
expanded row j is a text-token embedding (index j, or j - (n_img - 1) past
the placeholder) or an image feature, selected by position masks.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlavaConfig
from msd_tpu_torch.models.clip_vit import clip_encode

Params = Dict


def init_projector_params(cfg: LlavaConfig, generator: torch.Generator,
                          device="cuda", dtype=torch.bfloat16) -> Params:
    """Random mlp2x_gelu weights from ``generator``: fc1 [Vh, H] * Vh^-0.5,
    fc2 [H, H] * H^-0.5, zero biases."""
    vh, th = cfg.mm_hidden_size, cfg.text.hidden_size

    def mat(rows, cols):
        return torch.randn(rows, cols, generator=generator, dtype=dtype,
                           device=device).mul_(rows ** -0.5)

    return {"fc1": mat(vh, th),
            "fc1_b": torch.zeros(th, dtype=dtype, device=device),
            "fc2": mat(th, th),
            "fc2_b": torch.zeros(th, dtype=dtype, device=device)}


def projector_apply(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """mlp2x_gelu: Linear -> exact (erf) GELU in fp32 -> Linear.
    fc1 [Vh, H], fc2 [H, H] (``x @ W`` layout), biases [H]."""
    x = feats @ params["fc1"] + params["fc1_b"]
    x = F.gelu(x.float(), approximate="none").to(x.dtype)
    return x @ params["fc2"] + params["fc2_b"]


def encode_image(llava_params: Params, cfg: LlavaConfig,
                 pixels: torch.Tensor) -> torch.Tensor:
    """[3, H, W] CLIP-normalized pixels -> projected image rows
    [n_img, text_hidden]: the CLIP tower (``llava_params["vision"]``), then
    the projector (``llava_params["projector"]``)."""
    feats = clip_encode(llava_params["vision"], cfg.vision, pixels)
    return projector_apply(llava_params["projector"], feats)


def expand_ids(ids: torch.Tensor, img_pos, n_img: int, out_len: int,
               sentinel: int = 0) -> torch.Tensor:
    """Expand ids [P] holding one image placeholder at img_pos into the
    post-expansion layout [out_len]: rows [img_pos, img_pos + n_img) get
    ``sentinel``, the others the corresponding text token."""
    j = torch.arange(out_len, device=ids.device)
    before = j < img_pos
    in_img = (j >= img_pos) & (j < img_pos + n_img)
    src = torch.where(before, j, j - (n_img - 1))
    src = torch.clamp(src, 0, ids.shape[0] - 1)
    toks = ids[src]
    return torch.where(in_img, torch.full_like(toks, sentinel), toks)


def fuse_embeddings(embed_table: torch.Tensor, ids: torch.Tensor,
                    img_feats: torch.Tensor, img_pos,
                    out_len: int) -> torch.Tensor:
    """Fused embeddings [out_len, H] with img_feats [n_img, H] spliced in at
    the placeholder. Rows past the real prompt are garbage-but-masked."""
    n_img = img_feats.shape[0]
    safe_ids = torch.where(ids == IMAGE_TOKEN_INDEX, torch.zeros_like(ids),
                           ids)
    exp_ids = expand_ids(safe_ids, img_pos, n_img, out_len)
    text_emb = embed_table[exp_ids.long()]
    j = torch.arange(out_len, device=ids.device)
    in_img = (j >= img_pos) & (j < img_pos + n_img)
    img_idx = torch.clamp(j - img_pos, 0, n_img - 1)
    img_emb = img_feats[img_idx].to(text_emb.dtype)
    return torch.where(in_img[:, None], img_emb, text_emb)


def params_from_hf_projector(state: Dict[str, torch.Tensor],
                             dtype=torch.float32, device="cuda",
                             prefix: str = "model.mm_projector.") -> Params:
    """The projector from a LLaVA state dict (``{prefix}0.*``, ``{prefix}2.*``
    Linear layers, stored [out, in])."""
    from msd_tpu_torch.models.llama import upload

    def get(name, transpose=False):
        return upload(state[prefix + name], device, dtype, transpose)

    return {"fc1": get("0.weight", True), "fc1_b": get("0.bias"),
            "fc2": get("2.weight", True), "fc2_b": get("2.bias")}
