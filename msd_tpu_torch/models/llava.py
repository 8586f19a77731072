"""LLaVA-1.5 embedding fusion: projector and image-feature splicing.

The port of the JAX package's ``models/llava.py`` (projector and the
single-image fixed-shape fusion). Fusion is a gather/select: expanded row j
is a text-token embedding (index j, or j - (n_img - 1) past the
placeholder) or an image feature, selected by position masks.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX

Params = Dict


def projector_apply(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """mlp2x_gelu: Linear -> exact (erf) GELU in fp32 -> Linear.
    fc1 [Vh, H], fc2 [H, H] (``x @ W`` layout), biases [H]."""
    x = feats @ params["fc1"] + params["fc1_b"]
    x = F.gelu(x.float(), approximate="none").to(x.dtype)
    return x @ params["fc2"] + params["fc2_b"]


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
