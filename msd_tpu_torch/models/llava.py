"""LLaVA-1.5 multimodal assembly: vision tower -> projector -> embedding
fusion.

The port of the JAX package's ``models/llava.py`` (reference:
LLaVA/llava/model/llava_arch.py:100-324 and
multimodal_projector/builder.py:33-50, mlp2x_gelu 1024 -> 4096). An image
is encoded once per request (``encode_image``; with ``s2_scales`` the S2
multi-scale tower). One image's fusion is a gather/select: expanded row j
is a text-token embedding (index j, or j - (n_img - 1) past the
placeholder) or an image feature, selected by position masks. Several
images (``fuse_embeddings_multi``) and LLaVA-1.6's anyres tiles
(``merge_anyres_features``, ``unpad_feature_grid``) give a variable-length
fused block, which the engine prefills as it is
(``spec_engine.prefill_prefused``); here it is built on the table's
device, where the JAX package builds it on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

import torch
import torch.nn.functional as F

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlavaConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.clip_vit import clip_encode, clip_encode_s2

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
    the projector (``llava_params["projector"]``). With ``cfg.s2_scales``
    the pixels are at the largest scale and the tower's features are the
    S2 multi-scale concatenation (clip_encoder.py:92-147), [n_img,
    vision_hidden * len(scales)], before the projector."""
    if cfg.s2_scales:
        feats = clip_encode_s2(llava_params["vision"], cfg.vision, pixels,
                               cfg.s2_scales)
    else:
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


def fuse_embeddings(params: Dict, ids: torch.Tensor,
                    img_feats: torch.Tensor, img_pos,
                    out_len: int) -> torch.Tensor:
    """Fused embeddings [out_len, H] with img_feats [n_img, H] spliced in at
    the placeholder. Rows past the real prompt are garbage-but-masked.
    The text rows are ``llama.embed_tokens`` of ``params`` (a tree holding
    ``embed_tokens``; a tensor-parallel one gathers its column shards)."""
    n_img = img_feats.shape[0]
    safe_ids = torch.where(ids == IMAGE_TOKEN_INDEX, torch.zeros_like(ids),
                           ids)
    exp_ids = expand_ids(safe_ids, img_pos, n_img, out_len)
    text_emb = L.embed_tokens(params, exp_ids)
    j = torch.arange(out_len, device=ids.device)
    in_img = (j >= img_pos) & (j < img_pos + n_img)
    img_idx = torch.clamp(j - img_pos, 0, n_img - 1)
    img_emb = img_feats[img_idx].to(text_emb.dtype)
    return torch.where(in_img[:, None], img_emb, text_emb)


# ---------------------------------------------------------------------------
# anyres 'spatial'/'spatial_unpad' merge (llava_arch.py:100-200) and
# multi-image fusion (llava_arch.py:229-324): per-request variable shapes;
# the fused block feeds the engine's prefused prefill
# ---------------------------------------------------------------------------

def unpad_feature_grid(grid: torch.Tensor, original_size) -> torch.Tensor:
    """Crop the aspect-ratio padding off a [gh, gw, H] feature grid
    (llava_arch.py:100-128 unpad_image; original_size is (width, height));
    a view of ``grid``."""
    ow, oh = original_size
    ch, cw = grid.shape[:2]
    if ow / oh > cw / ch:
        new_h = int(oh * (cw / ow))
        pad = (ch - new_h) // 2
        return grid[pad:ch - pad]
    new_w = int(ow * (ch / oh))
    pad = (cw - new_w) // 2
    return grid[:, pad:cw - pad]


def merge_anyres_features(tile_feats: torch.Tensor, grid_wh, original_size,
                          num_patches_per_side: int,
                          image_newline: Optional[torch.Tensor] = None,
                          mode: str = "spatial_unpad") -> torch.Tensor:
    """[1 + n_tiles, P, H] projected tile features -> merged [N, H]
    (llava_arch.py:153-200, mm_patch_merge_type 'spatial',
    'spatial_unpad' or 'flat').

    tile_feats[0] is the base (global) view; grid_wh = (n_patch_w,
    n_patch_h) from ``get_anyres_image_grid_shape``; original_size =
    (width, height) of the raw image; image_newline: an optional [H]
    separator appended after every spatial row under 'unpad' modes. The
    tiles are rastered into one [n_patch_h * s, n_patch_w * s, H] grid
    (s = num_patches_per_side), unpadded under 'unpad' modes, and follow
    the base view's rows."""
    base = tile_feats[0]
    H = tile_feats.shape[-1]
    if tile_feats.shape[0] == 1:
        if "unpad" in mode and image_newline is not None:
            return torch.cat([base, image_newline[None].to(base.dtype)], 0)
        return base
    s = num_patches_per_side
    npw, nph = grid_wh
    if nph * npw != tile_feats.shape[0] - 1:
        raise ValueError(f"grid {tuple(grid_wh)} != "
                         f"{tile_feats.shape[0] - 1} tiles")
    tiles = tile_feats[1:].reshape(nph, npw, s, s, H)
    # (nph, npw, s, s, H) -> (nph, s, npw, s, H) -> raster [nph*s, npw*s, H]
    g = tiles.permute(0, 2, 1, 3, 4).reshape(nph * s, npw * s, H)
    if "unpad" in mode:
        g = unpad_feature_grid(g, original_size)
        if image_newline is not None:
            col = image_newline.to(g.dtype).expand(g.shape[0], 1, H)
            g = torch.cat([g, col], dim=1)
    return torch.cat([base, g.reshape(-1, H)], 0)


def fuse_embeddings_multi(params: Dict, ids,
                          feats_list: Sequence[torch.Tensor]):
    """Multi-image fusion: each image's features spliced at its placeholder
    (llava_arch.py:229-324, bs=1), on the table's device.

    params: a tree holding ``embed_tokens`` [V, H], whose text rows are
    ``llama.embed_tokens`` of it (as ``fuse_embeddings``'s: a
    tensor-parallel tree's column shards gathered, bitwise). ids: [T] host
    ids (numpy or a tensor) with one IMAGE_TOKEN_INDEX per image, k of
    them in order; feats_list: k feature blocks [n_i, H]. Returns (fused
    [T', H] in the table's dtype, exp_ids [T'] int32 with 0 at image rows
    and the raw ids elsewhere, img_row_mask [T'] bool), T' = T - k +
    sum(n_i). A text row's embedding is the table's row of max(id, 0)."""
    embed_table = params["embed_tokens"]
    ids = np.asarray(ids.cpu() if isinstance(ids, torch.Tensor) else ids)
    spots = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
    if len(spots) != len(feats_list):
        raise ValueError(f"{len(spots)} image tokens vs {len(feats_list)} "
                         f"feature blocks")
    id_chunks, mask_chunks = [], []
    prev = 0
    for pos, feats in zip(spots, feats_list):
        seg = ids[prev:pos]
        id_chunks += [seg, np.zeros(feats.shape[0], ids.dtype)]
        mask_chunks += [np.zeros(len(seg), bool),
                        np.ones(feats.shape[0], bool)]
        prev = pos + 1
    id_chunks.append(ids[prev:])
    mask_chunks.append(np.zeros(len(ids) - prev, bool))
    dev = embed_table.device
    exp_ids = torch.from_numpy(
        np.concatenate(id_chunks).astype(np.int32)).to(dev)
    rows = torch.from_numpy(np.concatenate(mask_chunks)).to(dev)
    fused = L.embed_tokens(params, torch.clamp(exp_ids, min=0))
    if feats_list:
        fused[rows] = torch.cat([f.to(dev, embed_table.dtype)
                                 for f in feats_list])
    return fused, exp_ids, rows


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
