"""Training records for the draft: the port of the JAX package's
``train/data_gen.py`` for records built from token ids or from the engine's
own trajectory.

A record is in the draft trainer's shift-by-one layout (see
``train/draft_train.Batch``): row j pairs the embedding of token j+1
(``emb_next``; image rows carry the image feature) with the target hidden
at j (``hidden``) and is trained to predict the target hidden at j+1
(``target``) where ``loss_mask`` is 1. Arrays are numpy, float32 for the
float fields (a bf16 forward is cast exactly).

``record_from_traj`` takes the hiddens the decode engine computed
(``generate(collect_hiddens=True)``); ``make_record_from_ids`` runs the
frozen target again over the ids (``teacher_forward``), or in the verify
step's program shape (``teacher_forward_verify_shaped``). The records of a
tokenized conversation (``build_conversation_ids``,
``make_training_record``, ``generate_dataset``) need a tokenizer and the
chat template and are not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlamaConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import expand_ids, fuse_embeddings
from msd_tpu_torch.ops.attention import causal_prefill_bias


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    return (x.float() if x.is_floating_point() else x).cpu().numpy()


def _fuse(params: Dict, ids: np.ndarray, img_feats: Optional[torch.Tensor],
          img_pos: int, n_img: int, pad_to: int):
    """(fused [P_exp, H], expanded ids [P_exp]) of ids padded to pad_to."""
    dev = params["embed_tokens"].device
    P_exp = pad_to + max(n_img - 1, 0)
    padded = np.zeros((pad_to,), np.int32)
    padded[:len(ids)] = ids
    padded_t = torch.from_numpy(padded).to(dev)
    if n_img > 0:
        fused = fuse_embeddings(params["embed_tokens"], padded_t, img_feats,
                                img_pos, P_exp)
        exp_ids = expand_ids(torch.clamp(padded_t, min=0), img_pos, n_img,
                             P_exp)
    else:
        fused = params["embed_tokens"][torch.clamp(padded_t, min=0).long()]
        exp_ids = padded_t
    return fused, exp_ids


@torch.no_grad()
def teacher_forward(params: Dict, cfg: LlamaConfig, ids: np.ndarray,
                    img_feats: Optional[torch.Tensor], img_pos: int,
                    n_img: int, pad_to: int) -> Dict[str, np.ndarray]:
    """One frozen-target forward -> post-norm hidden states + fused
    embeddings, on the device of ``params``."""
    fused, exp_ids = _fuse(params, ids, img_feats, img_pos, n_img, pad_to)
    P_exp = fused.shape[0]
    dev = fused.device
    cos_t, sin_t = L.make_rope(cfg, P_exp + 8, dev)
    kv = L.init_kv_cache(cfg, P_exp, fused.dtype, dev)
    hidden, _ = L.llama_forward(params, cfg, fused,
                                torch.arange(P_exp, device=dev), kv, 0,
                                causal_prefill_bias(P_exp, P_exp, device=dev),
                                cos_t, sin_t)
    return {"fused": _np(fused), "hidden": _np(hidden),
            "exp_ids": _np(exp_ids)}


def _verify_shaped_run(cfg: LlamaConfig, chunk: int, cache_len: int,
                       params: Dict, fused_pad: torch.Tensor,
                       cos_t: torch.Tensor, sin_t: torch.Tensor
                       ) -> torch.Tensor:
    """Chunked causal forward at the verify program shape: ``chunk`` rows
    at a time against a ``cache_len``-row KV cache, each chunk's K/V
    written into the cache before the next (the JAX ``lax.scan``)."""
    Pc = fused_pad.shape[0]
    dev = fused_pad.device
    kv = L.init_kv_cache(cfg, cache_len, fused_pad.dtype, dev)
    hs = []
    for start in range(0, Pc, chunk):
        pos = start + torch.arange(chunk, device=dev, dtype=torch.int32)
        bias = causal_prefill_bias(chunk, cache_len, start=start, device=dev)
        h, _ = L.llama_forward(params, cfg, fused_pad[start:start + chunk],
                               pos, kv, start, bias, cos_t, sin_t)
        hs.append(h)
    return torch.cat(hs)


@torch.no_grad()
def teacher_forward_verify_shaped(params: Dict, cfg: LlamaConfig,
                                  ids: np.ndarray,
                                  img_feats: Optional[torch.Tensor],
                                  img_pos: int, n_img: int, pad_to: int,
                                  chunk: int, cache_len: int
                                  ) -> Dict[str, np.ndarray]:
    """Teacher forward in the engine verify's program shape: ``chunk``-row
    forwards against a ``cache_len`` preallocated KV cache (the verify runs
    ``llama_forward`` over tree.num_nodes rows against Statics.s_target
    cache rows), so labels come from the shape acceptance compares
    against."""
    fused, exp_ids = _fuse(params, ids, img_feats, img_pos, n_img, pad_to)
    P_exp = fused.shape[0]
    Pc = ((P_exp + chunk - 1) // chunk) * chunk
    cache_len = max(cache_len, Pc)
    cos_t, sin_t = L.make_rope(cfg, cache_len + 8, fused.device)
    fused_pad = torch.zeros((Pc, fused.shape[1]), dtype=fused.dtype,
                            device=fused.device)
    fused_pad[:P_exp] = fused
    hidden = _verify_shaped_run(cfg, chunk, cache_len, params, fused_pad,
                                cos_t, sin_t)[:P_exp]
    return {"fused": _np(fused), "hidden": _np(hidden),
            "exp_ids": _np(exp_ids)}


def make_record_from_ids(params: Dict, cfg: LlamaConfig, ids: np.ndarray,
                         loss_mask: np.ndarray, pad_to: int,
                         img_feats: Optional[torch.Tensor] = None,
                         n_img: int = 0, img_pos: Optional[int] = None,
                         verify_chunk: int = 0, cache_len: int = 0
                         ) -> Dict[str, np.ndarray]:
    """Record directly from token ids (on-policy distillation / custom
    data).

    ids: [T] (may contain IMAGE_TOKEN_INDEX); loss_mask: [T] 1.0 where the
    NEXT-token prediction at that source position should be trained.
    verify_chunk > 0 takes the teacher states at the engine verify's
    program shape (``teacher_forward_verify_shaped``) instead of one
    prefill forward.
    """
    ids = np.asarray(ids, np.int32)[:pad_to]
    loss_mask = np.asarray(loss_mask, np.float32)[:pad_to]
    with_image = img_feats is not None and n_img > 0
    if img_pos is None:
        pos = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
        img_pos = int(pos[0]) if len(pos) else pad_to

    if verify_chunk > 0:
        out = teacher_forward_verify_shaped(
            params, cfg, ids, img_feats, img_pos, n_img, pad_to,
            chunk=verify_chunk, cache_len=cache_len)
    else:
        out = teacher_forward(params, cfg, ids, img_feats, img_pos, n_img,
                              pad_to)
    P_exp = out["hidden"].shape[0]
    e_len = len(ids) + (n_img - 1 if with_image else 0)
    exp_mask = np.zeros((P_exp,), np.float32)
    if with_image:
        exp_mask[:img_pos] = loss_mask[:img_pos]
        exp_mask[img_pos + n_img:img_pos + n_img + len(ids) - img_pos - 1] = \
            loss_mask[img_pos + 1:]
    else:
        exp_mask[:len(ids)] = loss_mask

    fused, hidden = out["fused"], out["hidden"]
    emb_next = np.concatenate([fused[1:], np.zeros_like(fused[:1])])
    target = np.concatenate([hidden[1:], np.zeros_like(hidden[:1])])
    tmask = np.concatenate([exp_mask[1:], np.zeros((1,), np.float32)])
    tmask[e_len - 1:] = 0.0  # the last row predicts nothing
    j = np.arange(P_exp)
    img_mask = ((j + 1 >= img_pos) & (j + 1 < img_pos + n_img)) if with_image \
        else np.zeros((P_exp,), bool)
    return {"emb_next": emb_next, "hidden": hidden, "target": target,
            "loss_mask": tmask, "attn_len": np.int32(e_len),
            "img_mask": img_mask, "exp_ids": out["exp_ids"]}


def record_from_traj(traj_hidden: np.ndarray, exp_ids: np.ndarray, e0: int,
                     img_pos: int, n_img: int,
                     img_feats, embed_table: np.ndarray,
                     pad_to: int) -> Dict[str, np.ndarray]:
    """Trainer record from ENGINE-collected trajectory hiddens.

    traj_hidden/exp_ids: GenResult.traj_hidden / .exp_ids from
    ``generate(..., collect_hiddens=True)`` -- the hidden states the decode
    engine itself computed (prefill rows + committed verify rows), i.e. the
    exact values its draft-suffix path will read back at serve time. Unlike
    ``make_record_from_ids`` there is NO teacher re-forward, so the record
    carries decode-time numerics verbatim (no program-shape mismatch).

    e0: expanded prompt length; rows [e0-1, cur-1) get loss (the generated
    region); img_feats: [n_img, H] PROJECTED image tokens or None.
    """
    cur, H = traj_hidden.shape
    hidden = np.zeros((pad_to, H), np.float32)
    hidden[:min(cur, pad_to)] = np.asarray(traj_hidden[:pad_to], np.float32)
    ids_p = np.zeros((pad_to,), np.int32)
    ids_p[:min(cur, pad_to)] = np.asarray(exp_ids[:pad_to], np.int32)

    fused = np.asarray(embed_table, np.float32)[np.maximum(ids_p, 0)]
    with_image = img_feats is not None and n_img > 0
    if with_image:
        fused[img_pos:img_pos + n_img] = \
            np.asarray(img_feats, np.float32)[:pad_to - img_pos]
    emb_next = np.concatenate([fused[1:], np.zeros_like(fused[:1])])
    target = np.concatenate([hidden[1:], np.zeros_like(hidden[:1])])

    tmask = np.zeros((pad_to,), np.float32)
    lo = max(e0 - 1, 0)
    hi = min(cur - 1, pad_to - 1)
    if hi > lo:
        tmask[lo:hi] = 1.0
    j = np.arange(pad_to)
    img_mask = ((j + 1 >= img_pos) & (j + 1 < img_pos + n_img)) if with_image \
        else np.zeros((pad_to,), bool)
    return {"emb_next": emb_next, "hidden": hidden, "target": target,
            "loss_mask": tmask, "attn_len": np.int32(min(cur, pad_to)),
            "img_mask": img_mask, "exp_ids": ids_p}
