"""Training records for the draft: the port of the JAX package's
``train/data_gen.py`` (reference: EAGLE/eagle/ge_data/
ge_data_all_llava15.py:94-262, which builds vicuna_v1 conversations from
LLaVA-instruct JSON, tokenizes them with the -200 placeholder, loss-masks
the assistant turns and runs the frozen target once per sample).

A record is in the draft trainer's shift-by-one layout (see
``train/draft_train.Batch``): row j pairs the embedding of token j+1
(``emb_next``; image rows carry the image feature) with the target hidden
at j (``hidden``) and is trained to predict the target hidden at j+1
(``target``) where ``loss_mask`` is 1. Arrays are numpy, float32 for the
float fields (a bf16 forward is cast exactly).

- a tokenized conversation: ``build_conversation_ids`` (the port's own
  ``utils/conversation`` and ``mm_utils.tokenizer_image_token``),
  ``make_training_record`` and ``generate_dataset``, which writes
  ``rec_%06d.npz`` files in JAX's keys and dtypes;
- token ids: ``make_record_from_ids`` runs the frozen target again over
  the ids (``teacher_forward``), or in the verify step's program shape
  (``teacher_forward_verify_shaped``);
- the engine's own trajectory: ``record_from_traj`` takes the hiddens the
  decode engine computed (``generate(collect_hiddens=True)``);
- Qwen2-VL: ``make_qwen_record_from_ids`` over ``qwen_teacher_forward``
  (the inline image span and mrope positions, no expansion).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlamaConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import expand_ids, fuse_embeddings
from msd_tpu_torch.ops.attention import causal_prefill_bias
from msd_tpu_torch.utils.conversation import (DEFAULT_VICUNA_SYSTEM,
                                              Conversation)
from msd_tpu_torch.utils.mm_utils import (process_image,
                                          tokenizer_image_token)


def _np(x: torch.Tensor) -> np.ndarray:
    x = x.detach()
    return (x.float() if x.is_floating_point() else x).cpu().numpy()


def build_conversation_ids(tokenizer, turns: Sequence[Tuple[str, str]],
                           with_image: bool,
                           system: str = DEFAULT_VICUNA_SYSTEM
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize a multi-turn conversation; loss_mask=1 on assistant replies.

    turns: [(user_msg, assistant_msg), ...]; the first user message gets the
    <image>\\n prefix when with_image (ge_data_all_llava15.py:94-176). The
    mask covers each reply and its trailing sep2, found by tokenizing the
    prompt up to the reply's start and end.
    """
    conv = Conversation(system=system)
    for i, (u, a) in enumerate(turns):
        if i == 0 and with_image:
            u = "<image>\n" + u
        conv.append_message(conv.roles[0], u)
        conv.append_message(conv.roles[1], a)
    ids = tokenizer_image_token(conv.get_prompt(), tokenizer)

    mask = np.zeros_like(ids, np.float32)
    cursor = conv.system + conv.sep if conv.system else ""
    for i, (u, a) in enumerate(turns):
        if i == 0 and with_image:
            u = "<image>\n" + u
        cursor += f"{conv.roles[0]}: {u}{conv.sep}"
        n_before = len(tokenizer_image_token(
            cursor + f"{conv.roles[1]}:", tokenizer))
        cursor += f"{conv.roles[1]}: {a}{conv.sep2}"
        n_after = len(tokenizer_image_token(cursor, tokenizer))
        mask[n_before:n_after] = 1.0
    return ids, mask


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


def make_training_record(params: Dict, cfg: LlamaConfig, tokenizer,
                         turns: Sequence[Tuple[str, str]],
                         img_feats: Optional[torch.Tensor] = None,
                         n_img: int = 0, pad_to: int = 512,
                         system: str = DEFAULT_VICUNA_SYSTEM
                         ) -> Dict[str, np.ndarray]:
    """The record of one conversation (``build_conversation_ids``, the ids
    cut to ``pad_to``) from one frozen-target forward; ``img_feats``: the
    projected image rows [n_img, H] on the device of ``params``, or None
    for a text-only conversation."""
    with_image = img_feats is not None and n_img > 0
    ids, loss_mask = build_conversation_ids(tokenizer, turns, with_image,
                                            system=system)
    ids = ids[:pad_to]
    loss_mask = loss_mask[:pad_to]
    img_positions = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
    img_pos = int(img_positions[0]) if len(img_positions) else pad_to
    out = teacher_forward(params, cfg, ids, img_feats, img_pos, n_img, pad_to)
    return _shifted_record(out, ids, loss_mask, img_pos, n_img, with_image)


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
    return _shifted_record(out, ids, loss_mask, img_pos, n_img, with_image)


def expand_loss_mask(loss_mask: np.ndarray, n_ids: int, img_pos: int,
                     n_img: int, with_image: bool, rows: int) -> np.ndarray:
    """A loss mask over the ``n_ids`` unexpanded ids moved to the
    post-expansion coordinates of ``rows`` rows (image rows 0)."""
    exp_mask = np.zeros((rows,), np.float32)
    if with_image:
        exp_mask[:img_pos] = loss_mask[:img_pos]
        exp_mask[img_pos + n_img:img_pos + n_img + n_ids - img_pos - 1] = \
            loss_mask[img_pos + 1:]
    else:
        exp_mask[:n_ids] = loss_mask
    return exp_mask


def _shifted_record(out: Dict[str, np.ndarray], ids: np.ndarray,
                    loss_mask: np.ndarray, img_pos: int, n_img: int,
                    with_image: bool) -> Dict[str, np.ndarray]:
    """The trainer record of a teacher forward ``out``: the loss mask in
    post-expansion coordinates, then the shift by one (row j pairs
    emb(t_{j+1}) with hidden_j and is trained toward hidden_{j+1})."""
    P_exp = out["hidden"].shape[0]
    e_len = len(ids) + (n_img - 1 if with_image else 0)
    exp_mask = expand_loss_mask(loss_mask, len(ids), img_pos, n_img,
                                with_image, P_exp)
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


def generate_dataset(params: Dict, cfg: LlamaConfig, tokenizer,
                     samples: List[Dict], out_dir: str, *,
                     encode_image_fn=None, n_img: int = 0, pad_to: int = 512,
                     start: int = 0, end: Optional[int] = None) -> int:
    """Write the records of ``samples`` [start, end) to
    ``out_dir/rec_%06d.npz`` (the allocation.py-style shard: one process
    per range); returns how many were written. A sample is
    ``{"turns": [(user, assistant), ...], "image": HWC array, PIL image or
    None}``; with ``n_img`` and ``encode_image_fn`` (CLIP-normalized
    pixels [3, S, S] on the device of ``params`` -> projected rows
    [n_img, H]) its image goes through ``process_image`` and the encoder.
    A record whose loss mask is empty (the answer cut away by ``pad_to``)
    is skipped."""
    os.makedirs(out_dir, exist_ok=True)
    end = end if end is not None else len(samples)
    dev = params["embed_tokens"].device
    n = 0
    for i in range(start, min(end, len(samples))):
        s = samples[i]
        feats = None
        if n_img and s.get("image") is not None and encode_image_fn:
            feats = encode_image_fn(
                torch.from_numpy(process_image(s["image"])).to(dev))
        rec = make_training_record(params, cfg, tokenizer, s["turns"],
                                   img_feats=feats, n_img=n_img if feats
                                   is not None else 0, pad_to=pad_to)
        if float(rec["loss_mask"].sum()) == 0.0:
            # answer span truncated away by pad_to: a useless record
            print(f"generate_dataset: skipping sample {i} "
                  f"(empty loss mask at pad_to={pad_to})")
            continue
        np.savez(os.path.join(out_dir, f"rec_{i:06d}.npz"), **rec)
        n += 1
    return n


@torch.no_grad()
def qwen_teacher_forward(params: Dict, tcfg, ids: np.ndarray,
                         img_feats: Optional[torch.Tensor], img_start: int,
                         n_img: int, grid_hw, pad_to: int
                         ) -> Dict[str, np.ndarray]:
    """Qwen2-VL teacher forward (the ge_data_all_qwen2vl.py analog): the
    ids padded to ``pad_to``, the inline image span fused
    (``fuse_qwen_embeddings``) and its rows rotated by their 3-D mrope
    positions (``mrope_positions`` gathered into per-token tables by
    ``mrope_gather``); 1-D rope without an image. ``tcfg`` is a
    ``Qwen2VLTextConfig`` (or a ``LlamaConfig`` for a text-only call)."""
    from msd_tpu_torch.models.qwen2vl import (embed_ids,
                                              fuse_qwen_embeddings,
                                              mrope_gather, mrope_positions)

    lc = tcfg.as_llama() if hasattr(tcfg, "as_llama") else tcfg
    dev = params["embed_tokens"].device
    padded = np.zeros((pad_to,), np.int32)
    padded[:len(ids)] = ids
    padded_t = torch.from_numpy(padded).to(dev)
    cos_t, sin_t = L.make_rope(lc, pad_to + 64, dev)
    if n_img > 0 and img_feats is not None:
        fused = fuse_qwen_embeddings(params["embed_tokens"], padded_t,
                                     img_feats, img_start, n_img)
        gh, gw = grid_hw
        pos3, _ = mrope_positions(pad_to, img_start, n_img, gh, gw)
        cos_t, sin_t = mrope_gather(cos_t, sin_t,
                                    torch.from_numpy(pos3).to(dev),
                                    tcfg.mrope_section)
    else:
        fused = embed_ids(params["embed_tokens"], padded_t)
    kv = L.init_kv_cache(lc, pad_to, fused.dtype, dev)
    hidden, _ = L.llama_forward(params, lc, fused,
                                torch.arange(pad_to, device=dev), kv, 0,
                                causal_prefill_bias(pad_to, pad_to,
                                                    device=dev),
                                cos_t, sin_t)
    return {"fused": _np(fused), "hidden": _np(hidden), "exp_ids": padded}


def make_qwen_record_from_ids(params: Dict, tcfg, ids: np.ndarray,
                              loss_mask: np.ndarray, pad_to: int,
                              img_feats: Optional[torch.Tensor] = None,
                              grid_hw=None) -> Dict[str, np.ndarray]:
    """Qwen2-VL training record: the inline <|image_pad|> span (its rows
    ``img_feats`` [n_img, H], ``grid_hw`` the merged grid), no expansion,
    the shift by one."""
    from msd_tpu_torch.models.qwen2vl import IMAGE_PAD_ID

    ids = np.asarray(ids, np.int32)[:pad_to]
    loss_mask = np.asarray(loss_mask, np.float32)[:pad_to]
    pos = np.nonzero(ids == IMAGE_PAD_ID)[0]
    img_start = int(pos[0]) if len(pos) else pad_to
    n_img = int(len(pos))

    out = qwen_teacher_forward(params, tcfg, ids, img_feats, img_start,
                               n_img, grid_hw, pad_to)
    fused, hidden = out["fused"], out["hidden"]
    e_len = len(ids)
    exp_mask = np.zeros((pad_to,), np.float32)
    exp_mask[:e_len] = loss_mask
    emb_next = np.concatenate([fused[1:], np.zeros_like(fused[:1])])
    target = np.concatenate([hidden[1:], np.zeros_like(hidden[:1])])
    tmask = np.concatenate([exp_mask[1:], np.zeros((1,), np.float32)])
    tmask[e_len - 1:] = 0.0
    j = np.arange(pad_to)
    img_mask = (j + 1 >= img_start) & (j + 1 < img_start + n_img)
    return {"emb_next": emb_next, "hidden": hidden, "target": target,
            "loss_mask": tmask, "attn_len": np.int32(e_len),
            "img_mask": img_mask, "exp_ids": out["exp_ids"]}
