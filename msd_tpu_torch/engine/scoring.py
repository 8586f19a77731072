"""Teacher-forced scoring for ``loglikelihood`` requests.

The port of the JAX package's ``engine/scoring.py`` (LLaVA layout): one
causal forward over [context + continuation] with the context labels
masked out (lmms-eval's llava_msd_calibrated.py:231-305), returning what
lmms-eval's ``loglikelihood`` returns: the continuation's summed
log-probability and whether every continuation token is the greedy one.

The image-expanded prefill runs through ``llama_forward`` with the causal
prefill bias, so every layer takes the plain ``masked_attention`` path
(the decode kernel only takes single decode rows). Each row's
log-probability is ``logit[next] - logsumexp(logits)`` over the [T, V]
fp32 logits. The request is padded to the engine's prompt bucket, as the
JAX program is, so every (context, continuation) pair of one padded
length runs the same shapes. Nothing here is captured in a graph.
``qwen_score_program`` scores inline-image (Qwen2-VL) requests with mrope
positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from msd_tpu_torch.configs import LlamaConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import expand_ids, fuse_embeddings
from msd_tpu_torch.models.qwen2vl import (embed_ids, fuse_qwen_embeddings,
                                          mrope_gather)
from msd_tpu_torch.ops.attention import causal_prefill_bias


def _score_rows(tp: Dict, exp_ids: torch.Tensor, hidden: torch.Tensor,
                cont_first: int, cont_end: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum log p(token) and the greedy matches over rows
    [cont_first - 1, cont_end - 1).

    exp_ids: [T] expanded token ids; hidden: [T, H] final hidden states;
    row r predicts the token at r + 1."""
    logits = L.lm_head(tp, hidden)                        # [T, V] fp32
    next_ids = torch.cat([exp_ids[1:].long(),
                          exp_ids.new_zeros(1, dtype=torch.long)])
    lse = torch.logsumexp(logits, dim=-1)
    tok_lp = logits.gather(-1, next_ids[:, None])[:, 0] - lse
    greedy = logits.argmax(dim=-1) == next_ids
    rows = torch.arange(exp_ids.shape[0], device=exp_ids.device)
    mask = (rows >= cont_first - 1) & (rows < cont_end - 1)
    lp_sum = torch.where(mask, tok_lp, torch.zeros_like(tok_lp)).sum()
    n_match = (mask & greedy).sum()
    n_cont = mask.sum()
    return lp_sum, n_match, n_cont


def score_program(tcfg: LlamaConfig, n_img: int, params: Dict,
                  ids: torch.Tensor, total_len: int, cont_start: int,
                  img_feats: Optional[torch.Tensor], img_pos: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LLaVA-style (image-token expansion) scoring forward.

    ids: [P_pad] unexpanded (IMAGE_TOKEN_INDEX at img_pos when the request
    has an image); total_len: the prompt + continuation length
    (unexpanded); cont_start: the index of the first continuation token
    (unexpanded). The image always sits in the context, so both indices
    shift by the same expansion offset. Returns (logprob_sum,
    n_greedy_match, n_cont) as 0-dim tensors."""
    tp = params["target"]
    n_img_eff = n_img if img_feats is not None else 0
    p_pad = ids.shape[0]
    off = max(n_img_eff - 1, 0)
    p_exp = p_pad + off
    if n_img_eff > 0:
        fused = fuse_embeddings(tp, ids, img_feats, img_pos, p_exp)
        exp_ids = expand_ids(torch.clamp(ids, min=0), img_pos, n_img_eff,
                             p_exp)
    else:
        fused = L.embed_tokens(tp, torch.clamp(ids, min=0))
        exp_ids = ids
    device = ids.device
    positions = torch.arange(p_exp, dtype=torch.int32, device=device)
    bias = causal_prefill_bias(p_exp, p_exp, device=device)
    kv = L.init_kv_cache(tcfg, p_exp, fused.dtype, device,
                         mesh=tp.get("mesh"))
    hidden, _ = L.llama_forward(tp, tcfg, fused, positions, kv, 0, bias,
                                params["cos_t"], params["sin_t"])
    return _score_rows(tp, exp_ids, hidden, cont_start + off,
                       total_len + off)


def qwen_score_program(tcfg: LlamaConfig, n_img: int, mrope_section,
                       params: Dict, ids: torch.Tensor, total_len: int,
                       cont_start: int, img_feats: Optional[torch.Tensor],
                       img_start: int, pos3: Optional[torch.Tensor]
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Qwen2-VL (inline image span + mrope) scoring forward.

    ids: [P_pad] prompt + continuation, the image-pad span already in it;
    n_img: the span's rows (0 without an image); pos3: [3, P_pad] mrope
    position ids or None for 1-D rope (text-only). Returns (logprob_sum,
    n_greedy_match, n_cont) as 0-dim tensors."""
    tp = params["target"]
    cos_t, sin_t = params["cos_t"], params["sin_t"]
    p_pad = ids.shape[0]
    if n_img > 0 and img_feats is not None:
        fused = fuse_qwen_embeddings(tp["embed_tokens"], ids, img_feats,
                                     img_start, n_img)
    else:
        fused = embed_ids(tp["embed_tokens"], ids)
    if pos3 is not None:
        cos_t, sin_t = mrope_gather(cos_t, sin_t, pos3, mrope_section)
    device = ids.device
    positions = torch.arange(p_pad, dtype=torch.int32, device=device)
    bias = causal_prefill_bias(p_pad, p_pad, device=device)
    kv = L.init_kv_cache(tcfg, p_pad, fused.dtype, device)
    hidden, _ = L.llama_forward(tp, tcfg, fused, positions, kv, 0, bias,
                                cos_t, sin_t)
    # the prompt rows (masked) may hold special ids past a tiny test
    # vocabulary: they are gathered clamped, as JAX's gather takes them
    return _score_rows(tp, torch.clamp(ids, max=tcfg.vocab_size - 1), hidden,
                       cont_start, total_len)
