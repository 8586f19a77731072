"""Qwen2-VL language model: the qkv-bias GQA decoder, mrope and the inline
image fusion.

The port of the JAX package's ``models/qwen2vl.py`` (reference: EAGLE's
modeling_qwen2vl_kv.py, 3-D mrope ``apply_multimodal_rotary_pos_emb``
:172-208; utils.py:609-630 get_input_embeds_qwen2vl; the image-token ids
151652 <|vision_start|> / 151655 <|image_pad|> of cnets.py:245-252).

mrope's three position streams are equal for every token outside the image
span, where mrope reduces exactly to 1-D rope at that position. Only the
prefill needs per-token 3-D positions (``mrope_positions``, gathered into
per-token cos/sin tables by ``mrope_gather``); the decode engine keeps
scalar positions plus a carried ``pos_delta`` (max(grid_h, grid_w) - n_img:
how far Qwen positions lag the cache index after an image).

The decoder is ``models/llama``'s with GQA and the q/k/v biases, which
``llama._layer_qkv`` adds when a layer has them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from msd_tpu_torch.configs import LlamaConfig
from msd_tpu_torch.models import llama as L

VISION_START_ID = 151652
VISION_END_ID = 151653
IMAGE_PAD_ID = 151655
VIDEO_PAD_ID = 151656


@dataclass(frozen=True)
class Qwen2VLTextConfig:
    """Qwen2-VL-7B-Instruct LM shapes; the llama machinery with qkv biases
    and GQA."""

    vocab_size: int = 152064
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_hidden_layers: int = 28
    num_attention_heads: int = 28
    num_key_value_heads: int = 4
    max_position_embeddings: int = 32768
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1e6
    mrope_section: Tuple[int, int, int] = (16, 24, 24)

    def as_llama(self) -> LlamaConfig:
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta)

    @staticmethod
    def tiny(vocab=512, hidden=64, layers=2, heads=4, kv_heads=2,
             inter=128) -> "Qwen2VLTextConfig":
        # mrope sections must sum to head_dim // 2
        d2 = (hidden // heads) // 2
        s = d2 // 4
        return Qwen2VLTextConfig(
            vocab_size=vocab, hidden_size=hidden, intermediate_size=inter,
            num_hidden_layers=layers, num_attention_heads=heads,
            num_key_value_heads=kv_heads, max_position_embeddings=2048,
            mrope_section=(d2 - 2 * s, s, s))


def init_qwen2_params(cfg: Qwen2VLTextConfig, generator: torch.Generator,
                      device="cuda", dtype=torch.bfloat16) -> Dict:
    """Random llama-layout weights from ``generator`` plus zero q/k/v
    biases, as the JAX ``init_qwen2_params`` makes them."""
    lc = cfg.as_llama()
    p = L.init_llama_params(lc, generator, device, dtype)
    nl = lc.num_hidden_layers
    hkv = lc.num_key_value_heads * lc.head_dim
    for name, width in (("q_bias", lc.hidden_size), ("k_bias", hkv),
                        ("v_bias", hkv)):
        p["layers"][name] = torch.zeros(nl, width, dtype=dtype,
                                        device=device)
    return p


def params_from_hf_qwen2(state: Dict[str, torch.Tensor],
                         cfg: Qwen2VLTextConfig, prefix: str = "model.",
                         dtype=torch.float32, device="cuda") -> Dict:
    """The stacked param dict (biases included) from a HF Qwen2 / Qwen2-VL
    flat state dict of host tensors."""
    return L.params_from_hf(state, cfg.as_llama(), prefix, dtype, device)


# ---------------------------------------------------------------------------
# mrope
# ---------------------------------------------------------------------------

def mrope_positions(prompt_len: int, img_start: int, n_img: int,
                    grid_h: int, grid_w: int, grid_t: int = 1
                    ) -> Tuple[np.ndarray, int]:
    """3-D position ids [3, prompt_len] for a single image/video Qwen2-VL
    prompt (HF get_rope_index, modeling_qwen2vl_kv.py:1480-1600), plus the
    post-vision position delta.

    img_start: index of the first <|image_pad|>/<|video_pad|> token;
    n_img = grid_t * grid_h * grid_w (LLM-space merged grids); grid_t > 1
    for videos (the temporal position advances once per temporal block,
    the documented [0,0,0,0, 1,1,1,1, 2,2,2,2] pattern).
    """
    pos = np.zeros((3, prompt_len), np.int64)
    for i in range(min(img_start, prompt_len)):
        pos[:, i] = i
    st = img_start
    hw = grid_h * grid_w
    for k in range(n_img):
        i = img_start + k
        if i >= prompt_len:
            break
        t, rem = divmod(k, hw)
        r, c = rem // grid_w, rem % grid_w
        pos[0, i] = st + t
        pos[1, i] = st + r
        pos[2, i] = st + c
    nxt = st + max(grid_t, grid_h, grid_w)
    for j, i in enumerate(range(img_start + n_img, prompt_len)):
        pos[:, i] = nxt + j
    delta = nxt - (img_start + n_img)
    return pos, int(delta)


def mrope_gather(cos_t: torch.Tensor, sin_t: torch.Tensor,
                 pos3: torch.Tensor, sections: Tuple[int, int, int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token cos/sin [..., T, D] from 3-D positions pos3 [..., 3, T].

    cos_t/sin_t: [max_pos, D] standard tables (half-duplicated layout);
    frequency column d (and d + D/2) takes its position from the mrope
    section owning d (modeling_qwen2vl_kv.py:172-208). The result goes to
    ``apply_rope`` as the table, with row indices as positions."""
    D = cos_t.shape[1]
    sel_half = np.concatenate([np.full(n, i) for i, n in enumerate(sections)])
    if len(sel_half) != D // 2:
        raise ValueError("mrope sections must sum to head_dim // 2")
    sel = torch.from_numpy(np.concatenate([sel_half, sel_half])).to(
        cos_t.device)
    p = pos3.long()[..., sel, :].transpose(-1, -2)          # [..., T, D]
    cols = torch.arange(D, device=cos_t.device)
    return cos_t[p, cols], sin_t[p, cols]


def embed_ids(embed_table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of a Qwen2-VL embedding, each id clamped into the table
    as JAX's gather clamps it: a tiny test vocabulary does not hold the
    151643+ special ids of a Qwen prompt; Qwen2-VL's 152064 rows do."""
    return embed_table[torch.clamp(ids.long(), 0, embed_table.shape[0] - 1)]


def fuse_qwen_embeddings(embed_table: torch.Tensor, ids: torch.Tensor,
                         img_feats: torch.Tensor, img_start,
                         n_img: int) -> torch.Tensor:
    """The <|image_pad|> span of ``ids`` [P] replaced by the vision rows
    ``img_feats`` [n_img, H]: Qwen2-VL prompts are already expanded (no
    placeholder to expand), so this is get_input_embeds_qwen2vl
    (utils.py:609-630) as a masked select."""
    P = ids.shape[0]
    emb = embed_ids(embed_table, ids)
    j = torch.arange(P, device=ids.device)
    in_img = (j >= img_start) & (j < img_start + n_img)
    idx = torch.clamp(j - img_start, 0, n_img - 1)
    return torch.where(in_img[:, None], img_feats[idx].to(emb.dtype), emb)
