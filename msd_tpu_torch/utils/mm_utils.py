"""Image preprocessing and multimodal tokenization (numpy; PIL for the
resize and for decoding image files).

The port's copy of the single-image part of the JAX package's
``utils/mm_utils.py`` (reference: LLaVA/llava/mm_utils.py:166-247):
``process_image`` with the 'pad' aspect mode (expand2square with the mean
color) and CLIP preprocessing, and ``tokenizer_image_token``, which splits
the prompt on <image> and inserts the -200 placeholder. The resize is
PIL's bicubic, as CLIPImageProcessor's; the JAX package's optional native
(C++) image prep is not part of the port.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from msd_tpu_torch.configs import DEFAULT_IMAGE_TOKEN, IMAGE_TOKEN_INDEX

# OpenAI CLIP normalization constants (CLIPImageProcessor defaults)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def expand2square(img: "np.ndarray", fill: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """Pad an HWC uint8/float image to square with the channel-mean color."""
    h, w, c = img.shape
    if h == w:
        return img
    side = max(h, w)
    if fill is None:
        fill = img.reshape(-1, c).mean(axis=0)
    out = np.empty((side, side, c), img.dtype)
    out[...] = fill.astype(img.dtype)
    if w > h:
        off = (side - h) // 2
        out[off:off + h, :, :] = img
    else:
        off = (side - w) // 2
        out[:, off:off + w, :] = img
    return out


def _resize_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """HWC float32 resize via PIL (bicubic, matching CLIPImageProcessor)."""
    from PIL import Image

    pil = Image.fromarray(img.astype(np.uint8))
    pil = pil.resize((size, size), Image.BICUBIC)
    return np.asarray(pil, np.float32)


def process_image(img, image_size: int = 336,
                  pad_square: bool = True) -> np.ndarray:
    """PIL image / HWC array -> CLIP-normalized CHW float32 [3, S, S]."""
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if pad_square:
        img = expand2square(img)
    img = _resize_bilinear(img, image_size)
    img = img / 255.0
    img = (img - CLIP_MEAN) / CLIP_STD
    return img.transpose(2, 0, 1).astype(np.float32)


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX
                          ) -> np.ndarray:
    """Tokenize a prompt with <image> placeholders (mm_utils.py:185-204).

    Splits on <image>, tokenizes chunks, joins with the placeholder id;
    a leading BOS from the first chunk is preserved, BOS from later chunks
    dropped.
    """
    chunks = [list(tokenizer.encode(c))
              for c in prompt.split(DEFAULT_IMAGE_TOKEN)]

    def insert_separator(xs, sep):
        out = []
        for x in xs:
            out.append(x)
            out.append(sep)
        return out[:-1]

    ids: List[int] = []
    offset = 0
    bos = getattr(tokenizer, "bos_token_id", None)
    if chunks and len(chunks[0]) > 0 and bos is not None \
            and chunks[0][0] == bos:
        offset = 1
        ids.append(chunks[0][0])
    for x in insert_separator(chunks, [image_token_index] * (offset + 1)):
        ids.extend(x[offset:])
    return np.asarray(ids, np.int32)
