"""Image preprocessing and multimodal tokenization (numpy; the native C++
prep or PIL for the resize, PIL for decoding image files).

The port's copy of the JAX package's ``utils/mm_utils.py`` (reference:
LLaVA/llava/mm_utils.py:166-247): ``process_image`` with the 'pad' aspect
mode (expand2square with the mean color) and CLIP preprocessing,
``tokenizer_image_token``, which splits the prompt on <image> and inserts
the -200 placeholder, and LLaVA-1.6's anyres tiling
(``select_best_resolution``, ``resize_and_pad_image``,
``divide_to_patches``, ``get_anyres_image_grid_shape``,
``process_anyres_image``).

``process_image`` resizes a uint8 image through the native prep
(``utils/native.py``, built with g++ at first use) by default, as the JAX
package does, so both give the same pixels bitwise. Where the JAX package
falls back to PIL when its library is missing, the port raises;
``use_native=False`` is the explicit PIL path (bicubic, as
CLIPImageProcessor's). A non-uint8 array takes the PIL path, as in JAX
(the library reads uint8).
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


def process_image(img, image_size: int = 336, pad_square: bool = True,
                  use_native: bool = True) -> np.ndarray:
    """PIL image / HWC array -> CLIP-normalized CHW float32 [3, S, S].

    use_native: resize a uint8 image through the native prep
    (``utils/native.image_prep_native``), which raises if its library
    cannot be built; False takes the PIL path."""
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if use_native and img.dtype == np.uint8:
        from msd_tpu_torch.utils.native import image_prep_native

        return image_prep_native(img, image_size, CLIP_MEAN, CLIP_STD,
                                 pad_square)
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


# ---------------------------------------------------------------------------
# anyres (LLaVA-1.6-style) tiling: llava_arch.py:153-200 and mm_utils
# select_best_resolution / process_anyres_image. The merged features feed
# the engine's prefused prefill (spec_engine.prefill_prefused).
# ---------------------------------------------------------------------------

def select_best_resolution(original_size, possible_resolutions):
    """The grid resolution (w, h) that maximises the effective resolution,
    then minimises the wasted area (mm_utils select_best_resolution);
    original_size is (width, height)."""
    ow, oh = original_size
    best, best_fit = None, None
    for (w, h) in possible_resolutions:
        scale = min(w / ow, h / oh)
        down_w, down_h = int(ow * scale), int(oh * scale)
        effective = min(down_w * down_h, ow * oh)
        wasted = w * h - effective
        key = (-effective, wasted)
        if best_fit is None or key < best_fit:
            best_fit, best = key, (w, h)
    return best


def divide_to_patches(img: np.ndarray, patch_size: int) -> List[np.ndarray]:
    """Split an HWC image into patch_size x patch_size tiles, row-major."""
    h, w, _ = img.shape
    return [img[i:i + patch_size, j:j + patch_size]
            for i in range(0, h, patch_size)
            for j in range(0, w, patch_size)]


DEFAULT_GRID_PINPOINTS = ((336, 672), (672, 336), (672, 672),
                          (1008, 336), (336, 1008))


def resize_and_pad_image(img: np.ndarray, target_resolution) -> np.ndarray:
    """Aspect-preserving PIL bicubic resize, then a centred black pad to
    target_resolution (tw, th) (mm_utils.py:42-74); uint8 HWC out."""
    import math

    from PIL import Image

    oh, ow = img.shape[:2]
    tw, th = target_resolution
    scale_w, scale_h = tw / ow, th / oh
    if scale_w < scale_h:
        nw, nh = tw, min(math.ceil(oh * scale_w), th)
    else:
        nh, nw = th, min(math.ceil(ow * scale_h), tw)
    resized = np.asarray(Image.fromarray(img.astype(np.uint8))
                         .resize((nw, nh), Image.BICUBIC))
    out = np.zeros((th, tw, 3), np.uint8)
    y, x = (th - nh) // 2, (tw - nw) // 2
    out[y:y + nh, x:x + nw] = resized
    return out


def get_anyres_image_grid_shape(image_size, grid_pinpoints,
                                patch_size: int):
    """(n_patch_w, n_patch_h) of the selected anyres grid
    (mm_utils.py:99-116; image_size is (width, height))."""
    w, h = select_best_resolution(image_size, grid_pinpoints)
    return w // patch_size, h // patch_size


def process_anyres_image(img, image_size: int = 336,
                         grid_pinpoints=DEFAULT_GRID_PINPOINTS) -> np.ndarray:
    """Image -> [1 + n_tiles, 3, S, S]: the base view (the whole image
    resized, unpadded) first, then the tiles of the aspect-preserving,
    padded best grid, row-major (mm_utils.py:119-145). Every view goes
    through the default (native) ``process_image``. Downstream:
    ``models/llava.merge_anyres_features``."""
    if not isinstance(img, np.ndarray):
        img = np.asarray(img.convert("RGB"))
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    h, w, _ = img.shape
    best = select_best_resolution((w, h), grid_pinpoints)
    padded = resize_and_pad_image(img, best)
    tiles = divide_to_patches(padded, image_size)
    views = [process_image(v, image_size, pad_square=False)
             for v in [img] + tiles]
    return np.stack(views)
