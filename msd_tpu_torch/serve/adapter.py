"""What the HTTP front end and the chat CLI read of a model: the port's
stand-in for the JAX package's harness adapter ``LlavaMSD``
(``msd_tpu/harness/models/llava_msd.py``), which the port has not taken
yet.

``ServeAdapter`` holds exactly the attributes ``serve/server.py`` and
``serve/cli.py`` read: the generator, the tokenizer, the image encoder,
the image size and whether MSD is on. ``SimpleTokenizer`` is the port's
copy of the harness's byte-level fallback tokenizer (for checkpoints
without tokenizer files and for tests).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from msd_tpu_torch.configs import LlavaConfig
from msd_tpu_torch.models.llava import encode_image
from msd_tpu_torch.ops.sampling import SamplingParams


class SimpleTokenizer:
    """Byte-level fallback tokenizer for offline/synthetic runs."""

    bos_token_id = 1
    eos_token_id = 2

    def __init__(self, vocab_size: int = 32000):
        self.vocab_size = vocab_size

    def encode(self, text: str):
        return [self.bos_token_id] + [3 + (b % (self.vocab_size - 3))
                                      for b in text.encode()]

    def decode(self, ids, skip_special_tokens: bool = True):
        out = bytes(max(0, min(255, i - 3)) for i in ids
                    if i not in (self.bos_token_id, self.eos_token_id))
        return out.decode(errors="replace")


@dataclass
class ServeAdapter:
    """A generator with its tokenizer and image encoder.

    encode_image_fn: CLIP-normalized pixels [3, S, S] (numpy float32) ->
    projected image rows [n_img, H] on the generator's device, or None for
    a model without a vision tower (image requests are then refused)."""

    gen: object                  # engine.generator.MSDGenerator
    tokenizer: object
    encode_image_fn: Optional[Callable[[np.ndarray], torch.Tensor]] = None
    image_size: int = 336
    use_msd: bool = True

    @classmethod
    def from_llava(cls, gen, tokenizer, llava_params: Dict,
                   lcfg: LlavaConfig, **kw) -> "ServeAdapter":
        """An adapter whose images go through ``models.llava.encode_image``
        with ``llava_params`` ({"vision", "projector"}) on the generator's
        device."""

        def encode(pixels: np.ndarray) -> torch.Tensor:
            px = torch.from_numpy(np.ascontiguousarray(pixels)).to(
                gen.device)
            return encode_image(llava_params, lcfg, px)

        kw.setdefault("image_size", lcfg.vision.image_size)
        return cls(gen, tokenizer, encode, **kw)

    def sampling(self, payload: Dict) -> SamplingParams:
        """A request's sampling parameters: the generator's, with the
        request's temperature and top_p (so a greedy request keeps the
        generator's canonical rounding bits)."""
        return dataclasses.replace(
            self.gen.sp, temperature=float(payload.get("temperature", 0.0)),
            top_p=float(payload.get("top_p", 1.0)))
