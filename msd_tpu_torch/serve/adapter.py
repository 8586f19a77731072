"""What the HTTP front end and the chat CLI read of a model: the port's
stand-in for the JAX package's harness adapter ``LlavaMSD``
(``msd_tpu/harness/models/llava_msd.py``), which the port has not taken
yet.

``ServeAdapter`` holds exactly the attributes ``serve/server.py`` and
``serve/cli.py`` read: the generator, the tokenizer, the image encoder,
the image size, whether MSD is on and the vocabulary's token classes. It
is built from a checkpoint (``from_pretrained``, the steps of
``LlavaMSD.from_pretrained``), from a random tiny stack (``from_tiny``)
or from a generator and LLaVA weights in memory (``from_llava``).
``SimpleTokenizer`` is the port's copy of the harness's byte-level
fallback tokenizer (for checkpoints without tokenizer files and for
tests).
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
    vocab_class: Optional[np.ndarray] = None   # calib.token_class classes

    @classmethod
    def from_tiny(cls, device="cuda", **kw) -> "ServeAdapter":
        """A randomly initialised tiny stack (the JAX ``LlavaMSD.from_tiny``
        shapes, the port's seeded torch weights in fp32), so the CLI and
        the server run end to end without a checkpoint."""
        from msd_tpu_torch.configs import (ClipVisionConfig, DraftConfig,
                                           EngineConfig, LlamaConfig,
                                           TreeConfig)
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.models import clip_vit as C
        from msd_tpu_torch.models import draft as D
        from msd_tpu_torch.models import llama as L
        from msd_tpu_torch.models.llava import init_projector_params

        tcfg = LlamaConfig.tiny(vocab_size=512, hidden_size=64, layers=2,
                                heads=4, intermediate_size=128, max_pos=1024)
        vcfg = ClipVisionConfig.tiny(hidden_size=32, layers=2, heads=4,
                                     image_size=28, patch_size=14,
                                     intermediate_size=64)
        lcfg = LlavaConfig(text=tcfg, vision=vcfg)
        dcfg = DraftConfig(text=tcfg)
        g = torch.Generator(device=device).manual_seed(0)
        f32 = dict(device=device, dtype=torch.float32)
        target = L.init_llama_params(tcfg, g, **f32)
        draft = D.init_draft_params(dcfg, g, **f32)
        lp = {"vision": C.init_clip_params(vcfg, g, **f32),
              "projector": init_projector_params(lcfg, g, **f32)}
        eng = EngineConfig(max_seq_len=512, prompt_pad_multiple=64,
                           tree=TreeConfig(top_k=4, max_depth=4,
                                           num_nodes=12))
        gen = MSDGenerator(target, draft, tcfg, dcfg, eng,
                           n_img=vcfg.num_patches, eos_id=2, device=device)
        return cls.from_llava(gen, SimpleTokenizer(vocab_size=512), lp, lcfg,
                              **kw)

    @classmethod
    def from_pretrained(cls, pretrained: str, msd_model_path: str,
                        dtype=None, device="cuda", eng=None,
                        **kw) -> "ServeAdapter":
        """An adapter over a LLaVA checkpoint dir and an MSD draft dir, by
        the steps of the JAX ``LlavaMSD.from_pretrained``: the checkpoint's
        tokenizer if ``transformers`` can read it locally, else the byte
        tokenizer; ``load_llava`` and ``load_draft`` (the draft sharing the
        target's embedding when it has none); the engine budgets, with
        ``max_seq_len`` and ``max_new_tokens`` taken from ``kw``; for a
        medusa draft, a tapered static tree over its heads (widths
        max(1, 10 // (1 + i))); the image rows of the tower; the
        tokenizer's EOS; the vocabulary's token classes. ``kw`` also
        takes the adapter's fields (``use_msd``, ``image_size``). The
        weights are loaded in ``dtype``: by default bf16 on a CUDA device
        and fp32 elsewhere."""
        from msd_tpu_torch.calib.token_class import classify_vocab
        from msd_tpu_torch.configs import EngineConfig, TreeConfig
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.utils.weights import load_draft, load_llava

        try:
            from transformers import AutoTokenizer

            # local_files_only: a checkpoint dir without tokenizer files
            # falls through to SimpleTokenizer (no hub lookup)
            tokenizer = AutoTokenizer.from_pretrained(
                pretrained, use_fast=True, local_files_only=True)
        except Exception:
            tokenizer = SimpleTokenizer()
        if dtype is None:
            dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
                else torch.float32
        params, lcfg = load_llava(pretrained, dtype, device)
        draft, dcfg = load_draft(msd_model_path, lcfg.text,
                                 base_embed=params["target"]["embed_tokens"],
                                 dtype=dtype, device=device)
        if eng is None:
            eng = EngineConfig()
            over = {k: int(kw.pop(k)) for k in ("max_seq_len",
                                                "max_new_tokens")
                    if k in kw}
            if over:
                eng = dataclasses.replace(eng, **over)
            if dcfg.medusa_heads:
                d = dcfg.medusa_heads + 1
                widths = tuple(max(1, 10 // (1 + i)) for i in range(d))
                eng = dataclasses.replace(
                    eng, tree=TreeConfig(top_k=widths[0], max_depth=d,
                                         num_nodes=1 + sum(widths),
                                         medusa_widths=widths))
        gen = MSDGenerator(params["target"], draft, lcfg.text, dcfg, eng,
                           n_img=lcfg.num_image_tokens,
                           eos_id=tokenizer.eos_token_id, device=device)
        llava = {"vision": params["vision"], "projector": params["projector"]}
        kw.setdefault("vocab_class",
                      classify_vocab(tokenizer, lcfg.text.vocab_size))
        return cls.from_llava(gen, tokenizer, llava, lcfg, **kw)

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
