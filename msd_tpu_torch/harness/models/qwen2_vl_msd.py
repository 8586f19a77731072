"""Qwen2-VL MSD adapter for the harness.

The port of the JAX package's ``harness/models/qwen2_vl_msd.py`` (a mirror
of lmms-eval/lmms_eval/models/qwen2_vl_msd.py:29-316: the Qwen2-VL chat
template with an inline <|vision_start|><|image_pad|>*N<|vision_end|>
span, the vision rows fused over the pads, msdgenerate/naivegenerate; the
reference adapter has no calibrator path). Images go through the port's
Qwen2-VL tower (``models/qwen2vl_vision``) on the generator's device; its
encoder takes numpy pixels [3, S, S] and returns the merged rows.

A video visual (a file path by extension, a [T, H, W, 3] array, a
``{"video": frames}`` dict; reference qwen2_vl_msd.py:218-258) is sampled
to exactly ``max_num_frames`` frames, each through ``process_image``, then
the tower's video path (``encode_video_fn``), and runs on ``video_gen``: a
second generator over the same target and draft tensors whose static
vision span is the video's grid_t x merged grid rows, inside a
<|video_pad|> span. Files decode through decord, imageio or OpenCV, when
one is installed.

Qwen-VL v1 (``QwenVLEagle``, registered ``qwen_vl_eagle``) is this
adapter over the v1 tower (``models/qwen_vl_v1``: the ViT and its
256-query resampler) and a 1-D-rope inline generator whose span is the v1
tokenizer's ``<img>`` ``<imgpad>`` x 256 ``</img>`` (``inline_pad_ids``);
it generates AR unless ``use_msd``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from msd_tpu_torch.harness.instance import Instance
from msd_tpu_torch.harness.models.llava_msd import (SimpleTokenizer,
                                                    apply_until,
                                                    checkpoint_engine,
                                                    run_multi_round)
from msd_tpu_torch.harness.registry import register_model
from msd_tpu_torch.models.qwen2vl import (IMAGE_PAD_ID, VIDEO_PAD_ID,
                                          VISION_END_ID, VISION_START_ID)
from msd_tpu_torch.ops.sampling import SamplingParams
from msd_tpu_torch.utils.mm_utils import process_image

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def qwen_chat_ids(tokenizer, question: str, n_img: int, with_image: bool,
                  pad_id: int = IMAGE_PAD_ID,
                  start_id: int = VISION_START_ID,
                  end_id: int = VISION_END_ID
                  ) -> Tuple[np.ndarray, Optional[int]]:
    """Token ids for '<|im_start|>user ... <|im_end|><|im_start|>assistant'
    with an inline image or video span; returns (ids, img_start or
    None)."""
    pre = tokenizer.encode("<|im_start|>user\n")
    post = tokenizer.encode(f"{question}<|im_end|>\n<|im_start|>assistant\n")
    ids: List[int] = list(pre)
    img_start = None
    if with_image:
        ids.append(start_id)
        img_start = len(ids)
        ids.extend([pad_id] * n_img)
        ids.append(end_id)
    ids.extend(post)
    return np.asarray(ids, np.int32), img_start


def is_video_visual(visual) -> bool:
    """Video inputs: a video file path, a [T, H, W, 3] frame array, or a
    {'video': frames} wrapper (the JAX adapter's rule)."""
    if isinstance(visual, str):
        return visual.lower().endswith(VIDEO_EXTS)
    if isinstance(visual, np.ndarray):
        return visual.ndim == 4
    return isinstance(visual, dict) and "video" in visual


def sample_frames(total: int, max_num_frames: int) -> np.ndarray:
    """Uniform frame sampling to exactly max_num_frames indices (reference
    qwen2_vl_msd.py:251-257 linspace; the endpoint holds the last frame,
    and a fixed count keeps the engine's vision span static)."""
    return np.linspace(0, max(total - 1, 0), max_num_frames, dtype=int)


def _decode_video_file(path: str) -> np.ndarray:
    """[T, H, W, 3] uint8 frames of a video file, through decord (the
    reference's loader), imageio or OpenCV, whichever is installed first;
    raises when none is."""
    try:
        import decord
        vr = decord.VideoReader(path)
        return vr.get_batch(range(len(vr))).asnumpy()
    except ImportError:
        pass
    try:
        import imageio.v3 as iio
        return np.asarray(iio.imread(path, plugin="pyav"))
    except ImportError:
        pass
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1])  # BGR -> RGB
        cap.release()
        if frames:
            return np.stack(frames)
    except ImportError:
        pass
    raise RuntimeError(
        f"no video decoder available for {path!r} (decord/imageio/cv2 all "
        "missing); pass frames as a [T, H, W, 3] array or a list of PIL "
        "images instead")


def load_video_frames(visual, max_num_frames: int) -> np.ndarray:
    """Any accepted video input (a path, an array, a ``{"video": ...}``
    dict, a list of PIL frames or arrays) -> [max_num_frames, H, W, 3]."""
    if isinstance(visual, dict):
        visual = visual["video"]
    if isinstance(visual, str):
        arr = _decode_video_file(visual)
    elif isinstance(visual, np.ndarray):
        arr = visual
    else:  # list/tuple of PIL frames
        arr = np.stack([np.asarray(v.convert("RGB"))
                        if hasattr(v, "convert") else np.asarray(v)
                        for v in visual])
    return arr[sample_frames(len(arr), max_num_frames)]


@register_model("qwen2_vl_msd", "qwen2_vl")
class Qwen2VLMSD:
    """Qwen2-VL MSD adapter over an inline-mode ``MSDGenerator``. Construct
    from a generator (tests), ``from_pretrained`` (checkpoints) or
    ``from_tiny`` (a random tiny stack)."""

    vision_start_id = VISION_START_ID
    vision_end_id = VISION_END_ID
    image_pad_id = IMAGE_PAD_ID

    def __init__(self, generator, tokenizer,
                 encode_image_fn: Optional[
                     Callable[[np.ndarray], torch.Tensor]] = None, *,
                 use_msd: bool = True, img_grid: Tuple[int, int] = (24, 24),
                 encode_video_fn: Optional[
                     Callable[[np.ndarray], torch.Tensor]] = None,
                 max_num_frames: int = 32, temporal_patch_size: int = 2,
                 **_ignored):
        if generator.image_mode != "inline":
            raise ValueError("Qwen2VLMSD needs an inline-mode generator")
        self.gen = generator
        self.tokenizer = tokenizer
        self.encode_image_fn = encode_image_fn
        # numpy frames [T, 3, S, S] -> merged video rows
        self.encode_video_fn = encode_video_fn
        self.use_msd = use_msd
        self.img_grid = tuple(img_grid)   # PATCH grid (before the merge)
        # mrope positions use the merged token grid (spatial merge 2)
        self.merged_grid = (self.img_grid[0] // 2, self.img_grid[1] // 2)
        self.max_num_frames = int(max_num_frames)
        self.video_grid_t = self.max_num_frames // int(temporal_patch_size)
        self._vgen = None
        self.total_accept_len = 0
        self.total_accept_steps = 0
        self.rank, self.world_size = 0, 1

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, pretrained: str, msd_model_path: str,
                        dtype=None, device="cuda", eng=None,
                        **kw) -> "Qwen2VLMSD":
        """An adapter over a Qwen2-VL checkpoint dir and an MSD draft dir
        (``load_qwen2_vl``, ``load_draft`` sharing the target's embedding
        when the draft has none), by the steps of the JAX
        ``from_pretrained``: the checkpoint's tokenizer if ``transformers``
        can read it locally, else the byte tokenizer over the vocabulary;
        the tokenizer's EOS (151645 when it names none); the image patch
        grid ``img_grid`` (default 24 x 24, a 336px image: 144 merged
        rows). Beyond JAX's: the weights load in ``dtype``, by default
        bf16 on a CUDA device and fp32 elsewhere; without ``eng``, the
        budgets of ``LlavaMSD.from_pretrained`` (``checkpoint_engine``:
        ``max_seq_len`` and ``max_new_tokens`` from ``kw``, a medusa
        draft's tapered tree)."""
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.utils.weights import load_draft, load_qwen2_vl

        if dtype is None:
            dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
                else torch.float32
        lm, vision, tcfg, vcfg = load_qwen2_vl(pretrained, dtype, device)
        lc = tcfg.as_llama()
        draft, dcfg = load_draft(msd_model_path, lc,
                                 base_embed=lm["embed_tokens"], dtype=dtype,
                                 device=device)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(
                pretrained, local_files_only=True)
        except Exception:
            tokenizer = SimpleTokenizer(tcfg.vocab_size)
        if eng is None:
            eng = checkpoint_engine(dcfg, kw)
        grid = tuple(kw.pop("img_grid", (24, 24)))
        m = vcfg.spatial_merge_size
        gen = MSDGenerator(lm, draft, lc, dcfg, eng,
                           n_img=(grid[0] // m) * (grid[1] // m),
                           eos_id=getattr(tokenizer, "eos_token_id", 151645),
                           image_mode="inline",
                           mrope_section=tcfg.mrope_section, device=device)
        return cls.from_qwen(gen, tokenizer, vision, vcfg, img_grid=grid,
                             **kw)

    @classmethod
    def from_tiny(cls, device="cuda", **kw) -> "Qwen2VLMSD":
        """A randomly initialised tiny stack (the JAX ``from_tiny`` shapes:
        a 64-wide GQA 4/2 decoder, an EAGLE draft, a 12-node tree, a 4 x 4
        patch grid, 8 video frames; the port's seeded torch weights in
        fp32) with a tiny Qwen2-VL tower in place of the JAX stack's
        random features, so the harness CLI runs the Qwen path without a
        checkpoint (``--model qwen2_vl_msd --model_args tiny=true``)."""
        from msd_tpu_torch.configs import (DraftConfig, EngineConfig,
                                           TreeConfig)
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.models import draft as D
        from msd_tpu_torch.models.qwen2vl import (Qwen2VLTextConfig,
                                                  init_qwen2_params)
        from msd_tpu_torch.models.qwen2vl_vision import (
            Qwen2VisionConfig, init_qwen_vision_params)

        qcfg = Qwen2VLTextConfig.tiny(vocab=512, hidden=64, layers=2,
                                      heads=4, kv_heads=2, inter=128)
        vcfg = Qwen2VisionConfig.tiny(hidden=qcfg.hidden_size)
        lc = qcfg.as_llama()
        dcfg = DraftConfig(text=lc)
        g = torch.Generator(device=device).manual_seed(0)
        f32 = dict(device=device, dtype=torch.float32)
        target = init_qwen2_params(qcfg, g, **f32)
        draft = D.init_draft_params(dcfg, g, **f32)
        vision = init_qwen_vision_params(vcfg, g, **f32)
        eng = EngineConfig(max_seq_len=512, prompt_pad_multiple=64,
                           tree=TreeConfig(top_k=4, max_depth=4,
                                           num_nodes=12))
        grid = tuple(kw.pop("img_grid", (4, 4)))
        kw.setdefault("max_num_frames", 8)
        gen = MSDGenerator(target, draft, lc, dcfg, eng,
                           n_img=(grid[0] // 2) * (grid[1] // 2), eos_id=2,
                           image_mode="inline",
                           mrope_section=qcfg.mrope_section, device=device)
        return cls.from_qwen(gen, SimpleTokenizer(vocab_size=512), vision,
                             vcfg, img_grid=grid, **kw)

    @classmethod
    def from_qwen(cls, gen, tokenizer, vision: Dict, vcfg,
                  **kw) -> "Qwen2VLMSD":
        """An adapter whose images go through ``qwen_vision_encode`` and
        videos through ``qwen_vision_encode_video``, with the tower
        weights ``vision`` on the generator's device; the tower's
        temporal patch size is the adapter's."""
        from msd_tpu_torch.models.qwen2vl_vision import (
            qwen_vision_encode, qwen_vision_encode_video)

        def upload(pixels: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(pixels)).to(
                gen.device)

        def encode(pixels: np.ndarray) -> torch.Tensor:
            return qwen_vision_encode(vision, vcfg, upload(pixels))

        def encode_video(frames: np.ndarray) -> torch.Tensor:
            return qwen_vision_encode_video(vision, vcfg, upload(frames))

        kw.setdefault("temporal_patch_size", vcfg.temporal_patch_size)
        return cls(gen, tokenizer, encode, encode_video_fn=encode_video,
                   **kw)

    # ------------------------------------------------------------------
    def _sp(self, gen_kwargs: Dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(gen_kwargs.get("temperature", 0.0)),
            top_p=float(gen_kwargs.get("top_p", 1.0)),
            top_k=int(gen_kwargs.get("top_k", 0) or 0))

    @property
    def video_gen(self):
        """The generator of video prompts: grid_t temporal blocks make a
        longer static vision span than an image's, so the span statics and
        the cache budget differ (max_seq_len at least the video rows +
        512 + one tree and path, rounded up to 128). It holds the image
        generator's target and draft tensors themselves, not copies."""
        if self._vgen is None:
            import dataclasses

            from msd_tpu_torch.engine.generator import MSDGenerator

            g = self.gen
            n_vid = (self.video_grid_t * self.merged_grid[0]
                     * self.merged_grid[1])
            need = (n_vid + 512 + g.eng.tree.num_nodes
                    + g.eng.tree.max_path_len)
            eng = g.eng if g.eng.max_seq_len >= need else \
                dataclasses.replace(g.eng, max_seq_len=-128 * (-need // 128))
            self._vgen = MSDGenerator(
                g.params["target"], g.params["draft"], g.tcfg, g.dcfg, eng,
                n_img=n_vid, eos_id=g.eos_id, sp=g.sp, image_mode="inline",
                mrope_section=g.mrope_section,
                attn_feature_mode=g.attn_feature_mode, device=g.device,
                cuda_graphs=g.graphs is not None,
                inline_pad_ids=g.inline_pad_ids)
        return self._vgen

    def _encode_video(self, visual):
        """A video visual -> (merged video rows [n_video, H], (grid_t,
        merged gh, merged gw))."""
        from PIL import Image

        frames = load_video_frames(visual, self.max_num_frames)
        px = np.stack([process_image(Image.fromarray(np.asarray(f)),
                                     image_size=self.img_grid[0] * 14)
                       for f in frames])                 # [T, 3, S, S]
        return (self.encode_video_fn(px),
                (self.video_grid_t,) + self.merged_grid)

    def _encode_visual(self, visuals) -> Optional[torch.Tensor]:
        """The first visual's merged image rows, or None (no visual, or a
        text-only engine)."""
        if not (bool(visuals) and self.gen.n_img > 0):
            return None
        if self.encode_image_fn is None:
            raise ValueError("image provided but no vision encoder")
        if is_video_visual(visuals[0]):
            raise ValueError("a video visual needs encode_video_fn and "
                             "is generated from (generate_until), not "
                             "scored")
        px = process_image(visuals[0], image_size=self.img_grid[0] * 14)
        return self.encode_image_fn(px)

    def _prep_request(self, context: str, visuals):
        """(generator, ids, features or None, mrope grid or None) of one
        request: a video visual runs on ``video_gen`` with a
        <|video_pad|> span (reference qwen2_vl_msd.py:218-258)."""
        vis = visuals[0] if visuals else None
        if vis is not None and self.gen.n_img > 0 and is_video_visual(vis) \
                and self.encode_video_fn is not None:
            gen = self.video_gen
            feats, grid = self._encode_video(vis)
            ids, _ = qwen_chat_ids(self.tokenizer, context, gen.n_img, True,
                                   pad_id=VIDEO_PAD_ID,
                                   start_id=self.vision_start_id,
                                   end_id=self.vision_end_id)
            return gen, ids, feats, grid
        feats = self._encode_visual(visuals)
        with_image = feats is not None
        ids, _ = qwen_chat_ids(self.tokenizer, context, self.gen.n_img,
                               with_image, pad_id=self.image_pad_id,
                               start_id=self.vision_start_id,
                               end_id=self.vision_end_id)
        # mrope grids only for mrope models
        use_grid = with_image and self.gen.mrope_section is not None
        return self.gen, ids, feats, self.merged_grid if use_grid else None

    def _generate_plain(self, context: str, visuals, gen_kwargs: Dict) -> str:
        gen, ids, feats, grid = self._prep_request(context, visuals)
        sp = self._sp(gen_kwargs)
        max_new = int(gen_kwargs.get("max_new_tokens", 512))
        fn = gen.generate if self.use_msd else gen.naive_generate
        r = fn(ids, img_feats=feats, max_new_tokens=max_new, sp=sp,
               img_grid=grid)
        self.total_accept_len += getattr(r, "accept_len_sum", 0)
        self.total_accept_steps += getattr(r, "accept_steps", 0)
        text = self.tokenizer.decode(list(r.tokens),
                                     skip_special_tokens=True)
        return apply_until(text, gen_kwargs).strip()

    def generate_until(self, requests: List[Instance]) -> List[str]:
        outputs = []
        t0 = time.time()
        for req in requests:
            context, gen_kwargs, doc_to_visual, *_ = req.arguments
            visuals = doc_to_visual(req.doc) if doc_to_visual else []
            outputs.append(self._generate_plain(context, visuals, gen_kwargs))
        self.total_duration_seconds = time.time() - t0
        return outputs

    def generate_until_multi_round(self, requests: List[Instance]
                                   ) -> List[List[str]]:
        return run_multi_round(self._generate_plain, requests)

    def loglikelihood(self, requests: List[Instance]) -> List[Tuple]:
        """(sum logprob of continuation, is_greedy) under the Qwen chat
        template: the continuation is the assistant span appended to the
        '<|im_start|>assistant\\n' context (api/model.py:29-54)."""
        res = []
        for req in requests:
            context, doc_to_target, doc_to_visual, *_ = req.arguments
            continuation = (doc_to_target if isinstance(doc_to_target, str)
                            else doc_to_target(req.doc))
            visuals = doc_to_visual(req.doc) if doc_to_visual else []
            feats = self._encode_visual(visuals)
            with_image = feats is not None
            ids_ctx, _ = qwen_chat_ids(self.tokenizer, context,
                                       self.gen.n_img, with_image,
                                       pad_id=self.image_pad_id,
                                       start_id=self.vision_start_id,
                                       end_id=self.vision_end_id)
            cont_ids = np.asarray(self.tokenizer.encode(continuation),
                                  np.int32)
            # HF Qwen tokenizers have no BOS; the byte-fallback one does
            bos = getattr(self.tokenizer, "bos_token_id", None)
            if bos is not None and len(cont_ids) and cont_ids[0] == bos:
                cont_ids = cont_ids[1:]
            ids_full = np.concatenate([ids_ctx, cont_ids]).astype(np.int32)
            use_grid = with_image and self.gen.mrope_section is not None
            lp, greedy = self.gen.score(
                ids_full, cont_start=len(ids_ctx), img_feats=feats,
                img_grid=self.merged_grid if use_grid else None)
            res.append((lp, greedy))
        return res

    @property
    def msd_stats(self) -> Dict[str, float]:
        steps = max(self.total_accept_steps, 1)
        return {"avg_accept_len": self.total_accept_len / steps,
                "accept_steps": self.total_accept_steps,
                "accept_len": self.total_accept_len}


@register_model("qwen_vl_eagle")
class QwenVLEagle(Qwen2VLMSD):
    """The Qwen-VL (v1) adapter (reference lmms-eval models/
    qwen_vl_eagle.py:29-384; the JAX package's ``QwenVLEagle``).

    v1 differs from Qwen2-VL in both halves: the tower is the OpenCLIP-style
    ViT with a 256-query cross-attention resampler
    (``models/qwen_vl_v1``), and the LM takes plain 1-D rotary positions,
    no mrope, with the image rows inline in an ``<img>`` ... ``</img>``
    span. The reference adapter generates autoregressively (:308): so does
    this one unless ``use_msd=True``."""

    def __init__(self, *a, **kw):
        kw.setdefault("use_msd", False)
        super().__init__(*a, **kw)

    @classmethod
    def from_pretrained(cls, pretrained: str, msd_model_path: str,
                        dtype=None, device="cuda", eng=None,
                        **kw) -> "QwenVLEagle":
        """An adapter over a Qwen-VL (v1) checkpoint dir and an MSD draft
        dir (``load_qwen_vl_v1``, ``load_draft`` sharing the target's
        embedding when the draft has none), by the steps of the JAX
        ``from_pretrained``: the checkpoint's tokenizer if ``transformers``
        can read it locally, else the byte tokenizer over the vocabulary;
        ``<img>``, ``<imgpad>`` and ``</img>`` as the tokenizer resolves
        each to one id, else Qwen2-VL's ids; the EOS ``im_end_id``, else
        ``eos_token_id``, else 151643; ``n_queries`` image rows at the
        tower's grid (448px images), found by the ``<imgpad>`` id. Beyond
        JAX's, as ``Qwen2VLMSD.from_pretrained``: the weights load in
        ``dtype``, by default bf16 on a CUDA device and fp32 elsewhere;
        without ``eng``, ``checkpoint_engine``'s budgets."""
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.utils.weights import load_draft, load_qwen_vl_v1

        if dtype is None:
            dtype = torch.bfloat16 if torch.device(device).type == "cuda" \
                else torch.float32
        lm, vision, tcfg, vcfg = load_qwen_vl_v1(pretrained, dtype, device)
        lc = tcfg.as_llama()
        draft, dcfg = load_draft(msd_model_path, lc,
                                 base_embed=lm["embed_tokens"], dtype=dtype,
                                 device=device)
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(
                pretrained, trust_remote_code=True, local_files_only=True)
        except Exception:
            tokenizer = SimpleTokenizer(tcfg.vocab_size)

        # v1's span is <img> <imgpad> x 256 </img>: the v1 tokenizer's
        # ids (Qwen2-VL's 15165x ids are untrained <|extra_*|> tokens of
        # the v1 vocabulary; reference qwen_vl_eagle.py:68 lets the
        # tokenizer resolve "<img>{}</img>")
        def _one(s: str, default: int) -> int:
            try:
                e = tokenizer.encode(s)
                return int(e[0]) if len(e) == 1 else default
            except Exception:
                return default

        start_id = _one("<img>", VISION_START_ID)
        pad_id = _one("<imgpad>", IMAGE_PAD_ID)
        end_id = _one("</img>", VISION_END_ID)
        if eng is None:
            eng = checkpoint_engine(dcfg, kw)
        gen = MSDGenerator(lm, draft, lc, dcfg, eng, n_img=vcfg.n_queries,
                           eos_id=getattr(tokenizer, "im_end_id",
                                          getattr(tokenizer, "eos_token_id",
                                                  151643)),
                           image_mode="inline", mrope_section=None,
                           inline_pad_ids=(pad_id,), device=device)
        adapter = cls.from_v1(gen, tokenizer, vision, vcfg, **kw)
        adapter.vision_start_id = start_id
        adapter.image_pad_id = pad_id
        adapter.vision_end_id = end_id
        return adapter

    @classmethod
    def from_tiny(cls, device="cuda", **kw) -> "QwenVLEagle":
        """A randomly initialised tiny v1 stack at the JAX ``from_tiny``
        shapes (a 48-wide decoder of 2 layers and 4 heads, an EAGLE draft,
        a 12-node tree; a real tiny tower: width 32, 2 layers, 4 queries
        over a 4 x 4 patch grid of 56px images) with the port's seeded
        torch weights in fp32, the image span at Qwen2-VL's ids, so the
        harness CLI runs the v1 path without a checkpoint (``--model
        qwen_vl_eagle --model_args tiny=true``)."""
        from msd_tpu_torch.configs import (DraftConfig, EngineConfig,
                                           TreeConfig)
        from msd_tpu_torch.engine.generator import MSDGenerator
        from msd_tpu_torch.models import draft as D
        from msd_tpu_torch.models import llama as L
        from msd_tpu_torch.models.qwen_vl_v1 import (
            QwenVLV1TextConfig, QwenVLVisionConfig,
            init_qwen_vl_vision_params)

        qcfg = QwenVLV1TextConfig.tiny(vocab=512, hidden=48, layers=2,
                                       heads=4, inter=96)
        vcfg = QwenVLVisionConfig.tiny(width=32, layers=2, heads=4,
                                       out=qcfg.hidden_size, queries=4,
                                       image_size=56)
        lc = qcfg.as_llama()
        dcfg = DraftConfig(text=lc)
        g = torch.Generator(device=device).manual_seed(0)
        f32 = dict(device=device, dtype=torch.float32)
        target = L.init_llama_params(lc, g, **f32)
        draft = D.init_draft_params(dcfg, g, **f32)
        vision = init_qwen_vl_vision_params(vcfg, g, **f32)
        eng = EngineConfig(max_seq_len=512, prompt_pad_multiple=64,
                           tree=TreeConfig(top_k=4, max_depth=4,
                                           num_nodes=12))
        gen = MSDGenerator(target, draft, lc, dcfg, eng,
                           n_img=vcfg.n_queries, eos_id=2,
                           image_mode="inline", mrope_section=None,
                           device=device)
        return cls.from_v1(gen, SimpleTokenizer(vocab_size=512), vision,
                           vcfg, **kw)

    @classmethod
    def from_v1(cls, gen, tokenizer, vision: Dict, vcfg,
                **kw) -> "QwenVLEagle":
        """An adapter whose images go through ``qwen_vl_vision_encode``
        with the tower weights ``vision`` on the generator's device, at
        the tower's patch grid unless ``img_grid`` says otherwise."""
        from msd_tpu_torch.models.qwen_vl_v1 import qwen_vl_vision_encode

        def encode(pixels: np.ndarray) -> torch.Tensor:
            return qwen_vl_vision_encode(vision, vcfg, torch.from_numpy(
                np.ascontiguousarray(pixels)).to(gen.device))

        kw.setdefault("img_grid", (vcfg.grid, vcfg.grid))
        return cls(gen, tokenizer, encode, **kw)
