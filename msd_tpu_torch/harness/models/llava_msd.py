"""LLaVA MSD model adapters for the harness.

The port of the JAX package's ``harness/models/llava_msd.py``, which
mirrors lmms-eval/lmms_eval/models/llava_msd_calibrated.py:56-728 — the
run orchestrator that owns the online calibration phases:
  docs[0 : train_ratio*N]   -> decode with feature collection (train phase)
  at the boundary           -> fit GroupedIsotonicCalibrator, export to
                               device tables (or reuse a saved pickle:
                               skip_to_test, :374-411)
  docs[train_ratio*N : N]   -> decode with calibrated tree construction
plus accept-length accumulation (:606-618) and the final acceptance JSON.

``llava`` (the AR baseline adapter, models/llava.py) shares the machinery
with use_msd=False. The adapter is also what the HTTP server and the chat
CLI serve (``sampling``, ``from_llava``). Its image encoder takes
CLIP-normalized numpy pixels [3, S, S] and returns the projected rows on
the generator's device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from msd_tpu_torch.calib.device import CalibTables
from msd_tpu_torch.calib.grouped import (GroupedIsotonicCalibrator,
                                         soft_labels_from)
from msd_tpu_torch.calib.logger import CalibrationLogger
from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlavaConfig
from msd_tpu_torch.harness.instance import Instance
from msd_tpu_torch.harness.registry import register_model
from msd_tpu_torch.models.llava import encode_image
from msd_tpu_torch.ops.sampling import SamplingParams
from msd_tpu_torch.utils.conversation import build_msd_prompt, vicuna_v1
from msd_tpu_torch.utils.mm_utils import (process_image,
                                          tokenizer_image_token)


def apply_until(text: str, gen_kwargs: Dict) -> str:
    """Host-side stop-string truncation: cut the response at the first
    occurrence of any ``until`` string (the lmms-eval adapter convention,
    e.g. models/llava_msd.py `until` handling + gsm8k.yaml's
    ``until: ["Question:"]``; EOS itself stops on-device)."""
    for stop in gen_kwargs.get("until", []) or []:
        if stop:
            text = text.split(stop)[0]
    return text


def run_multi_round(generate_one, requests: List[Instance],
                    default_max_rounds: int = 8) -> List[List[str]]:
    """Shared ``generate_until_multi_round`` driver (the round protocol of
    lmms-eval/lmms_eval/models/llava_onevision.py:568-773 at bs=1).

    arguments = (context, gen_kwargs, doc_to_visual, doc_to_text, doc_id,
    task, split). Rounds after the first re-query doc_to_text with
    (doc, previous_output, round_idx, previous_round_info) which returns
    (visuals, context, terminal_signal, round_res, round_info); the loop
    stops at the terminal signal. Per request the result is the list of
    per-round responses (the reference's zip over batched_round_res).
    """
    results: List[List[str]] = []
    for req in requests:
        context, gen_kwargs, doc_to_visual, doc_to_text, *_ = req.arguments
        visuals = doc_to_visual(req.doc) if doc_to_visual else []
        max_rounds = int(gen_kwargs.get("max_rounds", default_max_rounds))
        round_res: List[str] = []
        round_info = None
        for round_idx in range(max_rounds):
            if round_idx > 0:
                visuals, context, terminal, round_res, round_info = \
                    doc_to_text(req.doc, previous_output=round_res,
                                round_idx=round_idx,
                                previous_round_info=round_info)
                round_res = list(round_res)
                if terminal:
                    break
            round_res.append(generate_one(context, visuals, gen_kwargs))
        results.append(round_res)
    return results


def checkpoint_engine(dcfg, kw: Dict):
    """The engine budgets of an adapter built from checkpoints: the
    defaults, with ``max_seq_len`` and ``max_new_tokens`` popped from the
    model args ``kw``; for a medusa draft, a tapered static tree over its
    heads (widths max(1, 10 // (1 + i)))."""
    from msd_tpu_torch.configs import EngineConfig, TreeConfig

    eng = EngineConfig()
    over = {k: int(kw.pop(k)) for k in ("max_seq_len", "max_new_tokens")
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
    return eng


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


@register_model("llava_msd_calibrated", "llava_msd")
class LlavaMSD:
    """MSD adapter. Construct from a generator (tests, benchmarks),
    ``from_llava`` (a generator and LLaVA weights in memory),
    ``from_pretrained`` (checkpoints) or ``from_tiny`` (a random tiny
    stack)."""

    def __init__(self, generator, tokenizer,
                 encode_image_fn: Optional[
                     Callable[[np.ndarray], torch.Tensor]] = None, *,
                 use_msd: bool = True,
                 use_calibration: bool = False, train_ratio: float = 0.2,
                 vocab_class: Optional[np.ndarray] = None,
                 calibrator_path: Optional[str] = None,
                 base_alpha: float = 1.0, image_size: int = 336,
                 log_dir: Optional[str] = None):
        self.gen = generator
        self.tokenizer = tokenizer
        self.encode_image_fn = encode_image_fn
        self.use_msd = use_msd
        self.use_calibration = use_calibration
        self.train_ratio = train_ratio
        self.calibrator_path = calibrator_path
        self.base_alpha = base_alpha
        self.vocab_class = vocab_class
        self.image_size = image_size
        self.log_dir = log_dir
        self.calib_logger = CalibrationLogger(log_dir)
        self.calibrator: Optional[GroupedIsotonicCalibrator] = None
        self._calib_rows: List[Dict] = []
        self.total_accept_len = 0
        self.total_accept_steps = 0
        self.rank, self.world_size = 0, 1

    # ------------------------------------------------------------------
    @classmethod
    def from_tiny(cls, device="cuda", **kw) -> "LlavaMSD":
        """A randomly initialised tiny stack (the JAX ``from_tiny`` shapes,
        the port's seeded torch weights in fp32), so the harness CLI, the
        server and the chat CLI run end to end without a checkpoint
        (``--model_args tiny=true``)."""
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

    # ------------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, pretrained: str, msd_model_path: str,
                        dtype=None, device="cuda", eng=None,
                        **kw) -> "LlavaMSD":
        """An adapter over a LLaVA checkpoint dir and an MSD draft dir, by
        the steps of the JAX ``from_pretrained``: the checkpoint's
        tokenizer if ``transformers`` can read it locally, else the byte
        tokenizer; ``load_llava`` and ``load_draft`` (the draft sharing
        the target's embedding when it has none); the engine budgets
        (``checkpoint_engine``: ``max_seq_len`` and ``max_new_tokens``
        taken from ``kw``, a medusa draft's tapered tree); the image rows
        of the tower; the
        tokenizer's EOS; the vocabulary's token classes. ``kw`` also takes
        the adapter's fields and the target config's ``attn_impl`` and
        ``pallas_min_s`` (``configs.LlamaConfig``). The weights load in
        ``dtype``: by default bf16 on a CUDA device and fp32 elsewhere.
        Images are processed at the tower's size (the JAX adapter keeps its
        336 default)."""
        from msd_tpu_torch.calib.token_class import classify_vocab
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
        over = {k: kw.pop(k) for k in ("attn_impl", "pallas_min_s")
                if k in kw}
        if over:
            # the target's attention routing (model_args attn_impl=xla,
            # serve --attn-impl); the draft's config shares it
            if "pallas_min_s" in over:
                over["pallas_min_s"] = int(over["pallas_min_s"])
            lcfg = dataclasses.replace(
                lcfg, text=dataclasses.replace(lcfg.text, **over))
        draft, dcfg = load_draft(msd_model_path, lcfg.text,
                                 base_embed=params["target"]["embed_tokens"],
                                 dtype=dtype, device=device)
        if eng is None:
            eng = checkpoint_engine(dcfg, kw)
        gen = MSDGenerator(params["target"], draft, lcfg.text, dcfg, eng,
                           n_img=lcfg.num_image_tokens,
                           eos_id=tokenizer.eos_token_id, device=device)
        llava = {"vision": params["vision"], "projector": params["projector"]}
        kw.setdefault("vocab_class",
                      classify_vocab(tokenizer, lcfg.text.vocab_size))
        return cls.from_llava(gen, tokenizer, llava, lcfg, **kw)

    @classmethod
    def from_llava(cls, gen, tokenizer, llava_params: Dict,
                   lcfg: LlavaConfig, **kw) -> "LlavaMSD":
        """An adapter whose images go through ``models.llava.encode_image``
        with ``llava_params`` ({"vision", "projector"}) on the generator's
        device, processed at the tower's image size unless ``kw`` names
        one."""

        def encode(pixels: np.ndarray) -> torch.Tensor:
            px = torch.from_numpy(np.ascontiguousarray(pixels)).to(
                gen.device)
            return encode_image(llava_params, lcfg, px)

        kw.setdefault("image_size", lcfg.vision.image_size)
        return cls(gen, tokenizer, encode, **kw)

    def sampling(self, payload: Dict) -> SamplingParams:
        """A served request's sampling parameters: the generator's, with
        the request's temperature and top_p (so a greedy request keeps the
        generator's canonical rounding bits)."""
        return dataclasses.replace(
            self.gen.sp, temperature=float(payload.get("temperature", 0.0)),
            top_p=float(payload.get("top_p", 1.0)))

    # ------------------------------------------------------------------
    @staticmethod
    def _as_image(visual):
        """Normalize one visual to a single image. Video inputs — a [T, H,
        W, 3] frames array — fall back to the middle frame (this adapter is
        image-only like the reference's llava models). A bare video PATH
        needs a decoder this adapter does not have, so it fails with an
        actionable message instead of a shape error deep in image prep."""
        if isinstance(visual, str):
            raise ValueError(
                f"visual is a video path ({visual!r}); the llava adapters "
                "are image-only — use a video-capable adapter "
                "(qwen2_vl_msd) for this task")
        arr = np.asarray(visual) if not hasattr(visual, "ndim") else visual
        if getattr(arr, "ndim", 0) == 4:
            return arr[arr.shape[0] // 2]
        return visual

    def _encode(self, visual) -> torch.Tensor:
        px = process_image(self._as_image(visual), image_size=self.image_size)
        if self.encode_image_fn is None:
            raise ValueError("image provided but no vision encoder")
        return self.encode_image_fn(px)

    def _prepare(self, context: str, visuals) -> tuple:
        with_image = bool(visuals) and self.gen.n_img > 0
        prompt = build_msd_prompt(context, with_image=with_image)
        ids = tokenizer_image_token(prompt, self.tokenizer)
        cap = self.gen.max_prompt_tokens
        if len(ids) > cap:
            # Middle-truncate rather than crash (the engine budget is
            # fixed): keep the system+<image> head and the question/
            # answer-cue tail, like HF tokenizer truncation in the
            # reference eval stack.
            img = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
            head = min((int(img[0]) + 9) if len(img) else cap // 2, cap // 2)
            if len(img):
                # the <image> token MUST survive truncation (fusion would
                # otherwise see a token/feature mismatch): grow the head
                # past a mid-prompt image token, and drop any stray later
                # image tokens from the tail (a context embedding a literal
                # '<image>') so exactly one remains
                head = min(max(head, int(img[0]) + 1), cap - 1)
                tail_src = ids[head:]
                tail_src = tail_src[tail_src != IMAGE_TOKEN_INDEX]
                ids = np.concatenate([ids[:head], tail_src[-(cap - head):]])
            else:
                ids = np.concatenate([ids[:head], ids[-(cap - head):]])
            print(f"WARNING: prompt truncated to {cap} tokens "
                  "(engine budget)", file=sys.stderr)
        feats = self._encode(visuals[0]) if with_image else None
        return ids, feats

    def _sp(self, gen_kwargs: Dict) -> SamplingParams:
        return SamplingParams(
            temperature=float(gen_kwargs.get("temperature", 0.0)),
            top_p=float(gen_kwargs.get("top_p", 1.0)),
            top_k=int(gen_kwargs.get("top_k", 0) or 0))

    def _record_calib(self, calib_data: Dict) -> None:
        valid = calib_data["valid"].astype(bool)
        if not valid.any():
            return
        vc = self.vocab_class
        toks = calib_data["token"][valid]
        cats = (np.asarray(["content", "func_punct", "number"])[
            np.clip(vc[np.clip(toks, 0, len(vc) - 1)], 0, 2)]
            if vc is not None else np.asarray(["content"] * len(toks)))
        self._calib_rows.append({
            "token_category": cats,
            "avg_visual_attention_intensity": calib_data["attn"][valid],
            "tree_depth": calib_data["depth"][valid].astype(float),
            "draft_margin": calib_data["margin"][valid],
            "draft_confidence": calib_data["draft_conf"][valid],
            "base_conf": calib_data["base_conf"][valid],
            "base_top1": calib_data["base_top1"][valid],
        })

    def _fit_calibrator(self) -> None:
        """Train-phase boundary: fit + install device tables
        (llava_msd_calibrated.py:457-499)."""
        if self.calibrator_path and os.path.exists(self.calibrator_path):
            self.calibrator = GroupedIsotonicCalibrator.load(
                self.calibrator_path)
        else:
            if not self._calib_rows:
                return
            feats = {k: np.concatenate([r[k] for r in self._calib_rows])
                     for k in self._calib_rows[0]}
            soft = soft_labels_from(
                feats.pop("base_conf"),
                np.maximum(feats["draft_confidence"], 1e-6))
            hard = feats.pop("base_top1").astype(float)
            self.calibrator = GroupedIsotonicCalibrator(
                min_samples_per_group=200, max_grouping_level=2,
                target="soft").fit(feats, soft, hard)
            if self.calibrator_path:
                os.makedirs(os.path.dirname(self.calibrator_path) or ".",
                            exist_ok=True)
                self.calibrator.save(self.calibrator_path)
        vc = (self.vocab_class if self.vocab_class is not None
              else np.zeros((self.gen.tcfg.vocab_size,), np.int8))
        self.gen.set_calibrator(CalibTables.from_host(
            self.calibrator.export_tables(), vc, base_alpha=self.base_alpha,
            device=self.gen.device))

    def _finish(self, r, gen_kwargs: Dict) -> str:
        """Accumulate a request's acceptance counts; its response text."""
        self.total_accept_len += getattr(r, "accept_len_sum", 0)
        self.total_accept_steps += getattr(r, "accept_steps", 0)
        text = self.tokenizer.decode(list(r.tokens),
                                     skip_special_tokens=True)
        return apply_until(text, gen_kwargs).strip()

    # ------------------------------------------------------------------
    def generate_until(self, requests: List[Instance]) -> List[str]:
        n = len(requests)
        train_end = int(n * self.train_ratio) if self.use_calibration else 0
        skip_to_test = bool(self.calibrator_path
                            and os.path.exists(self.calibrator_path))
        if skip_to_test:
            train_end = 0
            self._fit_calibrator()
        t_start = time.time()
        outputs = []
        for idx, req in enumerate(requests):
            context, gen_kwargs, doc_to_visual, doc_id, task, split = \
                req.arguments
            visuals = doc_to_visual(req.doc)
            ids, feats = self._prepare(context, visuals)
            sp = self._sp(gen_kwargs)
            max_new = int(gen_kwargs.get("max_new_tokens", 512))

            if self.use_calibration and not skip_to_test and idx == train_end \
                    and idx > 0:
                self._fit_calibrator()

            if not self.use_msd:
                r = self.gen.naive_generate(ids, img_feats=feats,
                                            max_new_tokens=max_new, sp=sp)
            elif self.use_calibration and (skip_to_test or idx >= train_end) \
                    and self.calibrator is not None:
                r = self.gen.generate(ids, img_feats=feats,
                                      max_new_tokens=max_new, sp=sp,
                                      use_calibration=True)
            elif self.use_calibration and idx < train_end:
                r = self.gen.generate(ids, img_feats=feats,
                                      max_new_tokens=max_new, sp=sp,
                                      collect_calibration=True)
                self._record_calib(r.calib_data)
                self.calib_logger.log_request(r.calib_data)
            else:
                r = self.gen.generate(ids, img_feats=feats,
                                      max_new_tokens=max_new, sp=sp)
            outputs.append(self._finish(r, gen_kwargs))
        self.total_duration_seconds = time.time() - t_start
        if self.log_dir:
            self.write_run_outputs()
        return outputs

    def _generate_plain(self, context: str, visuals, gen_kwargs: Dict) -> str:
        """One uncalibrated generation (shared by multi-round)."""
        ids, feats = self._prepare(context, visuals)
        sp = self._sp(gen_kwargs)
        max_new = int(gen_kwargs.get("max_new_tokens", 512))
        fn = self.gen.generate if self.use_msd else self.gen.naive_generate
        r = fn(ids, img_feats=feats, max_new_tokens=max_new, sp=sp)
        return self._finish(r, gen_kwargs)

    def generate_until_multi_round(self, requests: List[Instance]
                                   ) -> List[List[str]]:
        """Round-looped generation (api/model.py:77-94; the reference MSD
        adapter leaves this NotImplemented at llava_msd_calibrated.py:677 —
        implemented here via the llava_onevision.py:568-773 protocol)."""
        return run_multi_round(self._generate_plain, requests)

    def loglikelihood(self, requests: List[Instance]) -> List[tuple]:
        """(sum logprob of continuation, is_greedy) per request
        (llava_msd_calibrated.py:231-305; api/model.py:29-54).

        arguments = (context, doc_to_target, doc_to_visual, doc_id, task,
        split); the continuation is scored teacher-forced in one forward
        with the context labels masked (engine/scoring.py)."""
        res = []
        for req in requests:
            context, doc_to_target, doc_to_visual, doc_id, task, split = \
                req.arguments
            continuation = (doc_to_target if isinstance(doc_to_target, str)
                            else doc_to_target(req.doc))
            visuals = doc_to_visual(req.doc) if doc_to_visual else []
            with_image = bool(visuals) and self.gen.n_img > 0
            conv = vicuna_v1("")
            q = f"<image>\n{context}" if with_image else context
            conv.append_message(conv.roles[0], q)
            conv.append_message(conv.roles[1], None)
            ids_ctx = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
            conv.messages[-1] = (conv.roles[1], continuation)
            ids_full = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
            feats = self._encode(visuals[0]) if with_image else None
            lp, greedy = self.gen.score(ids_full, cont_start=len(ids_ctx),
                                        img_feats=feats)
            res.append((lp, greedy))
        return res

    def write_run_outputs(self) -> Dict[str, str]:
        """Final acceptance-rate JSON + calibration stats/reliability dump
        (llava_msd_calibrated.py:635-668)."""
        os.makedirs(self.log_dir, exist_ok=True)
        paths = {}
        acc_path = os.path.join(self.log_dir, "acceptance_rate.json")
        with open(acc_path, "w") as f:
            json.dump({**self.msd_stats,
                       "total_duration_seconds":
                           getattr(self, "total_duration_seconds", 0.0)}, f)
        paths["acceptance"] = acc_path
        if self.calib_logger.rows:
            paths["calibration"] = self.calib_logger.save_data(
                os.path.join(self.log_dir, "calibration_data.json"))
            fig = self.calib_logger.save_reliability_plot(
                os.path.join(self.log_dir, "reliability.svg"))
            if fig:
                paths["reliability_plot"] = fig
        return paths

    @property
    def msd_stats(self) -> Dict[str, float]:
        steps = max(self.total_accept_steps, 1)
        return {"avg_accept_len": self.total_accept_len / steps,
                "accept_steps": self.total_accept_steps,
                "accept_len": self.total_accept_len}


@register_model("llava")
class LlavaAR(LlavaMSD):
    """Stock AR adapter (accuracy-parity baseline, models/llava.py)."""

    def __init__(self, *a, **kw):
        kw["use_msd"] = False
        kw["use_calibration"] = False
        super().__init__(*a, **kw)
