"""Model / engine configuration dataclasses for the PyTorch port.

The port's own copy of the JAX package's configs (``msd_tpu/configs.py``):
every field of its dataclasses, with the same names, order and defaults,
so a config built with the same arguments on either side means the same
model, apart from two defaults named below. The attention switches:

- ``EngineConfig.canonical_attn`` (default True): tree verification with
  window-canonical attention (``ops/attention.windowed_attention``), so a
  greedy trajectory is draft-invariant and the null-draft run is canonical
  greedy AR. False is the original EAGLE verification: each tree row
  attends over the whole cache through ``tree_bias`` (the committed
  prefix and its ancestors), no window; its rows then go where
  ``attn_impl`` sends them.
- ``EngineConfig.canonical_ar`` (default False): the AR row at ``cur``
  reduces its window [cur - W + 1, cur] through window slots and the cache
  below it through the bias, as a verify row at that position does; it
  never reaches the decode-attention kernel.
- ``LlamaConfig.attn_impl`` routes every attention call that carries
  ``kv_len`` (the AR row, the non-canonical verify rows) and has no
  window: ``"xla"`` to ``masked_attention`` (stock torch ops on the card),
  never to the kernel; ``"pallas"`` to the CUDA decode-attention kernel K1
  (``ops/decode_attention``, the port of the Pallas kernel; the name is
  kept so a config built for JAX means the same thing) at any row count:
  the non-canonical verify's 48 rows of a LLaVA tree run as 12 row groups
  of 4 per kv head; ``"auto"`` to K1 for at most 4 grouped query rows
  (G * T) or one query row at any GQA group, when the allocated cache has
  at least ``pallas_min_s`` rows, else to ``masked_attention``. Another
  value raises ``ValueError``. On the card a call K1 does not take (head
  dim other than 128, another dtype) raises; nothing falls back (JAX's
  picker falls back to XLA past a TPU VMEM limit: not ported).

Departures: ``attn_impl`` defaults to ``"auto"`` (JAX: ``"xla"``), what
bench.py runs and the port's main path since its first slice, and
``pallas_min_s`` to 0 (JAX: 1024, from a TPU v5e sweep): on the H100 K1
beats SDPA at every LLaVA AR row measured, down to kv_len 334.
``param_dtype``, ``temperature``, ``top_p`` and ``top_k_sampling`` are
kept for the same constructor calls; neither package reads them (the
engine reads ``SamplingParams``). ``DraftConfig.fc_bias=False`` builds a
draft without ``fc_b``.

The Qwen configs live with their models
(``models/qwen2vl.Qwen2VLTextConfig`` and
``models/qwen_vl_v1.QwenVLV1TextConfig``, whose ``as_llama`` gives the
decoder's ``LlamaConfig``; ``models/qwen2vl_vision.Qwen2VisionConfig``,
``models/qwen_vl_v1.QwenVLVisionConfig``), as in the JAX package.
Quantized weights are a property of the param dicts
(``models.llama.quantize_llama_params``), not of these configs. Decoding
runs tensor parallel, and training (``DraftTrainer(mesh=)``,
``LlavaFinetuner(mesh=)``, ZeRO-1 optimizer state) over a (data, model)
mesh, as arguments (``parallel/``), not config fields. ``LlavaConfig.s2_scales`` (S2
multi-scale features) is here; LLaVA-1.6 anyres has no config, as in the
JAX package: its grid pinpoints, merge mode and ``image_newline`` are
arguments (``utils/mm_utils``, ``models/llava``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

IMAGE_TOKEN_INDEX = -200  # LLaVA's image placeholder id
DEFAULT_IMAGE_TOKEN = "<image>"
ATTN_IMPLS = ("xla", "pallas", "auto")


@dataclass(frozen=True)
class LlamaConfig:
    """LLaMA decoder config (target LM and draft decoder share this)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # attention routing of the calls that carry kv_len: "xla", "pallas"
    # or "auto" (module docstring); "auto" takes the kernel only on a cache
    # of at least pallas_min_s rows
    attn_impl: str = "auto"
    pallas_min_s: int = 0
    # residual-stream dtype ("float32" carries the residual in fp32 while
    # every matmul stays in the param dtype); None = the activation dtype
    residual_dtype: Optional[str] = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{self.attn_impl!r}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llava_7b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def llava_13b() -> "LlamaConfig":
        return LlamaConfig(hidden_size=5120, intermediate_size=13824,
                           num_hidden_layers=40, num_attention_heads=40,
                           num_key_value_heads=40)

    @staticmethod
    def tiny(vocab_size: int = 256, hidden_size: int = 64, layers: int = 2,
             heads: int = 4, kv_heads: Optional[int] = None,
             intermediate_size: int = 128, max_pos: int = 512) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            num_key_value_heads=kv_heads if kv_heads is not None else heads,
            max_position_embeddings=max_pos,
        )


@dataclass(frozen=True)
class ClipVisionConfig:
    """CLIP ViT vision tower (openai/clip-vit-large-patch14-336 shapes),
    the tower LLaVA-1.5 reads its image features from."""

    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    # layer to read features from, counted like HF hidden_states index.
    # LLaVA uses mm_vision_select_layer=-2.
    select_layer: int = -2
    select_feature: str = "patch"  # drop CLS

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @staticmethod
    def tiny(hidden_size: int = 32, layers: int = 2, heads: int = 4,
             image_size: int = 28, patch_size: int = 14,
             intermediate_size: int = 64) -> "ClipVisionConfig":
        return ClipVisionConfig(
            hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            num_hidden_layers=layers,
            num_attention_heads=heads,
            image_size=image_size,
            patch_size=patch_size,
        )


@dataclass(frozen=True)
class LlavaConfig:
    """LLaVA-1.5 VLM: vision tower + mlp2x_gelu projector + LM."""

    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.llava_7b)
    vision: ClipVisionConfig = dataclasses.field(
        default_factory=ClipVisionConfig)
    mm_projector_type: str = "mlp2x_gelu"
    # S2 multi-scale scales (clip_encoder.py:92-147), e.g. (336, 672, 1008);
    # None = single-scale. The projector's input width scales with
    # len(s2_scales).
    s2_scales: Optional[tuple] = None

    @property
    def num_image_tokens(self) -> int:
        return self.vision.num_patches

    @property
    def mm_hidden_size(self) -> int:
        n = len(self.s2_scales) if self.s2_scales else 1
        return self.vision.hidden_size * n

    @staticmethod
    def tiny() -> "LlavaConfig":
        return LlavaConfig(text=LlamaConfig.tiny(),
                           vision=ClipVisionConfig.tiny())


@dataclass(frozen=True)
class DraftConfig:
    """EAGLE-style one-layer draft head, optionally with medusa heads.

    ``medusa_heads > 0`` drafts with per-depth resblock heads over the
    depth-1 draft hidden (head ``d-2`` proposes depth ``d``); 0 drafts by
    EAGLE recursion (the OPT-Tree frontier)."""

    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.llava_7b)
    num_layers: int = 1
    fc_bias: bool = True
    medusa_heads: int = 0

    @staticmethod
    def tiny() -> "DraftConfig":
        return DraftConfig(text=LlamaConfig.tiny())


@dataclass(frozen=True)
class TreeConfig:
    """Static-shape draft-tree budget."""

    top_k: int = 10              # frontier width per depth
    max_depth: int = 10          # drafting depth bound
    num_nodes: int = 60          # total tree nodes incl. the root token
    # EAGLE mode: stop deepening once the top-num_draft weight sum grows
    # by no more than this (cnets.py:1401-1418)
    early_stop_threshold: float = 0.2
    # static-tree drafting: a tuple of top-k-index paths (tuples), e.g.
    # engine.static_tree.MC_SIM_7B_63; num_nodes/max_depth must cover it
    static_choices: Optional[tuple] = None
    # medusa mode: per-depth candidate widths; None = top_k at every depth
    medusa_widths: Optional[tuple] = None
    # medusa mode: an explicit sparse tree of per-depth-rank paths (tuples);
    # node (r1..rd) carries head d's rank-rd token. Overrides
    # medusa_widths; the prefix closure is added; num_nodes caps it
    medusa_choices: Optional[tuple] = None

    @property
    def num_draft(self) -> int:
        """Draft tokens excluding the root (already-sampled) token."""
        return self.num_nodes - 1

    @property
    def max_path_len(self) -> int:
        """Path length incl. the root; also the canonical window width."""
        return self.max_depth + 1


@dataclass(frozen=True)
class EngineConfig:
    """Decode-engine budgets."""

    max_seq_len: int = 4096
    max_new_tokens: int = 512
    prompt_pad_multiple: int = 128
    tree: TreeConfig = dataclasses.field(default_factory=TreeConfig)
    param_dtype: str = "bfloat16"
    # window-canonical tree verification; False: tree_bias over the cache
    canonical_attn: bool = True
    # the AR row through the verify's window scheme (never the kernel)
    canonical_ar: bool = False
    # greedy when temperature == 0.0 (not read: SamplingParams is)
    temperature: float = 0.0
    top_p: float = 1.0
    top_k_sampling: int = 0
