"""Model / engine configuration dataclasses for the PyTorch port.

The port's own copy of the JAX package's configs (``msd_tpu/configs.py``):
the same field names, defaults and constructors, so a config built with the
same arguments on either side means the same model. Only the fields the
port reads are here; the sampling and attention-backend options of the
JAX configs come with the code that reads them. The port always verifies
with window-canonical attention (the JAX ``canonical_attn=True`` default)
and always gives the draft's fc a bias (``fc_bias=True``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

IMAGE_TOKEN_INDEX = -200  # LLaVA's image placeholder id


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
    # residual-stream dtype ("float32" carries the residual in fp32 while
    # every matmul stays in the param dtype); None = the activation dtype
    residual_dtype: Optional[str] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llava_7b() -> "LlamaConfig":
        return LlamaConfig()

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
class DraftConfig:
    """EAGLE-style one-layer draft head, optionally with medusa heads.

    ``medusa_heads > 0`` drafts with per-depth resblock heads over the
    depth-1 draft hidden (head ``d-2`` proposes depth ``d``); 0 drafts by
    EAGLE recursion (the OPT-Tree frontier)."""

    text: LlamaConfig = dataclasses.field(default_factory=LlamaConfig.llava_7b)
    num_layers: int = 1
    medusa_heads: int = 0


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
