"""Mesh and megatron parameter layout for multi-rank execution: the port of
the JAX package's ``parallel/sharding.py``.

The mesh has named axes (``comm.Mesh`` over ``torch.distributed``):

    data  -- data parallel (replicas of the model)
    model -- megatron-style tensor parallel over attention heads / MLP
             columns

A spec is a tuple with one entry per leading dimension of its weight: an
axis name (that dimension is split over the axis) or None (kept whole);
JAX's ``PartitionSpec`` of the same entries. ``shard_params`` gives each
rank its contiguous slices of a full tree, and the tree carries its mesh
under ``"mesh"`` (a field the spec functions skip), which the model
functions read: q/k/v and gate/up are column parallel (local heads and
widths), o/down row parallel (their partial products summed over
``model`` in fp32, ``models/llama._row_sum``), ``embed_tokens`` and
``lm_head`` split on their columns and gathered where they are read.
Together, ``bridge.to_torch`` followed by ``shard_params`` carries
sharded JAX weights across.

``zero_opt_specs`` is the ZeRO-1 optimizer-state layout as a spec
function. Left out: ``specs_to_shardings`` (a spec has no placement
object of its own in torch: ``shard_params`` is the placement) and
``shard_opt_state_zero`` (the sharded training step comes with it).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from msd_tpu_torch.configs import DraftConfig, LlamaConfig
from msd_tpu_torch.parallel.comm import Mesh

Spec = Tuple[Optional[str], ...]


def mesh_shape(n: int, dp: Optional[int] = None,
               tp: Optional[int] = None) -> Tuple[int, int]:
    """(dp, tp) of a mesh over n ranks, by the JAX package's default: tp
    4 when n >= 8 and n % 4 == 0, else 2 when n is even and above 1, else
    1; dp the rest."""
    if tp is None:
        if n >= 8 and n % 4 == 0:
            tp = 4
        elif n % 2 == 0 and n > 1:
            tp = 2
        else:
            tp = 1
    dp = dp or (n // tp)
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != n({n})")
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None) -> Mesh:
    """A (data, model) mesh over the world's ranks (``mesh_shape``);
    ``n_devices`` defaults to the world size (1 without a process
    group)."""
    import torch.distributed as dist

    n = n_devices or (dist.get_world_size() if dist.is_initialized()
                      else 1)
    return Mesh(mesh_shape(n, dp, tp), ("data", "model"))


# ---------------------------------------------------------------------------
# Specs: the megatron TP layout.
#   q/k/v  [out, in]   : OUT (head) dim over 'model' (column parallel)
#   gate/up [in, out]  : OUT dim over 'model' (column parallel)
#   o/down [in, out]   : IN dim over 'model' (row parallel: partial
#                        products summed over 'model')
#   embed_tokens / lm_head : hidden / vocab columns over 'model'
# ---------------------------------------------------------------------------

def llama_param_specs(cfg: LlamaConfig, stacked: bool = True) -> Dict:
    lead = (None,) if stacked else ()

    def spec(*axes) -> Spec:
        return lead + axes

    layer = {
        "input_layernorm": spec(None),
        "post_attention_layernorm": spec(None),
        "q_proj": spec("model", None),
        "k_proj": spec("model", None),
        "v_proj": spec("model", None),
        "o_proj": spec("model", None),
        "gate_proj": spec(None, "model"),
        "up_proj": spec(None, "model"),
        "down_proj": spec("model", None),
    }
    # int8/int4 scales (quantize_llama_params) have the weight's shape with
    # a singleton contraction dim: column-parallel weights keep the
    # weight's spec, row-parallel ones (sharded on the contraction dim)
    # replicate theirs
    for nm in ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj"):
        layer[nm + "_qs"] = layer[nm + "_qs4"] = layer[nm]
    for nm in ("o_proj", "down_proj"):
        layer[nm + "_qs"] = layer[nm + "_qs4"] = spec(None, None)
    return {
        "embed_tokens": (None, "model"),
        "layers": layer,
        "norm": (None,),
        "lm_head": (None, "model"),
        "lm_head_qs": (None, "model"),
        "lm_head_qs4": (None, "model"),
    }


def draft_param_specs(cfg: DraftConfig, has_bias: bool = True) -> Dict:
    """The draft: its layer TP-sharded like the target's; fc (whose output
    feeds the layer's replicated input) and the small medusa heads
    replicated; ``embed_tokens`` on its hidden columns."""
    d = {
        "embed_tokens": (None, "model"),
        "fc_w": (None, None),
        "layers": llama_param_specs(cfg.text)["layers"],
    }
    if has_bias:
        d["fc_b"] = (None,)
    if cfg.medusa_heads > 0:
        d["medusa"] = {"mw": (None, None, None), "mb": (None, None)}
    return d


def kv_cache_specs() -> Dict:
    """[L, S, Hkv, D]: the KV heads over 'model' (the q/k/v column
    split)."""
    return {"k": (None, None, "model", None), "v": (None, None, "model", None)}


def _prune_specs(specs, params):
    """Drop spec entries absent from params (e.g. the ``*_qs`` scales of a
    model that is not quantized), so the trees match."""
    if isinstance(specs, dict) and isinstance(params, dict):
        return {k: _prune_specs(specs[k], params[k])
                for k in params if k in specs}
    return specs


def _local(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of x under ``spec``: along each
    dimension named by an axis, the axis index's 1/size of it. A fresh
    tensor, so the full one can be freed."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {axis} ({n})")
        size = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * size, size)
    return x.clone(memory_format=torch.contiguous_format)


def _place(params, specs, mesh: Mesh):
    if isinstance(params, dict):
        missing = [k for k in params if not isinstance(specs, dict)
                   or k not in specs]
        if missing:
            raise ValueError(f"no spec for {missing}")
        return {k: _place(v, specs[k], mesh) for k, v in params.items()}
    return _local(params, specs, mesh)


def shard_params(params: Dict, specs: Dict, mesh: Mesh) -> Dict:
    """This rank's slices of the full tree ``params`` under ``specs``
    (packed int4 columns included: their pairs lie within a slice), with
    the mesh under ``"mesh"``. Every leaf needs a spec, as JAX's
    ``tree.map`` over the pruned specs requires."""
    out = _place(params, _prune_specs(specs, params), mesh)
    out["mesh"] = mesh
    return out


def zero_opt_specs(specs: Dict, params: Dict, mesh: Mesh) -> Dict:
    """Optimizer-moment specs (ZeRO-1): each parameter's spec plus a
    'data' split on its first dimension that is unsplit and divisible by
    the data-axis size. ``params`` is the full tree."""
    dp = mesh.shape["data"]

    def zspec(s: Spec, x: torch.Tensor) -> Spec:
        axes = list(s) + [None] * (x.dim() - len(s))
        if dp > 1:
            for i, a in enumerate(axes):
                if a is None and x.shape[i] % dp == 0 and x.shape[i] >= dp:
                    axes[i] = "data"
                    break
        return tuple(axes)

    def walk(s, p):
        if isinstance(p, dict):
            return {k: walk(s[k], v) for k, v in p.items()}
        return zspec(s, p)

    return walk(_prune_specs(specs, params), params)
