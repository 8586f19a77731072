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
function, and ``shard_opt_state_zero`` places it: a ``ZeroState`` holds,
for each trained tensor of this rank's TP shard, the slice of it that
``zero_opt_specs`` gives this rank along ``data``, which is what the
AdamW steps, so its moments (``exp_avg``, ``exp_avg_sq``) are that slice's
size. A step sums the gradients over ``data`` (``reduce_grads``), clips
them by the mesh-wide norm (``global_sq_norm``), steps the slices and
gathers them back over ``data`` into the shard (``ZeroState.gather``).
``gather_params`` rebuilds a full tree from the ranks' shards. Left out:
``specs_to_shardings`` (a spec has no placement object of its own in
torch: ``shard_params`` is the placement).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from msd_tpu_torch.configs import DraftConfig, LlamaConfig
from msd_tpu_torch.parallel import comm
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


def _zspec(s: Spec, x: torch.Tensor, dp: int) -> Spec:
    axes = list(s) + [None] * (x.dim() - len(s))
    if dp > 1:
        for i, a in enumerate(axes):
            if a is None and x.shape[i] % dp == 0 and x.shape[i] >= dp:
                axes[i] = "data"
                break
    return tuple(axes)


def zero_opt_specs(specs: Dict, params: Dict, mesh: Mesh) -> Dict:
    """Optimizer-moment specs (ZeRO-1): each parameter's spec plus a
    'data' split on its first dimension that is unsplit and divisible by
    the data-axis size. ``params`` is the full tree or this rank's shard
    of it (the dimension that takes 'data' is one no axis splits, so its
    size is the same in both); a ``"mesh"`` entry is skipped."""
    dp = mesh.shape["data"]

    def walk(s, p):
        if isinstance(p, dict):
            return {k: walk(s[k], v) for k, v in p.items() if k != "mesh"}
        return _zspec(s, p, dp)

    return walk(_prune_specs(specs, params), params)


def leaves_with_specs(params: Dict, specs: Dict) -> List[Tuple[torch.Tensor,
                                                              Spec]]:
    """(tensor, spec) of every tensor of ``params`` (sorted keys at every
    level; the ``"mesh"`` entry skipped)."""
    out = []
    for k in sorted(params):
        if k == "mesh":
            continue
        if isinstance(params[k], dict):
            out += leaves_with_specs(params[k], specs[k])
        else:
            out.append((params[k], specs[k]))
    return out


def gather_params(params: Dict, specs: Dict, mesh: Mesh) -> Dict:
    """The full tree of which ``params`` is this rank's shard under
    ``specs`` (``shard_params``'s inverse; the ``"mesh"`` entry
    dropped), in new tensors, bitwise: each block gathered along each
    split dimension (``comm.broadcast_gather``). A collective: every rank
    calls it."""
    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(v, s[k]) for k, v in p.items() if k != "mesh"}
        x = p.detach().clone()
        for dim, axis in enumerate(s):
            if axis is not None:
                x = comm.broadcast_gather(x, mesh, axis, dim)
        return x

    return walk(params, _prune_specs(specs, params))


def _dtypes(tensors: List[torch.Tensor]) -> List[torch.dtype]:
    """The tensors' dtypes in order of first appearance (the same order on
    every rank, as the collectives over them require)."""
    return list(dict.fromkeys(t.dtype for t in tensors))


def reduce_grads(grads: List[torch.Tensor], mesh: Mesh) -> None:
    """Each gradient summed over ``data``, in place: the losses are the
    global batch's means, so each rank's gradient is its rows' share of
    the whole. One collective per dtype over the gradients laid end to
    end (each element's sum is the same as alone)."""
    if mesh.group("data") is None:
        return
    for dtype in _dtypes(grads):
        gs = [g for g in grads if g.dtype == dtype]
        flat = comm.all_reduce_(torch.cat([g.reshape(-1) for g in gs]),
                                mesh, "data")
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view_as(g))


def global_sq_norm(grads: List[torch.Tensor], split: List[bool],
                   mesh: Optional[Mesh], dtype=None) -> torch.Tensor:
    """The squared global norm of a tree whose tensors ``grads`` are this
    rank's blocks: a tensor split over ``model`` (``split``) adds its
    squares summed over the axis, a replicated one its own once. Each
    block's norm is taken in ``dtype`` (the tensors' own by default). The
    clips take it only where a block is split: otherwise every rank holds
    the whole tree and they keep their one-device sum."""
    dt = dtype or grads[0].dtype

    def sq(gs):
        return sum((torch.linalg.vector_norm(g, dtype=dt).square()
                    for g in gs),
                   torch.zeros((), dtype=dt, device=grads[0].device))

    part = sq([g for g, s in zip(grads, split) if s])
    if mesh is not None:
        part = comm.all_reduce(part, mesh, "model")
    return part + sq([g for g, s in zip(grads, split) if not s])


class ZeroState:
    """ZeRO-1 over ``data``: for each trained tensor of this rank's TP
    shard (``leaves``, under TP specs ``specs``) the slice that
    ``zero_opt_specs`` gives this rank (the tensor itself where no
    dimension takes 'data'), which the optimizer steps, so the moments are
    the slice's size (``slices``). ``split`` marks the tensors split over
    ``model`` (for the norm). ``gather`` writes the stepped slices back
    into the shard."""

    def __init__(self, leaves: List[torch.Tensor], specs: List[Spec],
                 mesh: Mesh):
        self.mesh, self.leaves = mesh, leaves
        dp = mesh.shape["data"]
        self.dims, self.slices, self.split = [], [], []
        for p, s in zip(leaves, specs):
            z = _zspec(s, p, dp)
            dim = z.index("data") if "data" in z and dp > 1 else None
            self.dims.append(dim)
            self.split.append("model" in s and mesh.shape["model"] > 1)
            self.slices.append(p if dim is None else self._part(p.detach(),
                                                                dim).clone())

    def _part(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        size = x.shape[dim] // self.mesh.shape["data"]
        return x.narrow(dim, self.mesh.coords["data"] * size, size)

    @torch.no_grad()
    def scatter_params(self) -> None:
        """Set each slice from its tensor (after a restore)."""
        for p, dim, sl in zip(self.leaves, self.dims, self.slices):
            if dim is not None:
                sl.copy_(self._part(p, dim))

    def zero_grad(self) -> None:
        for p in self.leaves:
            if p.grad is not None:
                p.grad.zero_()

    def grads(self) -> Tuple[List[torch.Tensor], List[bool]]:
        """(the gradients that exist, whether each is split over
        ``model``)."""
        have = [i for i, p in enumerate(self.leaves) if p.grad is not None]
        return ([self.leaves[i].grad for i in have],
                [self.split[i] for i in have])

    def scatter_grads(self) -> None:
        """Give each slice its part of its tensor's gradient."""
        for p, dim, sl in zip(self.leaves, self.dims, self.slices):
            if dim is not None:
                sl.grad = None if p.grad is None else self._part(p.grad, dim)

    @torch.no_grad()
    def gather(self) -> None:
        """Rebuild each stepped tensor from its slices over ``data``: one
        gather per dtype of the slices laid end to end
        (``comm.broadcast_gather``)."""
        todo = [(p, dim, sl) for p, dim, sl in
                zip(self.leaves, self.dims, self.slices)
                if dim is not None and p.grad is not None]
        for dtype in _dtypes([sl for _, _, sl in todo]):
            items = [x for x in todo if x[2].dtype == dtype]
            flat = comm.broadcast_gather(
                torch.cat([sl.reshape(-1) for _, _, sl in items])[None],
                self.mesh, "data", dim=0)                     # [dp, n]
            parts = flat.split([sl.numel() for _, _, sl in items], dim=1)
            for (p, dim, sl), part in zip(items, parts):
                p.copy_(torch.cat([x.view(sl.shape) for x in part], dim))

    def moment_bytes(self, opt: torch.optim.Optimizer
                     ) -> Tuple[int, int, int]:
        """(the bytes of this rank's AdamW moments, the bytes they would
        take if it held its TP shard's whole moments, and if it held the
        whole model's: replicated). A tensor that has had no gradient yet
        has no moments (AdamW makes them at its first update)."""
        held = whole = repl = 0
        tp = self.mesh.shape["model"]
        for p, sl, split in zip(self.leaves, self.slices, self.split):
            st = opt.state.get(sl, {})
            if "exp_avg" in st:
                held += sum(st[k].numel() * st[k].element_size()
                            for k in ("exp_avg", "exp_avg_sq"))
                whole += 2 * p.numel() * p.element_size()
                repl += 2 * p.numel() * p.element_size() * (tp if split
                                                            else 1)
        return held, whole, repl


def shard_opt_state_zero(params: Dict, specs: Dict, mesh: Mesh,
                         leaves: Optional[List[torch.Tensor]] = None
                         ) -> ZeroState:
    """ZeRO-1 placement of the optimizer state of ``params`` (this rank's
    TP shard, ``shard_params``'s tree): a ``ZeroState`` over its trained
    tensors, ``leaves`` in the optimizer's order (default: every tensor
    that ``requires_grad``, in ``leaves_with_specs`` order). Frozen
    tensors get no slice and no moments, as optax's ``MaskedNode`` keeps
    none."""
    pairs = leaves_with_specs(params, _prune_specs(specs, params))
    spec_of = {id(p): s for p, s in pairs}
    if leaves is None:
        leaves = [p for p, _ in pairs if p.requires_grad]
    return ZeroState(leaves, [spec_of[id(p)] for p in leaves], mesh)
