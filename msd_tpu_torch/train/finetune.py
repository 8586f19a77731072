"""LLaVA target-model finetuning: the port of the JAX package's
``train/finetune.py`` (reference: LLaVA/llava/train/train.py and
llava_trainer.py).

The reference's training regimes:
- stage-1 projector pretraining: ``tune_mm_mlp_adapter=True`` trains ONLY
  the mm projector (train.py:189, :926-941, the "pretrain" stage of the
  LLaVA recipe);
- stage-2 full finetune: LM + projector train together, with an optional
  separate projector learning rate (``mm_projector_lr``, train.py:111 and
  llava_trainer.py:126-146 parameter groups);
- ``freeze_backbone`` (train.py:57, :844) freezes the LM while the
  projector trains at its own lr.
The vision tower stays frozen (the reference default): records carry the
PRE-projection CLIP features, so projector gradients flow while the tower
runs once per example offline.

Loss: next-token cross-entropy over assistant-reply rows in post-expansion
coordinates (the conversation and loss mask of
``train/data_gen.build_conversation_ids``), through the projector (in
fp32, as JAX promotes the bf16 weights against the fp32 features), the
engine's fusion (``models/llava.fuse_embeddings``) and the decoder without
a KV cache (``models/llama.llama_forward_nocache``, which equals the
cached prefill bitwise but leaves autograd fresh tensors), with an fp32
log-softmax over the full vocabulary.

The optimizer is the JAX ``optax.multi_transform`` of two groups, ``lm``
and ``proj``: each group is an AdamW (``torch.optim.AdamW``, one tensor at
a time, so its largest temporary is one stacked weight) behind a clip by
that group's OWN global norm, with a linear warmup from 0 and a cosine
decay set per update (update 0 runs at lr 0); the ``lm`` group is
``set_to_zero`` under ``tune_mm_mlp_adapter`` or ``freeze_backbone``,
which the port makes ``requires_grad=False`` and no optimizer. Parameters,
gradients and moments keep the parameters' dtype (bf16 on the card, as
optax keeps them for the JAX CLI's bf16 load), with no fp32 master copy.

With a (data, model) ``mesh`` (``LlavaFinetuner(..., mesh=)``, every rank
running the same calls) the LM is this rank's megatron shard
(``llama_param_specs(cfg, stacked=True)``; the LM's collectives carry
autograd, ``comm.copy_to``/``reduce_from``/``gather_from``, and the
``lm_head`` log-softmax reads the gathered columns), the projector is
replicated, each batch gives each data rank its contiguous rows, the
mask sum is the global batch's, the gradients are summed over ``data``,
each group is clipped by its own mesh-wide norm, and each group's AdamW
steps this rank's ZeRO-1 slices (``shard_opt_state_zero``: the stacked
layers' moments split over ``data`` on the layer axis), still in the
parameters' dtype with no master copy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX, LlamaConfig
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.models.llava import (expand_ids, fuse_embeddings,
                                        projector_apply)
from msd_tpu_torch.ops.attention import NEG_INF
from msd_tpu_torch.parallel import comm, sharding
from msd_tpu_torch.parallel.comm import Mesh
from msd_tpu_torch.train.data_gen import (build_conversation_ids,
                                          expand_loss_mask)
from msd_tpu_torch.train.draft_train import update_count
from msd_tpu_torch.train.trainer import data_rows, tree_map
from msd_tpu_torch.utils.conversation import DEFAULT_VICUNA_SYSTEM


@dataclass(frozen=True)
class FinetuneConfig:
    lr: float = 2e-5                      # train.py finetune default scale
    mm_projector_lr: Optional[float] = None   # train.py:111; None = lr
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    # stage-1: train only the projector (train.py tune_mm_mlp_adapter)
    tune_mm_mlp_adapter: bool = False
    # freeze the LM backbone while other groups train (train.py:844)
    freeze_backbone: bool = False


class FinetuneBatch(NamedTuple):
    """One microbatch (unexpanded token space; expansion happens in-step).

    ids:        [B, Tp] padded prompt+reply ids (IMAGE_TOKEN_INDEX at img_pos)
    clip_feats: [B, n_img, Hv] pre-projection CLIP features (zeros if no img)
    img_pos:    [B] placeholder position (>= attn_len when no image)
    attn_len:   [B] valid unexpanded lengths
    tgt_mask:   [B, P_exp] 1.0 where row j's next-token label is trained
    """

    ids: torch.Tensor
    clip_feats: torch.Tensor
    img_pos: torch.Tensor
    attn_len: torch.Tensor
    tgt_mask: torch.Tensor


def make_finetune_record(tokenizer, turns: Sequence[Tuple[str, str]],
                         clip_feats: Optional[np.ndarray], n_img: int,
                         pad_to: int,
                         system: str = DEFAULT_VICUNA_SYSTEM) -> Dict:
    """Host-side record: conversation ids + expanded next-token loss mask.

    clip_feats: [n_img, Hv] PRE-projection tower output (frozen tower run
    offline), or None for a text-only conversation.
    """
    with_image = clip_feats is not None and n_img > 0
    ids, loss_mask = build_conversation_ids(tokenizer, turns, with_image,
                                            system=system)
    ids = ids[:pad_to]
    loss_mask = loss_mask[:pad_to]
    img_positions = np.nonzero(ids == IMAGE_TOKEN_INDEX)[0]
    img_pos = int(img_positions[0]) if len(img_positions) else pad_to
    P_exp = pad_to + max(n_img - 1, 0)
    e_len = len(ids) + (n_img - 1 if with_image else 0)
    exp_mask = expand_loss_mask(loss_mask, len(ids), img_pos, n_img,
                                with_image, P_exp)
    # row j's label is expanded token j+1 -> shift the label mask onto row j
    tmask = np.concatenate([exp_mask[1:], np.zeros((1,), np.float32)])
    tmask[max(e_len - 1, 0):] = 0.0

    padded = np.zeros((pad_to,), np.int32)
    padded[:len(ids)] = ids
    return {"ids": padded, "clip_feats": clip_feats, "img_pos": img_pos,
            "attn_len": np.int32(len(ids)), "tgt_mask": tmask}


def finetune_bias(e_len: int, rows: int, device) -> torch.Tensor:
    """The causal key mask [rows, rows] of a sequence whose first ``e_len``
    expanded rows are real: row i sees keys j <= i with j < e_len."""
    pos = torch.arange(rows, device=device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] < e_len)
    return torch.where(keep, 0.0, NEG_INF).to(torch.float32)


def _seq_terms(params: Dict, cfg: LlamaConfig, n_img: int, ids, clip_feats,
               img_pos: int, attn_len: int, tgt_mask, cos_t, sin_t):
    """One sequence's (masked nll sum, masked next-token agreement sum):
    the body the JAX loss vmaps over the batch. Whether the sequence has
    an image is known on the host here (JAX selects both branches with
    ``where``; the values are the same)."""
    tp = params["target"]
    Tp = ids.shape[0]
    P_exp = Tp + max(n_img - 1, 0)
    has_img = n_img > 0 and img_pos < attn_len
    e_len = attn_len + (max(n_img - 1, 0) if has_img else 0)
    safe = torch.clamp(ids, min=0)
    if has_img:
        proj = tree_map(lambda t: t.float(), params["projector"])
        feats = projector_apply(proj, clip_feats.float())
        fused = fuse_embeddings(tp, ids, feats, img_pos, P_exp)
        exp_ids = expand_ids(safe, img_pos, n_img, P_exp)
    else:
        fused = L.embed_tokens(tp, safe)
        exp_ids = safe
        if P_exp > Tp:
            fused = torch.cat([fused, fused.new_zeros(P_exp - Tp,
                                                      fused.shape[1])])
            exp_ids = torch.cat([safe, safe.new_zeros(P_exp - Tp)])
    dev = fused.device
    hidden = L.llama_forward_nocache(
        tp, cfg, fused, torch.arange(P_exp, dtype=torch.int32, device=dev),
        finetune_bias(e_len, P_exp, dev), cos_t, sin_t)
    logits = L.lm_head(tp, hidden)                          # [P_exp, V] f32
    labels = torch.cat([exp_ids[1:], exp_ids.new_zeros(1)]).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    agree = (torch.argmax(logits, -1) == labels).float()
    return torch.sum(nll * tgt_mask), torch.sum(agree * tgt_mask)


def _seq_args(batch: FinetuneBatch, b: int):
    return (batch.ids[b], batch.clip_feats[b], int(batch.img_pos[b]),
            int(batch.attn_len[b]), batch.tgt_mask[b])


def finetune_loss(params: Dict, cfg: LlamaConfig, n_img: int,
                  batch: FinetuneBatch, cos_t, sin_t
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked mean next-token cross entropy, masked next-token agreement)
    of a batch through the projector and the fused-embedding LM forward."""
    denom = torch.sum(batch.tgt_mask) + 1e-5
    nll, agree = zip(*(_seq_terms(params, cfg, n_img, *_seq_args(batch, b),
                                  cos_t, sin_t)
                       for b in range(batch.ids.shape[0])))
    return sum(nll) / denom, sum(agree) / denom


def _param_labels(params: Dict) -> Dict:
    """'proj' for the mm projector, 'lm' for everything else."""
    return {"target": tree_map(lambda _: "lm", params["target"]),
            "projector": tree_map(lambda _: "proj", params["projector"])}


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) if k != "mesh"
                for t in _leaves(tree[k])]
    return [tree]


def finetune_lr(fc: FinetuneConfig, lr: float, count: int) -> float:
    """The rate of update ``count`` (from 0): optax's join of a linear
    warmup from 0 to ``lr`` over ``warmup_steps`` and a cosine decay to 0
    over the remaining ``total_steps``."""
    w = fc.warmup_steps
    if count < w:
        return lr * count / w
    decay = max(fc.total_steps - w, 1)
    c = min(count - w, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))


def make_finetune_optimizer(fc: FinetuneConfig, params: Dict,
                            specs: Optional[Dict] = None
                            ) -> Tuple[Dict[str, torch.optim.AdamW],
                                       Optional[Dict]]:
    """({group: AdamW}, {group: ZeroState} or None) over the groups that
    train (``_param_labels``): ``proj`` always, ``lm`` unless
    ``tune_mm_mlp_adapter`` or ``freeze_backbone`` (optax's
    ``set_to_zero``). Marks every tensor of ``params`` ``requires_grad``
    by whether its group trains. Each group keeps its base rate under
    ``"base_lr"``; ``finetune_step`` clips the group by its own global
    norm and sets the scheduled rate per update. With ``specs`` (the
    tree's megatron specs; ``params["target"]`` carries its mesh) each
    AdamW steps its group's ZeRO-1 slices (``shard_opt_state_zero``)."""
    lm_frozen = fc.tune_mm_mlp_adapter or fc.freeze_backbone
    proj_lr = fc.mm_projector_lr if fc.mm_projector_lr is not None else fc.lr
    groups = {"lm": ("target", fc.lr, not lm_frozen),
              "proj": ("projector", proj_lr, True)}
    opts, zero = {}, None if specs is None else {}
    for name, (part, lr, trains) in groups.items():
        leaves = _leaves(params[part])
        for t in leaves:
            t.requires_grad_(trains)
        if not trains:
            continue
        if specs is not None:
            zero[name] = sharding.shard_opt_state_zero(
                params[part], specs[part], params["target"]["mesh"])
            leaves = zero[name].slices
        opt = torch.optim.AdamW(leaves, lr=0.0, betas=(fc.b1, fc.b2),
                                eps=1e-8, weight_decay=fc.weight_decay,
                                foreach=False)
        opt.param_groups[0]["base_lr"] = lr
        opts[name] = opt
    return opts, zero


def clip_group(grads: List[torch.Tensor], max_norm: float, mesh=None,
               split=None) -> None:
    """optax's ``clip_by_global_norm`` over one group, in place with no
    temporaries of a gradient's size: g -> (g / |g|) * max_norm where the
    group's global norm |g| (accumulated in fp32) >= max_norm. Under a
    ``mesh`` the grads are this rank's blocks and |g| the group's
    mesh-wide norm (``sharding.global_sq_norm`` in fp32; ``split`` marks
    the blocks split over ``model``)."""
    if mesh is None or not any(split):
        g_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g).float() for g in grads]))
    else:
        g_norm = torch.sqrt(sharding.global_sq_norm(grads, split, mesh,
                                                    torch.float32))
    if bool(g_norm >= max_norm):
        for g in grads:
            g.div_(g_norm.to(g.dtype)).mul_(max_norm)


def finetune_step(params: Dict, opt: Dict[str, torch.optim.AdamW],
                  cfg: LlamaConfig, fc: FinetuneConfig, n_img: int,
                  batch: FinetuneBatch, cos_t, sin_t,
                  zero: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """One update of ``params`` in place through ``opt``
    (``make_finetune_optimizer``). The gradient is taken one sequence at a
    time (the loss divides by the batch's mask sum, known up front), so
    one sequence's activations are alive at once. A trained tensor the
    batch gives no gradient (the projector under a text-only batch) gets
    a zero one, so its moments and count advance as optax's do. Returns
    the batch's loss and next-token agreement as 0-dim tensors. With
    ``zero`` (the optimizer's ZeRO states; ``batch`` this rank's rows of
    the global batch) the mask sum and the metrics are the global
    batch's, the gradients are summed over ``data`` and clipped by the
    mesh-wide norm, and the stepped slices are gathered back."""
    mesh = params["target"].get("mesh")
    trained = [p for o in opt.values() for p in o.param_groups[0]["params"]]
    if zero is not None:
        trained += [p for z in zero.values() for p in z.leaves]
    for p in trained:
        p.grad = None
    denom = comm.reduce_from(torch.sum(batch.tgt_mask), mesh, "data") + 1e-5
    nll_sum, agree_sum = 0.0, 0.0
    for b in range(batch.ids.shape[0]):
        nll, agree = _seq_terms(params, cfg, n_img, *_seq_args(batch, b),
                                cos_t, sin_t)
        if nll.requires_grad:
            (nll / denom).backward()
        nll_sum = nll_sum + nll.detach()
        agree_sum = agree_sum + agree
    if zero is not None:
        nll_sum, agree_sum = (comm.all_reduce(torch.as_tensor(
            x, dtype=torch.float32, device=denom.device), mesh, "data")
            for x in (nll_sum, agree_sum))
    for name, o in opt.items():
        group = o.param_groups[0]
        z = None if zero is None else zero[name]
        ps = group["params"] if z is None else z.leaves
        for p in ps:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in ps]
        if z is None:
            clip_group(grads, fc.grad_clip)
        else:
            sharding.reduce_grads(grads, mesh)
            clip_group(grads, fc.grad_clip, mesh, z.split)
            z.scatter_grads()
        group["lr"] = finetune_lr(fc, group["base_lr"], update_count(o))
        o.step()
        if z is not None:
            z.gather()
    for p in trained:
        p.grad = None
    return {"loss": nll_sum / denom, "next_token_agree": agree_sum / denom}


class LlavaFinetuner:
    """Finetuning driver for {target LM + mm projector} bundles.

    params: {"target": llama params, "projector": mlp2x params}, trained IN
    PLACE (the caller's tensors are the finetuner's) on one device. With
    ``mesh`` (a (data, model) ``comm.Mesh``; see the module docstring)
    the finetuner trains this rank's shard of them (``self.params``:
    the LM's megatron slices, carrying the mesh, and a copy of the
    projector), takes the global batch in ``step``/``run`` and gives each
    data rank its rows; ``gathered_params`` rebuilds the full tree."""

    def __init__(self, cfg: LlamaConfig, params: Dict, n_img: int,
                 fc: FinetuneConfig = FinetuneConfig(),
                 max_exp_len: int = 512, mesh: Optional[Mesh] = None):
        self.cfg, self.fc, self.n_img, self.mesh = cfg, fc, n_img, mesh
        self.specs = None
        if mesh is not None:
            self.specs = {"target": sharding.llama_param_specs(cfg, True),
                          "projector": tree_map(lambda _: (),
                                                params["projector"])}
            params = {"target": sharding.shard_params(
                          tree_map(torch.Tensor.detach, params["target"]),
                          self.specs["target"], mesh),
                      "projector": tree_map(lambda t: t.detach().clone(),
                                            params["projector"])}
        self.params = params
        self.opt, self.zero = make_finetune_optimizer(fc, params, self.specs)
        dev = params["target"]["embed_tokens"].device
        self.cos_t, self.sin_t = L.make_rope(cfg, max_exp_len + 8, dev)
        self.step_count = 0

    def gathered_params(self) -> Dict:
        """A copy of the full tree (under a mesh every rank must call
        it)."""
        if self.mesh is None:
            return tree_map(lambda t: t.detach().clone(), self.params)
        return {"target": sharding.gather_params(
                    self.params["target"], self.specs["target"], self.mesh),
                "projector": tree_map(lambda t: t.detach().clone(),
                                      self.params["projector"])}

    def step(self, batch: FinetuneBatch) -> Dict[str, torch.Tensor]:
        if self.mesh is not None:
            batch = data_rows(batch, self.mesh)
        metrics = finetune_step(self.params, self.opt, self.cfg, self.fc,
                                self.n_img, batch, self.cos_t, self.sin_t,
                                self.zero)
        self.step_count += 1
        return metrics

    def run(self, batches: Iterator[FinetuneBatch], log=print,
            log_every: int = 50) -> Dict[str, float]:
        acc: Dict[str, float] = {}
        n = 0
        for batch in batches:
            metrics = self.step(batch)
            n += 1
            for k, v in metrics.items():
                acc[k] = acc.get(k, 0.0) + float(v)
            if n % log_every == 0:
                log(f"step {self.step_count}: " + " ".join(
                    f"{k}={acc[k]/n:.4f}" for k in acc))
        return {k: v / max(n, 1) for k, v in acc.items()}


def batches_from_finetune_records(records: List[Dict], batch_size: int,
                                  rng: np.random.Generator, n_img: int,
                                  vision_h: int, device="cuda"
                                  ) -> Iterator[FinetuneBatch]:
    """Batches in the order of one ``rng.permutation`` (JAX's numpy
    stream); a last incomplete batch is dropped. Text-only records get
    zero features."""
    order = rng.permutation(len(records))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        group = [records[j] for j in order[i:i + batch_size]]
        feats = np.stack([
            (g["clip_feats"] if g["clip_feats"] is not None
             else np.zeros((n_img, vision_h), np.float32)) for g in group]) \
            if n_img > 0 else np.zeros((len(group), 0, vision_h), np.float32)

        def dev(a, dtype=None):
            return torch.from_numpy(np.asarray(a, dtype)).to(device)

        yield FinetuneBatch(
            ids=dev(np.stack([g["ids"] for g in group])),
            clip_feats=dev(feats, np.float32),
            img_pos=dev([g["img_pos"] for g in group], np.int32),
            attn_len=dev([g["attn_len"] for g in group], np.int32),
            tgt_mask=dev(np.stack([g["tgt_mask"] for g in group])))
