"""Draft-head training: the draft loss, its optimizer and one training
step. The port of the JAX package's ``train/draft_train.py``.

The recipe (EAGLE's ``main_deepspeed.py``):
- rows pair (emb of token t_{j+1}, target hidden h_j) -> predict h_{j+1};
- vloss = SmoothL1(predict, h_{j+1}), masked mean; ploss = soft cross
  entropy between softmax(head(h_{j+1})) and log_softmax(head(predict)),
  masked; medusa heads add a hard-label cross entropy;
- total = v_w * vloss + p_w * ploss;
- uniform noise on the input hidden states;
- AdamW(b1=0.9, b2=0.95) after a global-norm clip, with a linear warmup
  and a linear decay to 0 at ``total_steps``;
- a text -> visual curriculum over epochs (``curriculum_visual_ratio``).

Gradients come from ``torch.autograd`` over fp32 master weights; the
optimizer is ``torch.optim.AdamW`` with optax's update semantics (see
``make_optimizer``). Random draws come from an explicit
``torch.Generator``; the noise functions take their draws as tensors.

Over a (data, model) mesh (a tree from ``parallel/sharding.shard_params``,
its mesh under ``"mesh"``; ``head_w`` split on its columns) each rank
holds its data shard's rows of the batch and the loss is still the
global batch's: each masked numerator is summed over ``data`` through
``comm.reduce_from`` (``data_total``), the mask sums and the batch size
as constants, with the ``+ 1e-5`` added once to the global sum. The
heads' reductions over the vocabulary are split exactly over ``model``
(``VocabHead``: a split log-sum-exp; no logits row is gathered).
``train_step`` with a ``sharding.ZeroState`` sums the gradients over
``data``, clips by the mesh-wide norm and steps this rank's ZeRO-1
slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from msd_tpu_torch.configs import DraftConfig
from msd_tpu_torch.models import draft as draft_mod
from msd_tpu_torch.ops.attention import NEG_INF
from msd_tpu_torch.parallel import comm
from msd_tpu_torch.parallel import sharding


@dataclass(frozen=True)
class TrainConfig:
    v_w: float = 1.0
    p_w: float = 0.1
    lr: float = 2e-4
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 0.5
    warmup_steps: int = 2000
    total_steps: int = 800_000
    noise_std: float = 0.2
    # relative (per-element multiplicative) input noise: h *= 1 + U(-r/2,
    # r/2), which matches the statistics of bf16 rounding at any activation
    # scale (the reference's absolute noise is negligible against
    # late-layer hidden magnitudes)
    noise_rel: float = 0.0
    weight_decay: float = 0.0
    # train_embed=False freezes embed_tokens (the reference default) and
    # keeps it out of the optimizer
    train_embed: bool = False
    # rollout-augmented distillation: rollout_steps extra passes whose
    # input hiddens are the draft's own (detached) previous-pass
    # predictions shifted by one row; pass r is weighted rollout_w ** r
    rollout_steps: int = 0
    rollout_w: float = 0.5
    # normalise the regression residual by the target hidden's RMS before
    # SmoothL1 (raw deep-layer hiddens put SmoothL1 in its linear regime)
    v_norm: bool = False
    # medusa heads: head k gets a hard-label cross entropy against the
    # trajectory token k+2 steps ahead, weighted medusa_w * 0.8 ** (k-1)
    medusa_w: float = 0.2


class Batch(NamedTuple):
    """One training microbatch (post image expansion, fixed T), tensors with
    a leading batch dimension B.

    emb_next:   [B, T, H] embedding of token t_{j+1} (image rows carry the
                fused image feature)
    hidden:     [B, T, H] target hidden h_j (noise added in-step)
    target:     [B, T, H] target hidden h_{j+1}
    loss_mask:  [B, T] 1.0 on the rows trained
    attn_len:   [B] valid lengths
    img_mask:   [B, T] True on image-span rows (fc bypass)
    """

    emb_next: torch.Tensor
    hidden: torch.Tensor
    target: torch.Tensor
    loss_mask: torch.Tensor
    attn_len: torch.Tensor
    img_mask: torch.Tensor


def add_uniform_noise(hidden: torch.Tensor, std: float,
                      u: torch.Tensor) -> torch.Tensor:
    """hidden + (u - 0.5) * std * 512 / hidden_dim for a uniform [0, 1)
    draw ``u`` of hidden's shape (fp32)."""
    h = hidden.shape[-1]
    return hidden + ((u - 0.5) * std * 512.0 / h).to(hidden.dtype)


def add_relative_noise(hidden: torch.Tensor, rel: float,
                       u: torch.Tensor) -> torch.Tensor:
    """hidden * (1 + (u - 0.5) * rel) for a uniform [0, 1) draw ``u``."""
    return hidden * (1.0 + (u - 0.5) * rel).to(hidden.dtype)


class VocabHead:
    """The loss's view of the target's ``lm_head`` ``head_w``: the logits
    x @ head_w in fp32 and the cross entropies over the vocabulary. Under
    a mesh that splits ``head_w``'s columns over ``model`` the logits are
    this rank's columns and each reduction over the vocabulary is exact
    over the split, as megatron's vocabulary-parallel cross entropy
    computes it: one gather of the local maxima and their indices
    (``max_argmax``), one sum over ``model`` of the local terms
    (``total``, ``comm.reduce_from``), and every value after it computed
    replicated, so each rank's local logits receive the whole gradient;
    no [T, V] row crosses the ranks. x passes ``comm.copy_to``. Without a
    split every method is the one-device expression."""

    def __init__(self, head_w: torch.Tensor, mesh=None):
        self.w, self.mesh = head_w, mesh
        self.split = mesh is not None and mesh.group("model") is not None
        self.off = mesh.coords["model"] * head_w.shape[1] if self.split \
            else 0

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.split:
            x = comm.copy_to(x, self.mesh)
        return (x @ self.w).float()

    def max_argmax(self, lg: torch.Tensor):
        """(the maximum over the whole vocabulary, the first index of it,
        as ``torch.argmax``), constants of autograd; indices ride as fp32,
        exact below 2^24."""
        v, i = lg.detach().max(-1)
        g = comm.all_gather(torch.stack([v, (i + self.off).to(v.dtype)])[None],
                            self.mesh, "model", dim=0)       # [tp, 2, ...]
        first = g[:, 0].argmax(0)
        return g[:, 0].amax(0), g[:, 1].gather(0, first[None])[0].long()

    def total(self, *terms: torch.Tensor):
        """Each local term summed over ``model``, in one collective."""
        return comm.reduce_from(torch.stack(terms), self.mesh).unbind(0)

    def target_probs(self, lg: torch.Tensor):
        """(softmax(lg), argmax(lg)) of the target's logits."""
        if not self.split:
            return torch.softmax(lg, dim=-1), torch.argmax(lg, -1)
        m, arg = self.max_argmax(lg)
        (se,) = self.total(torch.exp(lg - m[..., None]).sum(-1))
        return torch.exp(lg - (m + torch.log(se))[..., None]), arg

    def soft_ce(self, lg: torch.Tensor, p: torch.Tensor):
        """(-sum_v p_v log_softmax(lg)_v, argmax(lg)); split, as
        -(sum p lg - lse * sum p)."""
        if not self.split:
            return (-torch.sum(p * F.log_softmax(lg, dim=-1), dim=-1),
                    torch.argmax(lg, -1))
        m, arg = self.max_argmax(lg)
        se, pl, ps = self.total(torch.exp(lg - m[..., None]).sum(-1),
                                (p * lg).sum(-1), p.sum(-1))
        return -(pl - (m + torch.log(se)) * ps), arg

    def ce(self, lg: torch.Tensor, lab: torch.Tensor):
        """(logsumexp(lg) - lg[lab], argmax(lg)) along the last
        dimension."""
        if not self.split:
            return (torch.logsumexp(lg, dim=-1)
                    - lg.gather(-1, lab[..., None])[..., 0],
                    torch.argmax(lg, -1))
        m, arg = self.max_argmax(lg)
        n = lg.shape[-1]
        loc = lab - self.off
        got = lg.gather(-1, loc.clamp(0, n - 1)[..., None])[..., 0]
        se, picked = self.total(
            torch.exp(lg - m[..., None]).sum(-1),
            torch.where((loc >= 0) & (loc < n), got, torch.zeros_like(got)))
        return m + torch.log(se) - picked, arg


def data_total(x: torch.Tensor, mesh) -> torch.Tensor:
    """x summed over the mesh's ``data`` axis (x without one); the
    gradient passes to each rank's own rows (``comm.reduce_from``)."""
    return comm.reduce_from(x, mesh, "data")


def _batch_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of the per-sequence x over the global batch."""
    if mesh is None or mesh.group("data") is None:
        return torch.mean(x)
    return data_total(torch.sum(x), mesh) / data_total(
        torch.full((), float(x.shape[0]), device=x.device), mesh)


def _head_ce(mh_k: torch.Tensor, lab_k: torch.Tensor, m_k: torch.Tensor,
             head: VocabHead):
    """(masked sum of the cross entropy of head(mh_k) against lab_k,
    masked count of top-1 agreements)."""
    ce, arg = head.ce(head.logits(mh_k), lab_k)                   # [T, V]
    return torch.sum(m_k * ce), torch.sum(m_k * (arg == lab_k).float())


def _per_seq(dparams: Dict, cfg: DraftConfig, head_w: torch.Tensor,
             emb_next, hidden, target, loss_mask, attn_len, img_mask,
             cos_t, sin_t, rollout_steps: int, rollout_w: float,
             v_norm: bool):
    """One sequence's (v_row [T], p_row [T], agree [T], med, med_agree):
    the body the JAX loss vmaps over the batch, so v_scale and the medusa
    normalisers stay per sequence."""
    head = VocabHead(head_w, dparams.get("mesh"))
    T = hidden.shape[0]
    dev = hidden.device
    pos = torch.arange(T, device=dev, dtype=torch.int32)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] < attn_len)
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    tgt_p, tgt_arg = head.target_probs(head.logits(target))

    v_scale = 1.0
    if v_norm:
        t32 = target.float()
        m32 = loss_mask.float()[:, None]
        v_scale = torch.sqrt(torch.sum(m32 * t32 * t32)
                             / (torch.sum(m32) * t32.shape[-1] + 1e-6)
                             + 1e-6).detach()

    def one_pass(hidden_in):
        hin = draft_mod.draft_fuse(dparams, emb_next, hidden_in, img_mask)
        out = draft_mod.draft_forward_nocache(dparams, cfg, hin, pos, bias,
                                              cos_t, sin_t)
        diff = (out - target).float() / v_scale
        v_elem = torch.where(diff.abs() < 1.0, 0.5 * diff * diff,
                             diff.abs() - 0.5)                 # SmoothL1
        v_row = v_elem.mean(dim=-1)
        p_row, arg = head.soft_ce(head.logits(out), tgt_p)
        return out, v_row, p_row, arg == tgt_arg

    out, v_row, p_row, agree = one_pass(hidden)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    med, med_agree = zero, zero
    n_med = dparams["medusa"]["mw"].shape[0] if "medusa" in dparams else 0
    if n_med:
        mh = draft_mod.medusa_hiddens(dparams["medusa"], out)     # [Km, T, H]
        med_den = 1e-5
        agree_den = 1e-5
        m = loss_mask.float()
        # head k predicts t_{j+2+k}: the label is the argmax of
        # head(target[j + k]), a shift of tgt_arg
        labs = [torch.cat([tgt_arg[k:], tgt_arg.new_zeros(k)])
                for k in range(1, n_med + 1)]
        masks = [torch.cat([m[k:], m.new_zeros(k)])
                 for k in range(1, n_med + 1)]
        if head.split:
            # all heads in one pass (two collectives), not recomputed:
            # each rank holds 1 / tp of their logits
            ce_all, arg_all = head.ce(head.logits(mh), torch.stack(labs))
        for k in range(1, n_med + 1):
            lab_k, m_k = labs[k - 1], masks[k - 1]
            wk = 0.8 ** (k - 1)
            if head.split:
                ce_sum = torch.sum(m_k * ce_all[k - 1])
                ag_sum = torch.sum(m_k * (arg_all[k - 1] == lab_k).float())
            else:
                # recomputed in backward: n_med [T, V] fp32 logits alive
                # until the gradient pass do not fit at 7B width
                ce_sum, ag_sum = checkpoint(_head_ce, mh[k - 1], lab_k, m_k,
                                            head, use_reentrant=False)
            med = med + wk * ce_sum
            med_den = med_den + wk * torch.sum(m_k)
            if k == 1:
                med_agree = ag_sum
                agree_den = agree_den + torch.sum(m_k)
        med = med / med_den
        med_agree = med_agree / agree_den

    w_sum = 1.0
    for r in range(1, rollout_steps + 1):
        # row j's input hidden becomes the draft's own prediction of h_j
        # (the previous pass's row j-1): the depth-(r+1) expansion input
        h_r = torch.cat([hidden[:1], out[:-1].detach()], dim=0)
        out, v_r, p_r, _ = one_pass(h_r)
        w = rollout_w ** r
        v_row = v_row + w * v_r
        p_row = p_row + w * p_r
        w_sum += w
    return v_row / w_sum, p_row / w_sum, agree, med, med_agree


def draft_loss(dparams: Dict, cfg: DraftConfig, head_w: torch.Tensor,
               batch: Batch, cos_t, sin_t, rollout_steps: int = 0,
               rollout_w: float = 0.5, v_norm: bool = False,
               medusa_w: float = 0.2
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """(vloss, ploss, top1 agreement, medusa head-1 agreement) of a batch.

    head_w: [H, V] the target's lm_head in the draft's dtype (fp32 for
    training: torch multiplies no mixed dtypes, so a trainer casts it
    once); under a mesh (``dparams["mesh"]``) this rank's [H, V / tp]
    columns, and ``batch`` this rank's rows of the global batch, whose
    means the losses are (``data_total``)."""
    mesh = dparams.get("mesh")
    rows = [_per_seq(dparams, cfg, head_w, *(x[b] for x in batch), cos_t,
                     sin_t, rollout_steps, rollout_w, v_norm)
            for b in range(batch.hidden.shape[0])]
    v_row, p_row, agree, med, med_agree = (torch.stack(x) for x in zip(*rows))
    m = batch.loss_mask.float()
    denom = data_total(torch.sum(m), mesh) + 1e-5
    vloss = data_total(torch.sum(m * v_row), mesh) / denom
    ploss = data_total(torch.sum(m * p_row), mesh) / denom \
        + medusa_w * _batch_mean(med, mesh)
    top1 = data_total(torch.sum(m * agree.float()), mesh) / denom
    return vloss, ploss, top1, _batch_mean(med_agree, mesh)


def lr_schedule(tc: TrainConfig, count: int) -> float:
    """Learning rate of update ``count`` (from 0): a linear warmup from 0
    to ``tc.lr`` over ``warmup_steps``, then a linear decay to 0 at
    ``total_steps`` (optax's join of two linear schedules)."""
    w = tc.warmup_steps
    if count < w:
        return tc.lr * count / w
    decay = max(tc.total_steps - w, 1)
    return tc.lr * (1.0 - min(count - w, decay) / decay)


def trainable(tc: TrainConfig, name: str) -> bool:
    """Whether the top-level draft entry ``name`` is trained."""
    return tc.train_embed or name != "embed_tokens"


def trained_leaves(tc: TrainConfig, dparams: Dict):
    """The tensors ``make_optimizer`` steps, in its order."""
    return [t for name, sub in dparams.items()
            if name != "mesh" and trainable(tc, name)
            for t in _tensors(sub)]


def make_optimizer(tc: TrainConfig, dparams: Dict) -> torch.optim.AdamW:
    """AdamW over the trainable leaves of ``dparams`` (every entry but
    ``embed_tokens`` unless ``tc.train_embed``), with the semantics of the
    JAX ``optax.masked(chain(clip_by_global_norm, adamw(schedule)))``
    when ``train_step`` drives it: the clip (``clip_by_global_norm``) over
    the trainable gradients only, decoupled weight decay, eps outside the
    square root, and update k at ``lr_schedule(tc, k)``, so the first
    update moves only the moments."""
    return torch.optim.AdamW(trained_leaves(tc, dparams), lr=0.0,
                             betas=(tc.b1, tc.b2), eps=1e-8,
                             weight_decay=tc.weight_decay)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    return [tree]


def clip_by_global_norm(grads, max_norm: float, mesh=None,
                        split=None) -> None:
    """optax's clip, in place: g -> g / |g| * max_norm where the global norm
    |g| >= max_norm, unchanged below it. Under a ``mesh`` the grads are
    this rank's blocks and |g| the whole tree's
    (``sharding.global_sq_norm``; ``split`` marks the blocks split over
    ``model``)."""
    if mesh is None or not any(split):
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    else:
        g_norm = torch.sqrt(sharding.global_sq_norm(grads, split, mesh))
    for g in grads:
        g.copy_(torch.where(g_norm < max_norm, g, g / g_norm * max_norm))


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (optax's schedule count)."""
    return max((int(s["step"]) for s in opt.state.values()), default=0)


def _draw(shape, rng: torch.Generator, dev, mesh) -> torch.Tensor:
    """A uniform draw for this rank's rows: the global batch's draw
    (``shape[0]`` rows on each of ``data``'s ranks), this rank's rows of
    it, so a sharded step sees the one-device step's noise."""
    dp = 1 if mesh is None else mesh.shape["data"]
    if dp == 1:
        return torch.rand(shape, generator=rng, device=dev)
    u = torch.rand((shape[0] * dp,) + tuple(shape[1:]), generator=rng,
                   device=dev)
    return u.narrow(0, mesh.coords["data"] * shape[0], shape[0])


def train_step(dparams: Dict, opt: torch.optim.AdamW, cfg: DraftConfig,
               tcfg: TrainConfig, head_w: torch.Tensor, batch: Batch,
               rng: torch.Generator, cos_t, sin_t,
               zero: Optional[sharding.ZeroState] = None
               ) -> Dict[str, torch.Tensor]:
    """One update of ``dparams`` (in place, through ``opt`` from
    ``make_optimizer``): noise on the input hiddens from ``rng``, the
    loss's gradient, the clip, and AdamW at the schedule's rate. Returns
    the step's metrics as 0-dim tensors. Over a mesh (``dparams["mesh"]``,
    ``batch`` this rank's rows) ``opt`` steps the slices of ``zero``
    (``sharding.shard_opt_state_zero``): the gradients are summed over
    ``data``, clipped by the mesh-wide norm, and the stepped slices are
    gathered back into ``dparams``."""
    mesh = dparams.get("mesh")
    hidden = batch.hidden
    shape, dev = hidden.shape, hidden.device
    hidden = add_uniform_noise(hidden, tcfg.noise_std,
                               _draw(shape, rng, dev, mesh))
    if tcfg.noise_rel > 0.0:
        hidden = add_relative_noise(hidden, tcfg.noise_rel,
                                    _draw(shape, rng, dev, mesh))
    batch = batch._replace(hidden=hidden)

    v, pl, top1, med_agree = draft_loss(
        dparams, cfg, head_w, batch, cos_t, sin_t,
        rollout_steps=tcfg.rollout_steps, rollout_w=tcfg.rollout_w,
        v_norm=tcfg.v_norm, medusa_w=tcfg.medusa_w)
    loss = tcfg.v_w * v + tcfg.p_w * pl
    if zero is None:
        opt.zero_grad(set_to_none=False)
        loss.backward()
        # a leaf outside the loss (a trained embed_tokens) has no
        # gradient: AdamW skips it, as optax's zero update leaves it
        clip_by_global_norm([p.grad for p in opt.param_groups[0]["params"]
                             if p.grad is not None], tcfg.grad_clip)
    else:
        zero.zero_grad()
        loss.backward()
        grads, split = zero.grads()
        sharding.reduce_grads(grads, mesh)
        clip_by_global_norm(grads, tcfg.grad_clip, mesh, split)
        zero.scatter_grads()
    lr = lr_schedule(tcfg, update_count(opt))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    if zero is not None:
        zero.gather()
    return {"loss": loss.detach(), "vloss": v.detach(), "ploss": pl.detach(),
            "top1_agree": top1.detach(), "medusa1_agree": med_agree.detach()}


def curriculum_visual_ratio(epoch: int, num_epochs: int) -> float:
    """Text-only for the first half, then a linear ramp to all-visual."""
    half = num_epochs // 2
    if epoch < half:
        return 0.0
    if num_epochs == half:
        return 1.0
    return min(1.0, (epoch - half + 1) / max(num_epochs - half, 1))
