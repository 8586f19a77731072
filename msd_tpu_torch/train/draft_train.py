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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from msd_tpu_torch.configs import DraftConfig
from msd_tpu_torch.models import draft as draft_mod
from msd_tpu_torch.ops.attention import NEG_INF


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


def _head_ce(mh_k: torch.Tensor, head_w: torch.Tensor, lab_k: torch.Tensor,
             m_k: torch.Tensor):
    """(masked sum of the cross entropy of head(mh_k) against lab_k,
    masked count of top-1 agreements)."""
    lg = (mh_k @ head_w).float()                                   # [T, V]
    ce = torch.logsumexp(lg, dim=-1) - lg.gather(1, lab_k[:, None])[:, 0]
    ag = torch.sum(m_k * (torch.argmax(lg, -1) == lab_k).float())
    return torch.sum(m_k * ce), ag


def _per_seq(dparams: Dict, cfg: DraftConfig, head_w: torch.Tensor,
             emb_next, hidden, target, loss_mask, attn_len, img_mask,
             cos_t, sin_t, rollout_steps: int, rollout_w: float,
             v_norm: bool):
    """One sequence's (v_row [T], p_row [T], agree [T], med, med_agree):
    the body the JAX loss vmaps over the batch, so v_scale and the medusa
    normalisers stay per sequence."""
    T = hidden.shape[0]
    dev = hidden.device
    pos = torch.arange(T, device=dev, dtype=torch.int32)
    keep = (pos[None, :] <= pos[:, None]) & (pos[None, :] < attn_len)
    bias = torch.where(keep, 0.0, NEG_INF).to(torch.float32)
    tgt_logits = (target @ head_w).float()
    tgt_p = torch.softmax(tgt_logits, dim=-1)
    tgt_arg = torch.argmax(tgt_logits, -1)

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
        logits = (out @ head_w).float()
        p_row = -torch.sum(tgt_p * F.log_softmax(logits, dim=-1), dim=-1)
        agree = torch.argmax(logits, -1) == tgt_arg
        return out, v_row, p_row, agree

    out, v_row, p_row, agree = one_pass(hidden)

    zero = torch.zeros((), dtype=torch.float32, device=dev)
    med, med_agree = zero, zero
    n_med = dparams["medusa"]["mw"].shape[0] if "medusa" in dparams else 0
    if n_med:
        mh = draft_mod.medusa_hiddens(dparams["medusa"], out)     # [Km, T, H]
        med_den = 1e-5
        agree_den = 1e-5
        m = loss_mask.float()
        for k in range(1, n_med + 1):
            # head k predicts t_{j+2+k}: the label is the argmax of
            # head(target[j + k]), a shift of tgt_arg
            lab_k = torch.cat([tgt_arg[k:], tgt_arg.new_zeros(k)])
            m_k = torch.cat([m[k:], m.new_zeros(k)])
            wk = 0.8 ** (k - 1)
            # recomputed in backward: n_med [T, V] fp32 logits alive until
            # the gradient pass do not fit at 7B width
            ce_sum, ag_sum = checkpoint(_head_ce, mh[k - 1], head_w, lab_k,
                                        m_k, use_reentrant=False)
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
    once)."""
    rows = [_per_seq(dparams, cfg, head_w, *(x[b] for x in batch), cos_t,
                     sin_t, rollout_steps, rollout_w, v_norm)
            for b in range(batch.hidden.shape[0])]
    v_row, p_row, agree, med, med_agree = (torch.stack(x) for x in zip(*rows))
    m = batch.loss_mask.float()
    denom = torch.sum(m) + 1e-5
    vloss = torch.sum(m * v_row) / denom
    ploss = torch.sum(m * p_row) / denom + medusa_w * torch.mean(med)
    top1 = torch.sum(m * agree.float()) / denom
    return vloss, ploss, top1, torch.mean(med_agree)


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


def make_optimizer(tc: TrainConfig, dparams: Dict) -> torch.optim.AdamW:
    """AdamW over the trainable leaves of ``dparams`` (every entry but
    ``embed_tokens`` unless ``tc.train_embed``), with the semantics of the
    JAX ``optax.masked(chain(clip_by_global_norm, adamw(schedule)))``
    when ``train_step`` drives it: the clip (``clip_by_global_norm``) over
    the trainable gradients only, decoupled weight decay, eps outside the
    square root, and update k at ``lr_schedule(tc, k)``, so the first
    update moves only the moments."""
    leaves = [t for name, sub in dparams.items() if trainable(tc, name)
              for t in _tensors(sub)]
    return torch.optim.AdamW(leaves, lr=0.0, betas=(tc.b1, tc.b2), eps=1e-8,
                             weight_decay=tc.weight_decay)


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _tensors(tree[key])]
    return [tree]


def clip_by_global_norm(grads, max_norm: float) -> None:
    """optax's clip, in place: g -> g / |g| * max_norm where the global norm
    |g| >= max_norm, unchanged below it."""
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(g_norm < max_norm, g, g / g_norm * max_norm))


def update_count(opt: torch.optim.Optimizer) -> int:
    """Updates the optimizer has applied (optax's schedule count)."""
    return max((int(s["step"]) for s in opt.state.values()), default=0)


def train_step(dparams: Dict, opt: torch.optim.AdamW, cfg: DraftConfig,
               tcfg: TrainConfig, head_w: torch.Tensor, batch: Batch,
               rng: torch.Generator, cos_t, sin_t) -> Dict[str, torch.Tensor]:
    """One update of ``dparams`` (in place, through ``opt`` from
    ``make_optimizer``): noise on the input hiddens from ``rng``, the
    loss's gradient, the clip, and AdamW at the schedule's rate. Returns
    the step's metrics as 0-dim tensors."""
    hidden = batch.hidden
    shape, dev = hidden.shape, hidden.device
    hidden = add_uniform_noise(hidden, tcfg.noise_std, torch.rand(
        shape, generator=rng, device=dev))
    if tcfg.noise_rel > 0.0:
        hidden = add_relative_noise(hidden, tcfg.noise_rel, torch.rand(
            shape, generator=rng, device=dev))
    batch = batch._replace(hidden=hidden)

    v, pl, top1, med_agree = draft_loss(
        dparams, cfg, head_w, batch, cos_t, sin_t,
        rollout_steps=tcfg.rollout_steps, rollout_w=tcfg.rollout_w,
        v_norm=tcfg.v_norm, medusa_w=tcfg.medusa_w)
    loss = tcfg.v_w * v + tcfg.p_w * pl
    opt.zero_grad(set_to_none=False)
    loss.backward()
    # a leaf outside the loss (a trained embed_tokens) has no gradient:
    # AdamW skips it, as optax's zero update leaves it
    clip_by_global_norm([p.grad for p in opt.param_groups[0]["params"]
                         if p.grad is not None], tcfg.grad_clip)
    lr = lr_schedule(tcfg, update_count(opt))
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
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
