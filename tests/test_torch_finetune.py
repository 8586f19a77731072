"""The port's LLaVA finetuning (``msd_tpu_torch.train.finetune``) and its
training forward (``models/llama.llama_forward_nocache``) against the JAX
package's ``train/finetune.py``, on tiny fp32 configs on the CPU.

The same JAX-initialised target and projector go to both sides through the
bridge; records come from ``make_finetune_record`` over seeded
conversations and numpy CLIP features. Tolerances: the loss and its
gradients within 1e-5 relative (gradients against 1e-5 of the tensor's
largest magnitude); parameters after three optimizer steps within 1e-5;
records, batch order and the training forward against ``llama_forward``
bitwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import llama as JL
from msd_tpu.models import llava as JV
from msd_tpu.train import finetune as JF
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops.attention import causal_prefill_bias
from msd_tpu_torch.train import finetune as TF
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

V, H, VH, N_IMG, PAD = 300, 32, 16, 5, 96
CFG = dict(vocab_size=V, hidden_size=H, layers=2, heads=4,
           intermediate_size=64, max_pos=512)
VISION = dict(hidden_size=VH, layers=1, heads=2, image_size=28,
              patch_size=14, intermediate_size=32)
MAX_EXP = PAD + N_IMG - 1


def _cfgs():
    jl = JC.LlavaConfig(text=JC.LlamaConfig.tiny(**CFG),
                        vision=JC.ClipVisionConfig.tiny(**VISION))
    tl = TC.LlavaConfig(text=TC.LlamaConfig.tiny(**CFG),
                        vision=TC.ClipVisionConfig.tiny(**VISION))
    return jl, tl


def _params(seed=0):
    """(JAX params, port params) {"target", "projector"}, fp32."""
    jl, _ = _cfgs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    jp = {"target": JL.init_llama_params(k1, jl.text),
          "projector": JV.init_projector_params(k2, jl)}
    host = jax.tree.map(lambda a: np.array(a, copy=True), jp)
    return jp, bridge.to_torch(host, "cpu")


def _records(n=6, seed=1, images=(True, False, True, True, False, True)):
    """n finetune records (JAX's make_finetune_record) of seeded two-turn
    conversations, image or text-only by ``images``."""
    rng = np.random.default_rng(seed)
    tok = JTok(vocab_size=V)
    out = []
    for i in range(n):
        turns = [(f"q{i} " + "x" * int(rng.integers(2, 9)),
                  f"answer {i} " + "y" * int(rng.integers(3, 12))),
                 ("more?", "z" * int(rng.integers(1, 6)))]
        feats = rng.normal(size=(N_IMG, VH)).astype(np.float32) \
            if images[i % len(images)] else None
        out.append(JF.make_finetune_record(tok, turns, feats, N_IMG, PAD,
                                           system=""))
    return out


def _batches(records, bs, seed=0):
    """The same batches for both sides: (JAX list, port list)."""
    jb = list(JF.batches_from_finetune_records(
        records, bs, np.random.default_rng(seed), N_IMG, VH))
    tb = list(TF.batches_from_finetune_records(
        records, bs, np.random.default_rng(seed), N_IMG, VH, device="cpu"))
    return jb, tb


def _ropes(jcfg, tcfg):
    return (JL.make_rope(jcfg, MAX_EXP + 8),
            TL.make_rope(tcfg, MAX_EXP + 8, "cpu"))


def _close_tree(got, want, rel=1e-5, path=""):
    if isinstance(want, dict):
        for k in want:
            _close_tree(got[k], want[k], rel, f"{path}.{k}")
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    w = np.asarray(want)
    scale = max(float(np.max(np.abs(w))), 1e-30)
    np.testing.assert_allclose(g, w, rtol=rel, atol=rel * scale,
                               err_msg=path)


@pytest.mark.parametrize("image", [True, False])
def test_make_finetune_record_matches_jax(image):
    rng = np.random.default_rng(3)
    turns = [("what is this?", "a cat on a mat"), ("and?", "nothing more")]
    feats = rng.normal(size=(N_IMG, VH)).astype(np.float32) if image \
        else None
    for system in ("", JF.DEFAULT_VICUNA_SYSTEM):
        for pad in (PAD, 300):
            want = JF.make_finetune_record(JTok(V), turns, feats, N_IMG, pad,
                                           system=system)
            got = TF.make_finetune_record(SimpleTokenizer(V), turns, feats,
                                          N_IMG, pad, system=system)
            assert sorted(got) == sorted(want)
            for k in want:
                if want[k] is None:
                    assert got[k] is None
                else:
                    np.testing.assert_array_equal(got[k], want[k])
                    assert np.asarray(got[k]).dtype == \
                        np.asarray(want[k]).dtype


def test_batches_follow_jax_order():
    records = _records(7)
    jb, tb = _batches(records, 2, seed=5)
    assert len(jb) == len(tb) == 3
    for j, t in zip(jb, tb):
        for name in JF.FinetuneBatch._fields:
            a, b = np.asarray(getattr(j, name)), getattr(t, name).numpy()
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype


@pytest.mark.parametrize("e_len", [40, 64])
def test_training_forward_equals_llama_forward(e_len):
    """The autograd-safe forward computes what the cached prefill computes,
    bitwise, with the finetune loss's causal and length mask."""
    _, tp = _params()
    _, tl = _cfgs()
    cfg = tl.text
    rows = 64
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(rows, H)).astype(np.float32))
    pos = torch.arange(rows, dtype=torch.int32)
    cos_t, sin_t = TL.make_rope(cfg, rows + 8, "cpu")
    bias = TF.finetune_bias(e_len, rows, "cpu")
    want, _ = TL.llama_forward(tp["target"], cfg, x, pos,
                               TL.init_kv_cache(cfg, rows, torch.float32,
                                                "cpu"), 0, bias, cos_t, sin_t)
    got = TL.llama_forward_nocache(tp["target"], cfg, x, pos, bias, cos_t,
                                   sin_t)
    assert torch.equal(got, want)
    if e_len == rows:
        assert torch.equal(bias, causal_prefill_bias(rows, rows,
                                                     device="cpu"))


def test_training_forward_backward_runs_where_the_cached_one_cannot():
    """The cached forward writes each layer's K/V in place into one
    buffer: its backward fails; the training forward's does not."""
    _, tp = _params()
    _, tl = _cfgs()
    cfg = tl.text
    x = torch.randn(16, H, generator=torch.Generator().manual_seed(0)) \
        .requires_grad_(True)
    pos = torch.arange(16, dtype=torch.int32)
    cos_t, sin_t = TL.make_rope(cfg, 24, "cpu")
    bias = causal_prefill_bias(16, 16, device="cpu")
    hid, _ = TL.llama_forward(tp["target"], cfg, x, pos,
                              TL.init_kv_cache(cfg, 16, torch.float32, "cpu"),
                              0, bias, cos_t, sin_t)
    with pytest.raises(RuntimeError):
        hid.sum().backward()
    TL.llama_forward_nocache(tp["target"], cfg, x, pos, bias, cos_t,
                             sin_t).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("images", [(True, True), (False, False),
                                    (True, False)],
                         ids=["image", "text", "mixed"])
def test_finetune_loss_and_gradients_match_jax(images):
    jp, tp = _params()
    jl, tl = _cfgs()
    (jcos, jsin), (tcos, tsin) = _ropes(jl.text, tl.text)
    records = _records(2, seed=2, images=images)
    jb, tb = _batches(records, 2, seed=0)
    (jloss, jagree), jgrad = jax.value_and_grad(
        lambda p: JF.finetune_loss(p, jl.text, N_IMG, jb[0], jcos, jsin),
        has_aux=True)(jp)
    for t in TF._leaves(tp):
        t.requires_grad_(True)
    loss, agree = TF.finetune_loss(tp, tl.text, N_IMG, tb[0], tcos, tsin)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    assert float(agree) == pytest.approx(float(jagree), rel=1e-5, abs=1e-7)
    grads = {s: {k: (v.grad if not isinstance(v, dict)
                     else {n: w.grad for n, w in v.items()})
                 for k, v in tp[s].items()} for s in tp}
    if images == (False, False):
        # no image row: the projector's gradient is zero in JAX, absent here
        assert all(g is None for g in grads["projector"].values())
        assert all(float(jnp.abs(g).max()) == 0.0
                   for g in jax.tree.leaves(jgrad["projector"]))
        grads.pop("projector")
        jgrad = {"target": jgrad["target"]}
    _close_tree(grads, jgrad)


def _group_norms(tp, tl, batch, cos_t, sin_t):
    for t in TF._leaves(tp):
        t.requires_grad_(True)
    loss, _ = TF.finetune_loss(tp, tl.text, N_IMG, batch, cos_t, sin_t)
    loss.backward()
    norms = {s: float(torch.sqrt(sum(torch.sum(t.grad ** 2)
                                     for t in TF._leaves(tp[s]))))
             for s in ("target", "projector")}
    for t in TF._leaves(tp):
        t.grad = None
    return norms


@pytest.mark.parametrize("stage", ["stage1", "stage2", "freeze_backbone",
                                   "clip_lm_only"])
def test_three_finetune_steps_match_optax(stage):
    """Three LlavaFinetuner steps against JAX's (optax multi_transform:
    per-group clip, warmup-then-cosine schedule, set_to_zero for a frozen
    LM); ``clip_lm_only`` sets the clip between the two groups' gradient
    norms, so only the LM is clipped."""
    jp, tp = _params()
    jl, tl = _cfgs()
    (jcos, jsin), (tcos, tsin) = _ropes(jl.text, tl.text)
    records = _records(6, seed=8)
    jb, tb = _batches(records, 2, seed=3)
    kw = dict(lr=1e-3, warmup_steps=1, total_steps=5)
    if stage == "stage1":
        kw["tune_mm_mlp_adapter"] = True
    elif stage == "freeze_backbone":
        kw.update(freeze_backbone=True, mm_projector_lr=3e-3)
    elif stage == "stage2":
        kw["mm_projector_lr"] = 5e-4
    else:
        norms = _group_norms(tp, tl, tb[0], tcos, tsin)
        assert norms["target"] > 4 * norms["projector"], norms
        kw["grad_clip"] = (norms["target"] * norms["projector"]) ** 0.5
    lm_before = {k: (v.clone() if not isinstance(v, dict)
                     else {n: w.clone() for n, w in v.items()})
                 for k, v in tp["target"].items()}
    jft = JF.LlavaFinetuner(jl.text, jp, N_IMG, JF.FinetuneConfig(**kw),
                            max_exp_len=MAX_EXP)
    tft = TF.LlavaFinetuner(tl.text, tp, N_IMG, TF.FinetuneConfig(**kw),
                            max_exp_len=MAX_EXP)
    frozen = stage in ("stage1", "freeze_backbone")
    assert ("lm" in tft.opt) != frozen
    assert all(t.requires_grad != frozen for t in TF._leaves(tp["target"]))
    for step in range(3):
        jm = jft.run(iter([jb[step]]), log=lambda *a: None)
        tm = tft.run(iter([tb[step]]), log=lambda *a: None)
        assert tm["loss"] == pytest.approx(jm["loss"], rel=1e-5)
        _close_tree(tp, jft.params)
    if frozen:
        for k, v in lm_before.items():
            if isinstance(v, dict):
                assert all(torch.equal(tp["target"][k][n], w)
                           for n, w in v.items())
            else:
                assert torch.equal(tp["target"][k], v)


def test_lr_schedule_follows_optax():
    import optax

    for warm, total in ((3, 10), (1, 4), (0, 5)):
        fc = TF.FinetuneConfig(lr=2e-3, warmup_steps=warm, total_steps=total)
        sched = optax.join_schedules(
            [optax.linear_schedule(0.0, fc.lr, warm),
             optax.cosine_decay_schedule(fc.lr, max(total - warm, 1))],
            [warm])
        for c in range(total + 3):
            assert TF.finetune_lr(fc, fc.lr, c) == pytest.approx(
                float(sched(c)), rel=1e-6, abs=1e-12)
