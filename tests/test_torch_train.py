"""The port's draft distillation (msd_tpu_torch.train and
models/draft.draft_forward_nocache) against the JAX package's, on tiny
fp32 configs on the CPU, and a tiny distill of the port end to end.

The same JAX-initialised draft (medusa block included) goes to both sides
through the bridge; inputs come from ``np.random.default_rng`` seeds.
Tolerances: 2e-5 (absolute and relative) on forwards and losses, 1e-6
absolute on gradients of unit-scale losses (fp32 sums in another order;
measured at most 9.7e-8), 1e-6 absolute on parameters after optimizer
steps at lr 1e-2 (Adam normalises each element, so a small gradient whose
rounding differs moves its parameter by lr times a different ratio;
measured at most 4.3e-7); records from numpy copies and integer fields
must be bitwise equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from msd_tpu import configs as JC
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.train import data_gen as JG
from msd_tpu.train import draft_train as JT
from msd_tpu.train import trainer as JTR
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import draft as TD
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from msd_tpu_torch.train import data_gen as TG
from msd_tpu_torch.train import draft_train as TT
from msd_tpu_torch.train import trainer as TTR
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(atol=2e-5, rtol=2e-5)
H, V, T, B = 32, 96, 24, 2


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, copy=True), tree)


def _draft(medusa_heads=3):
    """(JAX cfg, port cfg, JAX params, port params, head_w [H, V])."""
    kw = dict(vocab_size=V, hidden_size=H, layers=1, heads=4,
              intermediate_size=64, max_pos=256)
    jd = JC.DraftConfig(text=JC.LlamaConfig.tiny(**kw),
                        medusa_heads=medusa_heads)
    td = TC.DraftConfig(text=TC.LlamaConfig.tiny(**kw),
                        medusa_heads=medusa_heads)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    jp = JD.init_draft_params(k1, jd)
    jp["fc_b"] = jax.random.normal(k3, (H,)) * 0.1
    if medusa_heads:
        jp["medusa"] = JD.init_medusa_params(k2, jd)
    head = np.array(jax.random.normal(k3, (H, V)))
    return jd, td, jp, bridge.to_torch(_np_tree(jp), "cpu"), head


def _batch(seed=0, b=B):
    rng = np.random.default_rng(seed)
    out = {"emb_next": rng.normal(size=(b, T, H)).astype(np.float32),
           "hidden": rng.normal(size=(b, T, H)).astype(np.float32),
           "target": rng.normal(size=(b, T, H)).astype(np.float32) * 2,
           "loss_mask": np.zeros((b, T), np.float32),
           "attn_len": np.array([T - 2, T] * (b // 2), np.int32),
           "img_mask": np.zeros((b, T), bool)}
    out["loss_mask"][0, 3:T - 4] = 1
    out["loss_mask"][1:, 5:T - 2] = 1
    out["img_mask"][0, 2:7] = True
    return out


def _batches(b):
    return (JT.Batch(**{k: jnp.asarray(v) for k, v in b.items()}),
            TT.Batch(**{k: torch.from_numpy(v.copy()) for k, v in b.items()}))


def _ropes(cfg_j, cfg_t, n=T + 8):
    return JL.make_rope(cfg_j.text, n), TL.make_rope(cfg_t.text, n, "cpu")


def _assert_trees_close(got, want, **tol):
    flat_g, flat_w = bridge.flatten(got), bridge.flatten(_np_tree(want))
    assert flat_g.keys() == flat_w.keys()
    for key, w in flat_w.items():
        g = flat_g[key]
        g = np.zeros_like(w) if g is None else g.detach().numpy()
        np.testing.assert_allclose(g, w, err_msg=key, **tol)


@pytest.mark.parametrize("image", [False, True])
def test_draft_forward_nocache_matches_jax(image):
    jd, td, jp, tp, _ = _draft()
    b = _batch()
    mask = b["img_mask"][0] if image else None
    pos = np.arange(T)
    keep = (pos[None] <= pos[:, None]) & (pos[None] < T - 3)
    bias = np.where(keep, 0.0, -1e30).astype(np.float32)
    (jc, js), (tc, ts) = _ropes(jd, td)
    jh = JD.draft_fuse(jp, jnp.asarray(b["emb_next"][0]),
                       jnp.asarray(b["hidden"][0]),
                       None if mask is None else jnp.asarray(mask))
    ref = JD.draft_forward_nocache(jp, jd, jh, jnp.asarray(pos),
                                   jnp.asarray(bias), jc, js)
    th = TD.draft_fuse(tp, torch.from_numpy(b["emb_next"][0]),
                       torch.from_numpy(b["hidden"][0]),
                       None if mask is None else torch.from_numpy(mask))
    out = TD.draft_forward_nocache(tp, td, th, torch.from_numpy(pos),
                                   torch.from_numpy(bias), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("medusa_heads", [0, 3])
@pytest.mark.parametrize("rollout_steps", [0, 2])
@pytest.mark.parametrize("v_norm", [False, True])
def test_draft_loss_matches_jax(v_norm, rollout_steps, medusa_heads):
    jd, td, jp, tp, head = _draft(medusa_heads)
    jb, tb = _batches(_batch())
    (jc, js), (tc, ts) = _ropes(jd, td)
    kw = dict(rollout_steps=rollout_steps, v_norm=v_norm, medusa_w=0.3)
    ref = JT.draft_loss(jp, jd, jnp.asarray(head), jb, jc, js, **kw)
    out = TT.draft_loss(tp, td, torch.from_numpy(head), tb, tc, ts, **kw)
    for name, o, r in zip(("vloss", "ploss", "top1", "medusa1_agree"), out,
                          ref):
        np.testing.assert_allclose(float(o), float(r), err_msg=name, **TOL)
    if not medusa_heads:
        assert float(out[3]) == 0.0


def test_draft_loss_gradient_matches_jax_grad():
    """d(v_w vloss + p_w ploss)/d(params), leaf by leaf, with v_norm,
    rollout and the medusa heads (each checkpointed) on."""
    jd, td, jp, tp, head = _draft()
    jb, tb = _batches(_batch(1))
    (jc, js), (tc, ts) = _ropes(jd, td)
    kw = dict(rollout_steps=2, v_norm=True, medusa_w=0.3)

    def total(p):
        v, pl, _, _ = JT.draft_loss(p, jd, jnp.asarray(head), jb, jc, js,
                                    **kw)
        return 1.0 * v + 0.1 * pl

    ref = jax.grad(total)(jp)
    tq = TTR.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    v, pl, _, _ = TT.draft_loss(tq, td, torch.from_numpy(head), tb, tc, ts,
                                **kw)
    (1.0 * v + 0.1 * pl).backward()
    # leaves outside the loss (embed_tokens, layer 0's skipped input norm)
    # get no gradient in torch and a zero one in JAX
    _assert_trees_close(TTR.tree_map(lambda t: t.grad, tq), ref, atol=1e-6,
                        rtol=0)


def _train_cfg(**kw):
    base = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.05,
                noise_std=0.0, v_norm=True, medusa_w=0.5)
    base.update(kw)
    return JT.TrainConfig(**base), TT.TrainConfig(**base)


def test_three_train_steps_match_optax():
    """Warmup over steps 0-1 (step 0 has lr 0 and moves only the moments),
    a clip that binds, AdamW at the schedule's rates; embed_tokens stays
    bitwise frozen and outside the optimizer."""
    jd, td, jp, tp, head = _draft()
    jtc, ttc = _train_cfg()
    (jc, js), (tc, ts) = _ropes(jd, td)
    opt = JT.make_optimizer(jtc)
    jstate = opt.init(jp)
    jparams, key = jp, jax.random.PRNGKey(0)
    tparams = TTR.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tparams["embed_tokens"].requires_grad_(False)
    topt = TT.make_optimizer(ttc, tparams)
    assert all(p is not tparams["embed_tokens"]
               for p in topt.param_groups[0]["params"])
    rng = torch.Generator().manual_seed(0)
    embed0 = tparams["embed_tokens"].clone()
    for step in range(3):
        jb, tb = _batches(_batch(step))
        jparams, jstate, key, jm = JT.train_step(
            jparams, jstate, jd, jtc, jnp.asarray(head), jb, key, jc, js,
            opt)
        tm = TT.train_step(tparams, topt, td, ttc, torch.from_numpy(head),
                           tb, rng, tc, ts)
        # the clip bound: the gradients the update used have norm grad_clip
        g_norm = torch.sqrt(sum(torch.sum(p.grad ** 2)
                                for p in topt.param_groups[0]["params"]
                                if p.grad is not None))
        np.testing.assert_allclose(float(g_norm), ttc.grad_clip, rtol=1e-5)
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       err_msg=f"{name} step {step}", **TOL)
        _assert_trees_close(tparams, jparams, atol=1e-6, rtol=0)
        if step == 0:
            _assert_trees_close(tparams, jp, atol=0, rtol=0)
    assert TT.update_count(topt) == 3
    assert torch.equal(tparams["embed_tokens"], embed0)
    np.testing.assert_array_equal(np.asarray(jparams["embed_tokens"]),
                                  embed0.numpy())


def test_clip_and_schedule_follow_optax():
    rng = np.random.default_rng(4)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    for c in (0.1, 100.0):
        ref = optax.clip_by_global_norm(c).update(
            [jnp.asarray(g) for g in grads], None)[0]
        got = [torch.from_numpy(g.copy()) for g in grads]
        TT.clip_by_global_norm(got, c)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-7,
                                       rtol=1e-6)
    jtc, ttc = _train_cfg(warmup_steps=3, total_steps=9)
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, jtc.lr, jtc.warmup_steps),
         optax.linear_schedule(jtc.lr, 0.0, jtc.total_steps
                               - jtc.warmup_steps)], [jtc.warmup_steps])
    for k in range(12):
        np.testing.assert_allclose(TT.lr_schedule(ttc, k), float(sched(k)),
                                   atol=1e-9, rtol=1e-6, err_msg=str(k))


def test_noise_terms_match_jax_for_a_given_draw():
    rng = np.random.default_rng(5)
    hidden = rng.normal(size=(2, 6, H)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ref = JT.add_uniform_noise(key, jnp.asarray(hidden), 0.2)
    u = np.array(jax.random.uniform(key, hidden.shape, jnp.float32))
    out = TT.add_uniform_noise(torch.from_numpy(hidden), 0.2,
                               torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7,
                               rtol=0)
    # the noise_rel term of the JAX train_step (draft_train.py:236-240)
    u0 = jax.random.uniform(key, hidden.shape, jnp.float32) - 0.5
    ref = jnp.asarray(hidden) * (1.0 + u0 * 0.01).astype(jnp.float32)
    out = TT.add_relative_noise(torch.from_numpy(hidden), 0.01,
                                torch.from_numpy(u))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7,
                               rtol=0)


@pytest.mark.parametrize("epochs,num_epochs", [(6, 6), (5, 5), (3, 1),
                                               (4, 0)])
def test_curriculum_visual_ratio_matches_jax(epochs, num_epochs):
    for e in range(epochs):
        assert TT.curriculum_visual_ratio(e, num_epochs) == \
            JT.curriculum_visual_ratio(e, num_epochs)


def _records(n=5, seed=6):
    out = []
    for i in range(n):
        b = _batch(seed + i, b=2)
        rec = {k: v[i % 2] for k, v in b.items()}
        rec["attn_len"] = np.int32(rec["attn_len"])
        out.append(rec)
    return out


def test_run_epoch_matches_jax_trainer():
    """Two epochs, noise off, batches of two: epoch 0 takes the three text
    records (one step, the last record dropped), epoch 1 adds both visual
    records (the curriculum's ratio 1; two steps). The batch order of
    ``default_rng(epoch)``, the metrics and the parameters match."""
    jd, td, jp, tp, head = _draft()
    jtc, ttc = _train_cfg(warmup_steps=1)
    recs = _records()
    kw = dict(batch_size=2, max_len=T, num_epochs=2, log_every=10 ** 9)
    jtr = JTR.DraftTrainer(jd, jp, jnp.asarray(head),
                           JTR.TrainerConfig(train=jtc, **kw))
    ttr = TTR.DraftTrainer(td, tp, torch.from_numpy(head),
                           TTR.TrainerConfig(train=ttc, **kw), "cpu")
    for _ in range(2):
        jm = jtr.run_epoch(recs[:2], recs[2:], log=lambda *a: None)
        tm = ttr.run_epoch(recs[:2], recs[2:], log=lambda *a: None)
        assert (tm["steps"], tm["visual_ratio"]) == \
            (jm["steps"], jm["visual_ratio"])
        for name in ("loss", "vloss", "ploss", "top1_agree",
                     "medusa1_agree"):
            np.testing.assert_allclose(tm[name], jm[name], err_msg=name,
                                       **TOL)
        _assert_trees_close(ttr.params, jtr.params, atol=1e-6, rtol=0)
    assert (ttr.epoch, ttr.step_count) == (jtr.epoch, jtr.step_count) \
        == (2, 3)
    # the trainer trained a copy: the caller's tensors are unchanged
    _assert_trees_close(tp, jp, atol=0, rtol=0)


def test_save_restore_round_trips(tmp_path):
    jd, td, jp, tp, head = _draft()
    _, ttc = _train_cfg()
    tc = TTR.TrainerConfig(train=ttc, batch_size=2, max_len=T,
                           ckpt_dir=str(tmp_path), log_every=10 ** 9)
    recs = _records(4)
    a = TTR.DraftTrainer(td, tp, torch.from_numpy(head), tc, "cpu")
    a.run_epoch([], recs)
    path = a.save("mid")
    b = TTR.DraftTrainer(td, tp, torch.from_numpy(head), tc, "cpu")
    b.restore(path)
    assert (b.epoch, b.step_count) == (a.epoch, a.step_count) == (1, 2)
    _assert_trees_close(b.params, bridge.to_numpy(a.params), atol=0, rtol=0)
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    # the next epoch continues identically from the restored state
    ma, mb = a.run_epoch([], recs), b.run_epoch([], recs)
    assert ma["loss"] == mb["loss"]
    _assert_trees_close(b.params, bridge.to_numpy(a.params), atol=0, rtol=0)


def test_record_from_traj_matches_jax_bitwise():
    rng = np.random.default_rng(7)
    emb = rng.normal(size=(V, H)).astype(np.float32)
    feats = rng.normal(size=(8, H)).astype(np.float32)
    for cur, pad_to, image in ((30, 40, True), (45, 40, True),
                               (20, 32, False)):
        traj = rng.normal(size=(cur, H)).astype(np.float32)
        ids = rng.integers(0, V, size=cur).astype(np.int32)
        args = (traj, ids, 12, 2, 8 if image else 0,
                feats if image else None, emb, pad_to)
        ref, out = JG.record_from_traj(*args), TG.record_from_traj(*args)
        assert ref.keys() == out.keys()
        for k in ref:
            assert out[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.fixture(scope="module")
def target():
    """A tiny fp32 target, both sides."""
    kw = dict(vocab_size=V, hidden_size=H, layers=2, heads=4,
              intermediate_size=64, max_pos=512)
    jcfg, tcfg = JC.LlamaConfig.tiny(**kw), TC.LlamaConfig.tiny(**kw)
    jtp = JL.init_llama_params(jax.random.PRNGKey(9), jcfg)
    return jcfg, tcfg, jtp, bridge.to_torch(_np_tree(jtp), "cpu")


def _prompt(image):
    rng = np.random.default_rng(11)
    ids = rng.integers(3, V, size=17).astype(np.int32)
    feats = rng.normal(size=(6, H)).astype(np.float32) * 0.1
    if image:
        ids[2] = JC.IMAGE_TOKEN_INDEX
    mask = np.zeros(len(ids), np.float32)
    mask[9:] = 1.0
    return ids, mask, feats if image else None


@pytest.mark.parametrize("image", [False, True])
@pytest.mark.parametrize("verify_chunk", [0, 5])
def test_make_record_from_ids_matches_jax(target, image, verify_chunk):
    """make_record_from_ids over teacher_forward (verify_chunk 0) and over
    teacher_forward_verify_shaped (5-row chunks against a 40-row cache)."""
    jcfg, tcfg, jtp, ttp = target
    ids, mask, feats = _prompt(image)
    n_img = 6 if image else 0
    kw = dict(pad_to=20, n_img=n_img, verify_chunk=verify_chunk,
              cache_len=40)
    ref = JG.make_record_from_ids(
        jtp, jcfg, ids, mask, img_feats=None if feats is None
        else jnp.asarray(feats), **kw)
    out = TG.make_record_from_ids(
        ttp, tcfg, ids, mask, img_feats=None if feats is None
        else torch.from_numpy(feats), **kw)
    assert ref.keys() == out.keys()
    for k in ref:
        if k in ("hidden", "target"):
            np.testing.assert_allclose(out[k], ref[k], err_msg=k, **TOL)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


@pytest.mark.parametrize("chunk", [0, 7])
def test_teacher_forwards_match_jax(target, chunk):
    jcfg, tcfg, jtp, ttp = target
    ids, _, feats = _prompt(True)
    args = (ids, 2, 6, 20)
    if chunk:
        ref = JG.teacher_forward_verify_shaped(
            jtp, jcfg, ids, jnp.asarray(feats), *args[1:], chunk=chunk,
            cache_len=30)
        out = TG.teacher_forward_verify_shaped(
            ttp, tcfg, ids, torch.from_numpy(feats), *args[1:], chunk=chunk,
            cache_len=30)
    else:
        ref = JG.teacher_forward(jtp, jcfg, ids, jnp.asarray(feats),
                                 *args[1:])
        out = TG.teacher_forward(ttp, tcfg, ids, torch.from_numpy(feats),
                                 *args[1:])
    np.testing.assert_array_equal(out["exp_ids"], ref["exp_ids"])
    np.testing.assert_array_equal(out["fused"], ref["fused"])
    np.testing.assert_allclose(out["hidden"], ref["hidden"], **TOL)
    assert out["hidden"].shape == (25, H)


def test_tiny_distill_raises_alpha_and_keeps_the_null_draft_tokens():
    """The port's distill path end to end (the counterpart of
    tests/test_training.py::test_training_reduces_loss_and_improves_acceptance,
    with medusa heads and engine-collected records): collect hiddens with
    the random draft (collecting changes no token), build records with
    ``record_from_traj``, train, serve the trained draft through
    ``set_draft``: the loss falls, alpha rises above the random draft's,
    and MSD still commits the null-draft tokens."""
    widths, n_img, max_new = (4, 3, 2, 2, 1, 1), 8, 48
    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=128, hidden_size=64, layers=2,
                            heads=4, intermediate_size=128),
        residual_dtype="float32")
    dcfg = TC.DraftConfig(text=cfg, medusa_heads=len(widths) - 1)
    tp = TL.init_llama_params(cfg, torch.Generator().manual_seed(0), "cpu",
                              torch.float32)
    tp["lm_head"].mul_(3.0)

    def draft(seed):
        g = torch.Generator().manual_seed(seed)
        dp = TD.init_draft_params(dcfg, g, "cpu", torch.float32)
        dp["medusa"] = TD.init_medusa_params(dcfg, g, "cpu", torch.float32)
        dp["embed_tokens"] = tp["embed_tokens"]
        return dp

    tree = TC.TreeConfig(top_k=widths[0], max_depth=len(widths),
                         num_nodes=1 + sum(widths), medusa_widths=widths)
    gen = MSDGenerator(tp, draft(2), cfg, dcfg,
                       TC.EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                                       tree=tree),
                       n_img=n_img, eos_id=-1, device="cpu",
                       sp=TSP(greedy_round_bits=6))
    rng = np.random.default_rng(0)
    prompts = []
    for _ in range(3):
        ids = rng.integers(3, cfg.vocab_size - 1, size=13).astype(np.int32)
        ids[1] = TC.IMAGE_TOKEN_INDEX
        prompts.append(ids)
    feats = torch.from_numpy(rng.normal(size=(n_img, 64)) * 0.1).float()
    null = [gen.generate(p, feats, max_new).tokens for p in prompts]

    random_draft = draft(1)
    gen.set_draft(random_draft)
    e0, pad_to = len(prompts[0]) + n_img - 1, 128
    recs, steps0, acc0 = [], 0, 0
    for ids, want in zip(prompts, null):
        plain = gen.generate(ids, feats, max_new)
        got = gen.generate(ids, feats, max_new, collect_hiddens=True)
        np.testing.assert_array_equal(plain.tokens, want)
        np.testing.assert_array_equal(got.tokens, want)
        steps0 += plain.accept_steps
        acc0 += plain.accept_len_sum
        assert got.traj_hidden.shape == (e0 + plain.accept_len_sum, 64)
        recs.append(TG.record_from_traj(
            got.traj_hidden, got.exp_ids, e0, 1, n_img, feats.numpy(),
            tp["embed_tokens"].numpy(), pad_to))

    tc = TTR.TrainerConfig(
        train=TT.TrainConfig(lr=3e-3, warmup_steps=5, total_steps=60,
                             noise_std=0.0, noise_rel=0.01, v_norm=True,
                             medusa_w=1.0),
        batch_size=3, max_len=pad_to, num_epochs=1, log_every=10 ** 9)
    trainer = TTR.DraftTrainer(dcfg, random_draft, tp["lm_head"], tc)
    losses = [trainer.run_epoch([], recs, log=lambda *a: None)["loss"]
              for _ in range(60)]
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])

    trained = {k: TTR.tree_map(lambda t: t.detach().clone(), v)
               for k, v in trainer.params.items() if k != "embed_tokens"}
    gen.set_draft(dict(trained, embed_tokens=tp["embed_tokens"]))
    steps1 = acc1 = 0
    for ids, want in zip(prompts, null):
        r = gen.generate(ids, feats, max_new)
        np.testing.assert_array_equal(r.tokens, want)
        steps1 += r.accept_steps
        acc1 += r.accept_len_sum
    assert acc1 / steps1 > acc0 / steps0 + 1.0, (acc0 / steps0,
                                                  acc1 / steps1)


def test_smoke_distill_phase_at_tiny_size():
    """chip_smoke's [distill] phase on the CPU at a tiny width, after its
    main path: two record -> train rounds with bench's settings and
    schedule; the trained draft commits the null-draft tokens, the loss
    falls and alpha rises (the phase raises otherwise)."""
    import chip_smoke

    assert chip_smoke.distill_schedule(1700, 5) == [904, 425, 212, 106, 53]
    assert chip_smoke.distill_schedule(160, 2) == [110, 50]
    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=2, intermediate_size=512, max_pos=2048),
        residual_dtype="float32")
    res = chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                   device="cpu", dtype=torch.float32)
    out = chip_smoke.run_distill(res, steps=100, rounds=2)
    assert [r["steps"] for r in out["rounds"]] == [50, 50]
    assert out["alpha"][-1] > out["alpha"][0]
    assert out["rounds"][-1]["mean_loss"] < out["rounds"][0]["mean_loss"]


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_train_step_ops_counts_the_matmuls_a_step_runs(kv_heads):
    """chip_smoke.train_step_ops (the operation count behind the train
    step's bound) equals torch's own count of the matmul FLOPs one
    train_step runs, recompute of the checkpointed heads included."""
    from torch.utils.flop_counter import FlopCounterMode

    import chip_smoke

    cfg = TC.LlamaConfig.tiny(vocab_size=128, hidden_size=64, layers=2,
                              heads=4, kv_heads=kv_heads,
                              intermediate_size=96)
    dcfg = TC.DraftConfig(text=cfg, medusa_heads=3)
    g = torch.Generator().manual_seed(0)
    dp = TD.init_draft_params(dcfg, g, "cpu", torch.float32)
    dp["medusa"] = TD.init_medusa_params(dcfg, g, "cpu", torch.float32)
    recs = [{k: v[0] for k, v in _batch(i, b=2).items()} for i in range(2)]
    for r in recs:
        r["emb_next"], r["hidden"], r["target"] = (
            np.resize(r[k], (T, 64)).astype(np.float32)
            for k in ("emb_next", "hidden", "target"))
    tc = TTR.TrainerConfig(train=TT.TrainConfig(v_norm=True, medusa_w=1.0),
                           batch_size=2, max_len=T, log_every=10 ** 9)
    trainer = TTR.DraftTrainer(dcfg, dp, torch.randn(64, 128, generator=g),
                               tc, "cpu")
    with FlopCounterMode(display=False) as counter:
        trainer.run_epoch([], recs, log=lambda *a: None)
    assert counter.get_total_flops() == \
        chip_smoke.train_step_ops(cfg, 3, T, 2)
