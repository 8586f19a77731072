"""Training under a (data, model) mesh (``DraftTrainer(mesh=)``,
``LlavaFinetuner(mesh=)``, ZeRO-1 in ``parallel/sharding``) against the
JAX package's, on tiny fp32 configs on the CPU.

One world of four gloo ranks (``tests/torch_parallel_train_ranks.py``,
spawned once for the module) runs every (2, 2)-mesh case on the JAX
package's weights while this process computes the JAX side on the 8-way
virtual CPU mesh of tests/conftest.py:

- each rank's AdamW moments have the shapes of its addressable shard of
  JAX's ``shard_opt_state_zero`` moments, half its TP shard's bytes;
- the gradient of the draft loss over data shards with unequal mask
  counts, summed over ``data`` and gathered over ``model``, equals
  ``jax.grad`` of JAX's loss over the whole batch; with megatron's *f*
  made the identity it does not;
- three ``DraftTrainer(mesh=)`` steps (warmup, a binding clip, medusa
  heads on and off) give the metrics and parameters of JAX's sharded and
  unsharded trainers; save/restore on the mesh round-trips bitwise;
- three ``LlavaFinetuner(mesh=)`` steps of stages 1 and 2 give JAX's
  sharded finetuner's losses and parameters, with the LM's stacked
  moments split over ``data`` on the layer axis.

Without a mesh, and on a mesh of one rank, a step is bitwise the
one-device step. Tolerances are tests/test_torch_train.py's (2e-5 on
metrics, 1e-6 absolute on gradients) and tests/test_torch_finetune.py's
(1e-5 relative), except the draft parameters after steps at lr 1e-2:
2e-6 absolute (``SHARDED_PARAM_TOL``). Adam moves an element whose
gradient is a cancellation by lr times a ratio that the gradient's last
bits decide, and the sharded sums round in another order: JAX's own
sharded trainer lies up to 5.7e-7 off its unsharded one here, and the
port's sharded trainer measured up to 1.07e-6 off either.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from msd_tpu import configs as JC
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.parallel import sharding as JS
from msd_tpu.train import draft_train as JT
from msd_tpu.train import finetune as JF
from msd_tpu.train import trainer as JTR
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.parallel import sharding as S
from msd_tpu_torch.train import draft_train as TT
from msd_tpu_torch.train import finetune as TF
from msd_tpu_torch.train import trainer as TTR
from tests import test_torch_finetune as FTT
from tests.test_torch_parallel import spawn_ranks
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_train import TOL, _assert_trees_close, _np_tree

WORLD = 4
# tests/test_parallel.py's ZERO config
ZERO = dict(vocab_size=128, hidden_size=64, layers=1, heads=8,
            intermediate_size=128, max_pos=256)
T, H = 16, 64
TRAIN = dict(lr=1e-2, warmup_steps=1, total_steps=10, grad_clip=0.05,
             noise_std=0.0, v_norm=True, medusa_w=0.5)
TRAINER = dict(batch_size=2, max_len=T, num_epochs=3, log_every=10 ** 9)
GRAD_KW = dict(rollout_steps=1, v_norm=True, medusa_w=0.5)
FT_KW = dict(lr=1e-3, warmup_steps=1, total_steps=5)
STAGES = {"stage1": dict(FT_KW, tune_mm_mlp_adapter=True),
          "stage2": dict(FT_KW, mm_projector_lr=5e-4)}
FT_SEED = 3
SHARDED_PARAM_TOL = 2e-6


def _rows(rng, i: int) -> dict:
    """One record; its loss mask covers 3 + 2 i rows, so the data shards
    of a batch hold unequal counts."""
    m = np.zeros((T,), np.float32)
    m[2:5 + 2 * i] = 1
    img = np.zeros((T,), bool)
    if i % 3 == 1:
        img[1:4] = True
    return {"emb_next": rng.normal(size=(T, H)).astype(np.float32) * 0.5,
            "hidden": rng.normal(size=(T, H)).astype(np.float32),
            "target": rng.normal(size=(T, H)).astype(np.float32) * 2,
            "loss_mask": m, "attn_len": np.int32(T - (i % 2) * 3),
            "img_mask": img}


def _draft_case():
    """(inputs for the ranks, JAX objects)."""
    cfg = JC.LlamaConfig.tiny(**ZERO)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {}
    for medusa in (0, 3):
        dcfg = JC.DraftConfig(text=cfg, medusa_heads=medusa)
        p = JD.init_draft_params(k1, dcfg)
        p["fc_b"] = jax.random.normal(k3, (H,)) * 0.1
        if medusa:
            p["medusa"] = JD.init_medusa_params(k2, dcfg)
        params[medusa] = p
    head = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                      (H, ZERO["vocab_size"])) * 0.1)
    rng = np.random.default_rng(0)
    records = [_rows(rng, i) for i in range(6)]
    grad_batch = {k: np.stack([r[k] for r in records[:4]])
                  for k in records[0]}
    inp = {"cfg": ZERO, "params": {m: _np_tree(p) for m, p in params.items()},
           "head": head, "records": records, "grad_batch": grad_batch,
           "grad_kw": GRAD_KW, "train": TRAIN, "trainer": TRAINER}
    return inp, (cfg, params)


def _finetune_case():
    jp, _ = FTT._params()
    records = FTT._records(6, seed=8)
    inp = {"cfg": FTT.CFG, "params": _np_tree(jp), "records": records,
           "n_img": FTT.N_IMG, "max_exp": FTT.MAX_EXP, "vision_h": FTT.VH,
           "seed": FT_SEED, "stages": STAGES}
    return inp, (jp, records)


def _jax_side(dinp, draft, finetune) -> dict:
    cfg, params = draft
    out = {}
    mesh = JS.make_mesh(4, dp=2, tp=2)
    head = jnp.asarray(dinp["head"])
    head_sh = jax.device_put(head, NamedSharding(mesh, P(None, "model")))
    jtc = JT.TrainConfig(**TRAIN)
    # ZeRO-1 moments of the medusa draft
    dcfg = JC.DraftConfig(text=cfg, medusa_heads=3)
    specs = JS.draft_param_specs(dcfg, True)
    p_sh = JS.shard_params(params[3], specs, mesh)
    state = JS.shard_opt_state_zero(JT.make_optimizer(jtc).init(p_sh), specs,
                                    p_sh, mesh)
    node = [n for n in jax.tree.leaves(state, is_leaf=lambda n: hasattr(
        n, "mu")) if hasattr(n, "mu")][0]
    grid = np.asarray(mesh.devices)
    shapes = {}
    for name in ("mu", "nu"):
        flat, _ = jax.tree.flatten_with_path(getattr(node, name))
        for path, leaf in flat:
            if not hasattr(leaf, "addressable_shards"):
                continue
            key = "".join(f"/{k.key}" for k in path)
            for sh in leaf.addressable_shards:
                d, m = np.argwhere(grid == sh.device)[0]
                shapes[(name, key, int(d) * 2 + int(m))] = \
                    tuple(sh.data.shape)
    out["moments"] = shapes

    # the loss's gradient over the whole batch
    batch = JT.Batch(**{k: jnp.asarray(v) for k, v in
                        dinp["grad_batch"].items()})
    cos, sin = JL.make_rope(cfg, T + 8)

    def total(p):
        v, pl, _, _ = JT.draft_loss(p, dcfg, head, batch, cos, sin, **GRAD_KW)
        return 1.0 * v + 0.1 * pl

    out["grads"] = _np_tree(jax.grad(total)(params[3]))

    recs = dinp["records"]
    for medusa in (0, 3):
        dc = JC.DraftConfig(text=cfg, medusa_heads=medusa)
        tc = JTR.TrainerConfig(train=jtc, **TRAINER)
        runs = {}
        for side, kw in (("single", {}), ("sharded", {"mesh": mesh})):
            tr = JTR.DraftTrainer(dc, params[medusa],
                                  head_sh if kw else head, tc, **kw)
            runs[side] = []
            for e in range(3):
                m = tr.run_epoch([], recs[2 * e:2 * e + 2],
                                 log=lambda *a: None)
                runs[side].append({"metrics": m,
                                   "params": _np_tree(tr.params)})
        out[medusa] = runs

    jp, records = finetune
    jl, _ = FTT._cfgs()
    out["finetune"] = {}
    for stage, kw in STAGES.items():
        ft = JF.LlavaFinetuner(jl.text, jp, FTT.N_IMG,
                               JF.FinetuneConfig(**kw),
                               max_exp_len=FTT.MAX_EXP, mesh=mesh)
        batches = list(JF.batches_from_finetune_records(
            records, 2, np.random.default_rng(FT_SEED), FTT.N_IMG, FTT.VH))
        steps = []
        for b in batches[:3]:
            m = ft.run(iter([b]), log=lambda *a: None)
            steps.append({"metrics": m, "params": _np_tree(ft.params)})
        out["finetune"][stage] = steps
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX's results, each rank's results): the four ranks run while
    this process computes the JAX side."""
    work = tmp_path_factory.mktemp("train_world")
    dinp, dref = _draft_case()
    finp, fref = _finetune_case()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump({"draft": dinp, "finetune": finp}, f)
    procs = spawn_ranks("tests.torch_parallel_train_ranks", WORLD, work)
    try:
        jax_out = _jax_side(dinp, dref, fref)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return jax_out, ranks


def test_zero_moments_are_jax_shards_and_half_the_tp_shard(world):
    """Every rank's exp_avg and exp_avg_sq of every trained leaf have the
    shape of its device's shard of JAX's ZeRO-1 mu and nu; the frozen
    embed_tokens has none (optax's MaskedNode), nor has layer 0's skipped
    input norm, which no gradient reaches (AdamW makes moments at a
    tensor's first update; JAX's stay zero); each rank holds half its TP
    shard's moment bytes (dp = 2)."""
    jax_out, ranks = world
    want = jax_out["moments"]
    for r in ranks:
        got = r["draft"][3]["moments"]
        assert r["coords"] == {"data": r["rank"] // 2,
                               "model": r["rank"] % 2}
        keys = {k for (_, k, rank) in want if rank == r["rank"]}
        assert got["none"] == ["/layers/input_layernorm"]
        assert set(got["shapes"]) | set(got["none"]) == keys
        assert "/embed_tokens" not in keys
        for key, shape in got["shapes"].items():
            assert shape == want[("mu", key, r["rank"])] == \
                want[("nu", key, r["rank"])], key
        held, whole, repl = got["bytes"]
        assert held * 2 == whole and held > 0 and repl > whole


@pytest.mark.parametrize("fault", [False, True])
def test_sharded_gradient_matches_jax_grad(world, fault):
    """The loss's gradient over data shards with unequal mask counts
    (records of 3, 5, 7 and 9 masked rows, two per data rank), summed
    over ``data`` and gathered over ``model``, equals jax.grad of JAX's
    draft_loss over the whole batch on every rank (1e-6); with *f* the
    identity in the backward, fc and the layer's input norm get only
    their local heads' share and the gate fails."""
    jax_out, ranks = world
    for r in ranks:
        got = r["grads_f_fault" if fault else "grads"]
        if not fault:
            _assert_trees_close(got, jax_out["grads"], atol=1e-6, rtol=0)
            continue
        with pytest.raises(AssertionError):
            _assert_trees_close(got, jax_out["grads"], atol=1e-6, rtol=0)
        err = np.abs(got["fc_w"].numpy() - jax_out["grads"]["fc_w"]).max()
        assert err > 100 * 1e-6


@pytest.mark.parametrize("medusa", [0, 3])
def test_three_sharded_trainer_steps_match_jax(world, medusa):
    """DraftTrainer(mesh=(2, 2)): three steps (step 0 at lr 0, a clip that
    binds on each), one batch of two per epoch split one row per data
    rank, against JAX's DraftTrainer(mesh=make_mesh(4, dp=2, tp=2)) and
    its unsharded trainer: metrics within 2e-5, gathered parameters within
    ``SHARDED_PARAM_TOL``, and the same on every rank."""
    jax_out, ranks = world
    for r in ranks:
        steps = r["draft"][medusa]["steps"]
        assert r["draft"][medusa]["update_count"] == 3
        for side in ("single", "sharded"):
            for got, want in zip(steps, jax_out[medusa][side]):
                for name in ("loss", "vloss", "ploss", "top1_agree",
                             "medusa1_agree"):
                    np.testing.assert_allclose(
                        got["metrics"][name], want["metrics"][name],
                        err_msg=f"{side} {name}", **TOL)
                _assert_trees_close(got["params"], want["params"],
                                    atol=SHARDED_PARAM_TOL, rtol=0)
        for got, first in zip(steps, ranks[0]["draft"][medusa]["steps"]):
            assert {k: v for k, v in got["metrics"].items()
                    if k != "seconds"} == \
                {k: v for k, v in first["metrics"].items() if k != "seconds"}


def test_sharded_save_restore_round_trips_bitwise(world):
    """Each rank writes its own shard (state_rank<r>.pt, rank 0 the json);
    a fresh trainer on the same mesh restores its params and ZeRO-1
    optimizer state bitwise, and the next step continues identically."""
    _, ranks = world
    for r in ranks:
        got = r["draft"]["restore"]
        assert got["params"] and got["opt"] and got["continues"]
        assert got["epoch"] == (3, 3)
        assert got["files"] == [f"state_rank{i}.pt" for i in range(WORLD)] \
            + ["trainer.json"]


@pytest.mark.parametrize("stage", list(STAGES))
def test_three_sharded_finetune_steps_match_jax(world, stage):
    """LlavaFinetuner(mesh=(2, 2)) against JAX's sharded finetuner on the
    virtual mesh: each step's loss within 1e-5 relative, the gathered
    parameters within 1e-5 of each tensor's scale; stage 1 trains only
    the projector, stage 2 both groups, whose stacked LM moments hold one
    of the two layers per data rank."""
    jax_out, ranks = world
    for r in ranks:
        got = r["finetune"][stage]
        for mine, want in zip(got["steps"], jax_out["finetune"][stage]):
            assert mine["metrics"]["loss"] == pytest.approx(
                want["metrics"]["loss"], rel=1e-5)
            FTT._close_tree(mine["params"], want["params"])
        if stage == "stage1":
            assert got["groups"] == ["proj"]
        else:
            assert got["groups"] == ["lm", "proj"]
            layers, out, hidden = got["q_proj"]
            assert got["q_proj_moment"] == (layers // 2, out, hidden)


# ---------------------------------------------------------------------------
# one process: no mesh and the mesh of one rank
# ---------------------------------------------------------------------------

def _tiny_draft(medusa=3):
    inp, _ = _draft_case()
    dcfg = TC.DraftConfig(text=TC.LlamaConfig.tiny(**ZERO),
                          medusa_heads=medusa)
    return (dcfg, bridge.to_torch(inp["params"][medusa], "cpu"),
            torch.from_numpy(inp["head"]), inp["records"])


def test_one_rank_mesh_draft_trainer_is_bitwise_the_step_without_one():
    """A DraftTrainer on the one-rank mesh, one without a mesh and the
    step functions themselves (make_optimizer, train_step) give the same
    metrics and parameters, bitwise, over three steps."""
    dcfg, dp, head, recs = _tiny_draft()
    tc = TTR.TrainerConfig(train=TT.TrainConfig(**TRAIN), **TRAINER)
    plain = TTR.DraftTrainer(dcfg, dp, head, tc, "cpu")
    one = TTR.DraftTrainer(dcfg, dp, head, tc, "cpu", mesh=S.make_mesh(1))
    params = TTR.tree_map(lambda t: t.clone().requires_grad_(True), dp)
    params["embed_tokens"].requires_grad_(False)
    opt = TT.make_optimizer(tc.train, params)
    cos, sin = plain.cos_t, plain.sin_t
    rng = torch.Generator().manual_seed(0)
    for e in range(3):
        a = plain.run_epoch([], recs[2 * e:2 * e + 2], log=lambda *x: None)
        b = one.run_epoch([], recs[2 * e:2 * e + 2], log=lambda *x: None)
        batch = next(TTR.batches_from_records(
            TTR.prepad_records(recs[2 * e:2 * e + 2], T, "cpu"), 2,
            np.random.default_rng(e)))
        c = TT.train_step(params, opt, dcfg, tc.train, head, batch, rng,
                          cos, sin)
        assert {k: a[k] for k in c} == {k: b[k] for k in c} == \
            {k: float(v) for k, v in c.items()}
    for x, y, z in zip(TT._tensors(plain.params),
                       TT._tensors(one.gathered_params()),
                       TT._tensors(params)):
        assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.parametrize("stage", list(STAGES))
def test_one_rank_mesh_finetuner_is_bitwise_the_one_without_one(stage):
    _, tp = FTT._params()
    _, tp1 = FTT._params()
    _, tl = FTT._cfgs()
    records = FTT._records(6, seed=8)
    kw = STAGES[stage]
    plain = TF.LlavaFinetuner(tl.text, tp, FTT.N_IMG,
                              TF.FinetuneConfig(**kw), FTT.MAX_EXP)
    one = TF.LlavaFinetuner(tl.text, tp1, FTT.N_IMG, TF.FinetuneConfig(**kw),
                            FTT.MAX_EXP, mesh=S.make_mesh(1))
    for b in list(TF.batches_from_finetune_records(
            records, 2, np.random.default_rng(FT_SEED), FTT.N_IMG, FTT.VH,
            device="cpu"))[:3]:
        assert plain.run(iter([b]), log=lambda *a: None) == \
            one.run(iter([b]), log=lambda *a: None)
    flat_a = bridge.flatten(plain.gathered_params())
    flat_b = bridge.flatten(one.gathered_params())
    assert flat_a.keys() == flat_b.keys()
    assert all(torch.equal(flat_a[k], flat_b[k]) for k in flat_a)


def test_trainer_refuses_a_batch_that_does_not_split_over_data():
    """batch_size % dp raises before any collective: a (2, 1) mesh over
    a batch of three."""
    dcfg, dp, head, _ = _tiny_draft(0)

    class TwoData:
        shape = {"data": 2, "model": 1}
    tc = TTR.TrainerConfig(train=TT.TrainConfig(**TRAIN), batch_size=3)
    with pytest.raises(ValueError, match="split over data"):
        TTR.DraftTrainer(dcfg, dp, head, tc, "cpu", mesh=TwoData())
