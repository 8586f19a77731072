"""The engine's attention modes against the JAX package's, on the CPU at
the tiny fp32 config of tests/test_canonical_attn.py (4 layers, hidden
128, 4 heads, vocab 512, a 64-row image, an EAGLE draft, a 32-node tree of
depth 6, max_seq_len 1024): JAX's weights carried across with ``bridge``,
the prompt and image rows made with numpy from seeds.

- ``canonical_attn`` (window-canonical verification, or with False the
  original ``tree_bias`` verification over the whole cache),
  ``canonical_ar`` (the AR row through the verify's window scheme) and
  ``attn_impl`` ("xla", "pallas", "auto": where the calls that carry
  kv_len go) give JAX's greedy tokens in every combination. The JAX side
  runs ``attn_impl="xla"``: its Pallas kernel runs on a TPU or in
  interpret mode only, and "xla" has "pallas"'s semantics; the port's
  "pallas" and "auto" rows go through K1's plain twin here.
- The port's counterparts of that file's tests: greedy trajectories are
  bitwise invariant to the draft and to the tree's geometry under
  canonical attention, the ``canonical_ar`` AR equals the fast AR, and the
  legacy ``tree_bias`` path stays lossless (MSD == AR).
- The non-canonical verify's logits lie within 1e-5 of JAX's ``_verify``;
  K1's plain twin at a 48-row tree bias (the LLaVA medusa tree's) within
  1e-5 of the Pallas kernel in interpret mode; ``generate_batch`` lanes
  equal their solo runs with ``canonical_attn=False``; an inline Qwen2-VL
  prompt gives JAX's tokens with ``canonical_attn=False``.

Tolerances: tokens EQUAL (fp32 on both sides, the same functions); logits
1e-5 absolute (fp32, other summation orders), as
tests/test_torch_decode_attention.py holds the twin to the Pallas kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine import spec_engine as JSE
from msd_tpu.engine import tree as JT
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.ops import attention as JA
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.engine import tree as TT
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.models import draft as TD
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops import attention as TA
from msd_tpu_torch.ops import decode_attention as K1
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

KW = dict(vocab_size=512, hidden_size=128, layers=4, heads=4,
          intermediate_size=256, max_pos=2048)
DEEP = dict(top_k=8, max_depth=6, num_nodes=32)
ENG = dict(max_seq_len=1024, prompt_pad_multiple=64)
N_IMG = 64
NEW = 48
IMPLS = ("xla", "pallas", "auto")
# bench.py's medusa widths: the 48-node tree of the main path
LLAVA_WIDTHS = (10, 8, 6, 5, 4, 3, 2, 2, 2, 1, 1, 1, 1, 1)
LOGIT_TOL = 1e-5


def host(tree):
    return jax.tree.map(np.asarray, tree)


def tiny(impl="auto"):
    return dataclasses.replace(TC.LlamaConfig.tiny(**KW), attn_impl=impl)


@pytest.fixture(scope="module")
def bundle():
    """JAX's target and two EAGLE drafts (tests/test_canonical_attn.py's
    keys), carried across; the image prompt."""
    cfg = JC.LlamaConfig.tiny(**KW)
    dcfg = JC.DraftConfig(text=cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp = JL.init_llama_params(k1, cfg)
    drafts = {}
    for name, key in (("a", k2), ("b", jax.random.PRNGKey(99))):
        dp = JD.init_draft_params(key, dcfg)
        dp["embed_tokens"] = tp["embed_tokens"]
        drafts[name] = dp
    ids = np.random.default_rng(1).integers(3, 500, size=23).astype(np.int32)
    ids[4] = JC.IMAGE_TOKEN_INDEX
    feats = (np.random.default_rng(1).normal(size=(N_IMG, KW["hidden_size"]))
             * 0.1).astype(np.float32)
    return {"cfg": cfg, "dcfg": dcfg, "tp": tp, "drafts": drafts,
            "ttp": bridge.to_torch(host(tp), "cpu"),
            "tdrafts": {n: bridge.to_torch(host(d), "cpu")
                        for n, d in drafts.items()},
            "ids": ids, "feats": feats}


def port_gen(b, impl="auto", draft="a", tree=DEEP, n_img=N_IMG, **eng):
    tcfg = tiny(impl)
    return TGen(b["ttp"], b["tdrafts"][draft], tcfg, TC.DraftConfig(text=tcfg),
                TC.EngineConfig(tree=TC.TreeConfig(**tree),
                                **dict(ENG, **eng)),
                eos_id=-1, n_img=n_img, device="cpu")


_JAX_RUNS = {}


def jax_run(b, kind: str, **eng):
    """JAX's tokens of ``generate`` (kind "msd") or ``naive_generate``
    ("ar") under the engine flags ``eng``, once per module."""
    key = (kind,) + tuple(sorted(eng.items()))
    if key not in _JAX_RUNS:
        gen = JGen(b["tp"], b["drafts"]["a"], b["cfg"], b["dcfg"],
                   JC.EngineConfig(tree=JC.TreeConfig(**DEEP), **ENG, **eng),
                   eos_id=-1, n_img=N_IMG)
        feats = jnp.asarray(b["feats"])
        r = gen.generate(b["ids"], feats, max_new_tokens=NEW,
                         split_programs=True) if kind == "msd" else \
            gen.naive_generate(b["ids"], feats, max_new_tokens=NEW)
        _JAX_RUNS[key] = np.asarray(r.tokens)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("canonical_attn", [True, False])
def test_msd_tokens_match_jax_in_each_mode(bundle, impl, canonical_attn):
    """Greedy MSD with canonical_attn True or False under each attn_impl:
    JAX's tokens (JAX at "xla"), and the port's AR baseline's."""
    gen = port_gen(bundle, impl, canonical_attn=canonical_attn)
    feats = torch.from_numpy(bundle["feats"])
    got = gen.generate(bundle["ids"], feats, NEW)
    want = jax_run(bundle, "msd", canonical_attn=canonical_attn)
    assert len(got.tokens) == NEW
    np.testing.assert_array_equal(got.tokens, want)
    np.testing.assert_array_equal(
        got.tokens, gen.naive_generate(bundle["ids"], feats, NEW).tokens)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("canonical_ar", [False, True])
def test_ar_tokens_match_jax_in_each_mode(bundle, impl, canonical_ar):
    """The AR baseline with canonical_ar False or True under each
    attn_impl: JAX's tokens."""
    gen = port_gen(bundle, impl, canonical_ar=canonical_ar)
    got = gen.naive_generate(bundle["ids"],
                             torch.from_numpy(bundle["feats"]), NEW)
    np.testing.assert_array_equal(
        got.tokens, jax_run(bundle, "ar", canonical_ar=canonical_ar))


def test_two_random_drafts_identical_trajectory(bundle):
    """Canonical attention: the same target with two unrelated drafts
    commits bitwise the same tokens."""
    feats = torch.from_numpy(bundle["feats"])
    a = port_gen(bundle, draft="a").generate(bundle["ids"], feats, 96)
    b = port_gen(bundle, draft="b").generate(bundle["ids"], feats, 96)
    assert len(a.tokens) == len(b.tokens) == 96
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_tree_geometry_invariance(bundle):
    """Three tree budgets (other acceptance structures and verify shapes)
    commit bitwise the same tokens."""
    feats = torch.from_numpy(bundle["feats"])
    outs = [port_gen(bundle, tree=tree).generate(bundle["ids"], feats,
                                                  96).tokens
            for tree in (DEEP, dict(top_k=4, max_depth=2, num_nodes=8),
                         dict(top_k=12, max_depth=3, num_nodes=24))]
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_distilled_vs_random_draft(bundle):
    """A draft trained on the target's own trajectory (the port's
    DraftTrainer on an engine-collected record) accepts deeper paths than
    the random one and commits the same tokens: the null-draft run is
    canonical greedy AR."""
    from msd_tpu_torch.train.data_gen import record_from_traj
    from msd_tpu_torch.train.draft_train import TrainConfig
    from msd_tpu_torch.train.trainer import DraftTrainer, TrainerConfig

    ids = np.random.default_rng(7).integers(3, 500, size=16).astype(
        np.int32)
    gen = port_gen(bundle, n_img=0, max_seq_len=512)
    r = gen.generate(ids, None, 64, collect_hiddens=True)
    rec = record_from_traj(r.traj_hidden, r.exp_ids, len(ids), 512, 0, None,
                           bundle["ttp"]["embed_tokens"].numpy(), 128)
    tc = TrainerConfig(train=TrainConfig(lr=1e-2, warmup_steps=10,
                                         total_steps=200, noise_std=0.0,
                                         p_w=0.5, v_norm=True),
                       batch_size=1, max_len=128, num_epochs=1,
                       log_every=10 ** 9)
    trainer = DraftTrainer(gen.dcfg, bundle["tdrafts"]["a"],
                           bundle["ttp"]["lm_head"], tc, device="cpu")
    while trainer.step_count < 200:
        trainer.run_epoch([], [rec], log=lambda *a: None)
    trained = trainer.gathered_params()
    trained["embed_tokens"] = bundle["ttp"]["embed_tokens"]
    gen.set_draft(trained)
    r2 = gen.generate(ids, None, 64)
    assert r2.avg_accept_len > r.avg_accept_len + 0.5
    np.testing.assert_array_equal(r.tokens, r2.tokens)


def test_canonical_ar_optin_matches_fast_ar(bundle):
    """canonical_ar routes the AR row through the windowed split-softmax;
    the split is exact, so it commits the fast AR's tokens."""
    feats = torch.from_numpy(bundle["feats"])
    outs = [port_gen(bundle, canonical_ar=c).naive_generate(
        bundle["ids"], feats, NEW).tokens for c in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_legacy_tree_bias_path_is_lossless(bundle, impl):
    """canonical_attn=False verifies with tree_bias; MSD stays equal to
    AR, its verify rows through masked attention ("auto") or K1's twin
    ("pallas")."""
    gen = port_gen(bundle, impl, canonical_attn=False)
    feats = torch.from_numpy(bundle["feats"])
    ar = gen.naive_generate(bundle["ids"], feats, NEW)
    msd = gen.generate(bundle["ids"], feats, NEW)
    np.testing.assert_array_equal(ar.tokens, msd.tokens)


def _layout_tree(widths, dev="cpu"):
    """The medusa width plan's static tree (the main path's layout) with
    seeded tokens: the port's Tree and JAX's."""
    t = TC.TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=widths)
    _, _, par, mask, depth, ret, valid, _, _ = TSE._medusa_layout(
        t, len(widths) - 1, dev)
    n = t.num_nodes
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        3, 500, size=n).astype(np.int32))
    tr = TT.Tree(tokens=tokens, parents=par, mask=mask, positions=depth,
                 retrieve=ret, valid=valid)
    jtr = JT.Tree(*(jnp.asarray(x.numpy()) for x in tr),
                  node_depth=jnp.asarray(depth.numpy()),
                  node_weight=jnp.zeros((n,), jnp.float32), extras={})
    return t, tr, jtr


@pytest.mark.parametrize("impl", IMPLS)
def test_verify_logits_match_jax_verify_without_canonical_attn(bundle,
                                                               impl):
    """The non-canonical verify forward over the 48-node medusa tree at
    committed length E, on a seeded cache: its logits within 1e-5 of
    JAX's ``_verify`` with canonical_attn=False (JAX at "xla"), its rows
    through masked attention or K1's twin by attn_impl; the tree's K/V
    rows land at [E, E + N) as in JAX."""
    cfg, b = bundle["cfg"], bundle
    tree, tr, jtr = _layout_tree(LLAVA_WIDTHS)
    eng = dict(max_seq_len=300, prompt_pad_multiple=64, canonical_attn=False)
    jst = JSE.Statics(tcfg=cfg, dcfg=b["dcfg"], tree=JC.TreeConfig(
        top_k=tree.top_k, max_depth=tree.max_depth, num_nodes=tree.num_nodes,
        medusa_widths=tree.medusa_widths), eng=JC.EngineConfig(
        tree=JC.TreeConfig(**DEEP), **eng), sp=JSP(), n_img=0, eos_id=-1,
        max_new=8)
    s = jst.s_target
    E = 200
    rng = np.random.default_rng(4)
    shape = (cfg.num_hidden_layers, s, cfg.num_key_value_heads,
             cfg.head_dim)
    kv = {k: (rng.normal(size=shape) * 0.5).astype(np.float32)
          for k in ("k", "v")}
    cos, sin = JL.make_rope(cfg, s + 64)
    jout = JSE._verify(jst, {"target": b["tp"]},
                       {k: jnp.asarray(v) for k, v in kv.items()},
                       jnp.int32(E), jtr, jax.random.PRNGKey(0), cos, sin)
    jkv, jlogits = jout[1], np.asarray(jout[-1])

    tcfg = tiny(impl)
    tkv = {k: torch.from_numpy(v.copy()) for k, v in kv.items()}
    tcos, tsin = TL.make_rope(tcfg, s + 64, "cpu")
    hidden = TSE.verify_forward(b["ttp"], tcfg, tkv, torch.tensor(E,
                                dtype=torch.int32), tr, tcos, tsin,
                                canonical=False)
    logits = TL.lm_head(b["ttp"], hidden).numpy()
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(tkv[k].numpy()[:, E:E + tree.num_nodes],
                                   np.asarray(jkv[k])[:, E:E +
                                                      tree.num_nodes],
                                   rtol=0, atol=LOGIT_TOL)


def test_k1_twin_at_the_tree_bias_matches_pallas_interpret():
    """K1's plain twin at the non-canonical verify's shape (the 48-node
    medusa tree: 48 rows under its tree bias, kv_len = E + 48) within
    1e-5 of the Pallas kernel in interpret mode; the port's tree_bias is
    JAX's, bitwise, and masks keys in the middle of the live range."""
    from msd_tpu.ops.pallas.decode_attention import decode_attention

    _, tr, _ = _layout_tree(LLAVA_WIDTHS)
    n, s, e = tr.tokens.shape[0], 384, 300
    bias = TA.tree_bias(tr.mask, e, s)
    jbias = np.asarray(JA.tree_bias(jnp.asarray(tr.mask.numpy()),
                                    jnp.int32(e), s))
    np.testing.assert_array_equal(bias.numpy(), jbias)
    live = bias[:, :e + n] == 0
    assert live[:, :e].all() and not live.all()
    rng = np.random.default_rng(5)
    q = rng.normal(size=(n, 4, 128)).astype(np.float32)
    k = rng.normal(size=(s, 4, 128)).astype(np.float32)
    v = rng.normal(size=(s, 4, 128)).astype(np.float32)
    ref = decode_attention(*(jnp.asarray(a) for a in (q, k, v, jbias)),
                           jnp.int32(e + n), block_s=128, interpret=True)
    got = K1.decode_attention_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), bias, e + n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=LOGIT_TOL)


def test_tree_bias_with_lanes_is_each_lanes_bias():
    """tree_bias over lanes ([B, N, N] masks, [B] prefix lengths) gives
    each lane its own bias, as the batched verify reads it."""
    rng = np.random.default_rng(6)
    masks = torch.from_numpy(rng.uniform(size=(3, 6, 6)) < 0.5)
    prefix = torch.tensor([5, 0, 11], dtype=torch.int32)
    got = TA.tree_bias(masks, prefix, 32)
    for b in range(3):
        torch.testing.assert_close(got[b], TA.tree_bias(masks[b],
                                                        int(prefix[b]), 32))


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_batch_lanes_equal_their_solo_runs_without_canonical_attn(bundle,
                                                                  impl):
    """generate_batch of three requests (two image prompts, one text) with
    canonical_attn=False, a bias per lane (one K1 twin call per lane under
    "pallas"): each lane's tokens and steps are its solo run's."""
    gen = port_gen(bundle, impl, canonical_attn=False)
    feats = torch.from_numpy(bundle["feats"])
    other = bundle["ids"].copy()
    other[10:15] = np.arange(30, 35)
    text = np.random.default_rng(8).integers(3, 500, size=17).astype(
        np.int32)
    prompts = [(bundle["ids"], feats), (other, feats * 0.5), (text, None)]
    lanes = gen.generate_batch([p for p, _ in prompts],
                               [f for _, f in prompts], 24)
    for (ids, f), lane in zip(prompts, lanes):
        solo = gen.generate(ids, f, 24)
        np.testing.assert_array_equal(lane.tokens, solo.tokens)
        assert lane.accept_steps == solo.accept_steps


@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_inline_qwen_prompt_matches_jax_without_canonical_attn(impl):
    """An inline Qwen2-VL prompt (tiny decoder, GQA 4/2, mrope with the
    image span, pos_delta past it) with canonical_attn=False: MSD gives
    JAX's tokens and acceptance counts and equals the port's AR."""
    from tests.test_torch_qwen import GRID, _bundle, _prompt

    jgen, tgen = _bundle("medusa")
    jgen.eng = dataclasses.replace(jgen.eng, canonical_attn=False)
    tgen.tcfg = dataclasses.replace(tgen.tcfg, attn_impl=impl)
    tgen.eng = dataclasses.replace(tgen.eng, canonical_attn=False)
    ids, feats = _prompt(1)
    jm = jgen.generate(ids, img_feats=jnp.asarray(feats), max_new_tokens=16,
                       img_grid=GRID)
    tm = tgen.generate(ids, img_feats=torch.from_numpy(feats),
                       max_new_tokens=16, img_grid=GRID)
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    assert (tm.accept_steps, tm.accept_len_sum) == \
        (jm.accept_steps, jm.accept_len_sum)
    ar = tgen.naive_generate(ids, img_feats=torch.from_numpy(feats),
                             max_new_tokens=16, img_grid=GRID)
    np.testing.assert_array_equal(ar.tokens, tm.tokens)


def test_draft_without_fc_bias_matches_jax():
    """DraftConfig(fc_bias=False): the port's init builds no fc_b, as
    JAX's, and a draft forward over JAX's bias-free weights gives JAX's
    hidden within 1e-5."""
    cfg = JC.LlamaConfig.tiny(**KW)
    jd = JC.DraftConfig(text=cfg, fc_bias=False)
    jp = JD.init_draft_params(jax.random.PRNGKey(3), jd)
    tcfg = TC.LlamaConfig.tiny(**KW)
    td = TC.DraftConfig(text=tcfg, fc_bias=False)
    tp = TD.init_draft_params(td, torch.Generator().manual_seed(0), "cpu",
                              torch.float32)
    assert "fc_b" not in jp and "fc_b" not in tp
    assert "fc_b" in TD.init_draft_params(
        TC.DraftConfig(text=tcfg), torch.Generator().manual_seed(0), "cpu",
        torch.float32)
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(5, KW["hidden_size"])).astype(np.float32)
    hid = rng.normal(size=(5, KW["hidden_size"])).astype(np.float32)
    want = np.asarray(JD.draft_fuse(jp, jnp.asarray(emb), jnp.asarray(hid)))
    got = TD.draft_fuse(bridge.to_torch(host(jp), "cpu"),
                        torch.from_numpy(emb), torch.from_numpy(hid))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
