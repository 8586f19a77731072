"""The port's drafting modes (msd_tpu_torch.engine: EAGLE recursion with the
OPT-Tree frontier and its early stop, ``finalize_tree``, static choices
trees, ``medusa_choices``) and the tree-budget autotuners against the JAX
package's, on tiny fp32 configs on the CPU, inputs made from seeds with
numpy.

Finalised trees, integer and boolean fields, tokens and acceptance counts
must be EQUAL (no tolerance); per-node float features agree within 1e-5
(the two draft forwards' fp32 roundings differ by a few ulp). Greedy MSD in
every mode must commit the null-draft tokens (canonical greedy AR).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.calib import device as JCD
from msd_tpu.engine import autotune as JA
from msd_tpu.engine import spec_engine as JSE
from msd_tpu.engine import static_tree as JST
from msd_tpu.engine import tree as JT
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.calib import device as TCD
from msd_tpu_torch.engine import autotune as TA
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.engine import static_tree as TST
from msd_tpu_torch.engine import tree as TT
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from tests.test_torch_graphs import no_host_sync
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sampling import _jax_draws

H, V, N_IMG, MAX_NEW = 64, 64, 8, 40
EAGLE = dict(top_k=4, max_depth=5, num_nodes=16)
SMALL_CHOICES = ((0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (0, 0, 0),
                 (0, 0, 1), (0, 0, 0, 0))
# the medusa_choices trees of the JAX package's test: the backbone of
# widths (4, 2, 1, 1), a cross-product tree over it, and leaves only
BACKBONE = tuple((0,) * (d - 1) + (r,) for d, w in enumerate((4, 2, 1, 1), 1)
                 for r in range(w))
CROSS = BACKBONE + ((1, 0), (2, 0), (3, 0), (0, 1), (1, 1), (1, 0, 0),
                    (1, 0, 0, 0))
LEAVES = ((3, 0), (0, 1), (1, 0, 0, 0), (0, 0, 0, 0))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _host(tree_):
    return jax.tree.map(np.asarray, tree_)


# the JAX functions under jit, one compile per static configuration (their
# eager loops would trace and compile again at every call)
_J_FINALIZE = jax.jit(JT.finalize_tree, static_argnums=(0,))
_J_EXPAND = jax.jit(JSE._draft_expand, static_argnums=(0,))


def _tree_fields(ttr, jtr):
    for field in TT.Tree._fields:
        np.testing.assert_array_equal(getattr(ttr, field).numpy(),
                                      np.asarray(getattr(jtr, field)),
                                      err_msg=field)


# ---------------------------------------------------------------------------
# finalize_tree
# ---------------------------------------------------------------------------

def _frontier(D, K, rng, ties=False):
    """Weight/token/parent matrices as the OPT-Tree loop fills them: each
    row sorted descending, a child's path weight its parent's times a
    probability. ``ties``: probabilities from {1, 1/2, 1/4}, so path
    weights tie exactly, across siblings and with the parent."""
    def probs(n):
        if ties:
            return rng.choice([1.0, 0.5, 0.25], n)
        return rng.uniform(0.01, 1.0, n)

    wm = np.zeros((D, K), np.float32)
    pm = np.zeros((D, K), np.int32)
    wm[0] = np.sort(probs(K))[::-1]
    pm[0] = np.arange(K)
    for layer in range(1, D):
        par = rng.integers(0, K, K)
        w = wm[layer - 1][par] * probs(K)
        order = np.argsort(-w, kind="stable")
        wm[layer], pm[layer] = w[order], par[order]
    tm = rng.integers(0, 500, (D, K)).astype(np.int32)
    return wm, tm, pm


FINALIZE = {   # (D, K, num_nodes, use_depth, ties)
    "full_depth": (4, 3, 10, 4, False),
    "early_stop": (4, 3, 10, 2, False),
    "depth_1": (4, 3, 10, 1, False),
    "ties": (4, 4, 12, 4, True),
    "ties_stop": (5, 3, 12, 3, True),
    "padded": (3, 3, 14, 3, False),
    "padded_stop": (3, 3, 14, 2, True),
}


@pytest.mark.parametrize("case", list(FINALIZE))
def test_finalize_tree_matches_jax(case):
    """Random OPT-Tree frontiers: every Tree field equal to JAX's (the
    global top-num_draft with depth-major tie-breaking, the stable
    topological sort, the dead-pad of a budget above the frontier, the
    doubled ancestor mask and the one-hot-by-depth retrieve table), and
    the extra matrices gathered into per-node features equal."""
    D, K, N, use_depth, ties = FINALIZE[case]
    rng = np.random.default_rng(sum(FINALIZE[case][:4]))
    cfg = dict(top_k=K, max_depth=D, num_nodes=N)
    for trial in range(4):
        wm, tm, pm = _frontier(D, K, rng, ties)
        extra = {"local_conf": rng.uniform(size=(D, K)).astype(np.float32),
                 "attn": rng.uniform(size=(D, K)).astype(np.float32)}
        jtr = _J_FINALIZE(JC.TreeConfig(**cfg), jnp.int32(7),
                          jnp.asarray(wm), jnp.asarray(tm), jnp.asarray(pm),
                          jnp.int32(use_depth),
                          extra_mats={k: jnp.asarray(v)
                                      for k, v in extra.items()})
        feats = {}
        ttr = TT.finalize_tree(TC.TreeConfig(**cfg),
                               torch.tensor(7, dtype=torch.int32), _t(wm),
                               _t(tm), _t(pm), torch.tensor(use_depth),
                               {k: _t(v) for k, v in extra.items()}, feats)
        _tree_fields(ttr, jtr)
        for key in extra:
            np.testing.assert_array_equal(feats[key].numpy(),
                                          np.asarray(jtr.extras[key]))
        assert int(ttr.valid.sum()) == 1 + min(N - 1, use_depth * K)


def test_finalize_tree_padded_budget_keeps_parent_chain():
    """The JAX package's regression case: with num_nodes - 1 > max_depth
    * top_k the dead pads must not overwrite layer-0 slot 0's tree index,
    so both children of token 5 keep it as their parent."""
    cfg = TC.TreeConfig(top_k=2, max_depth=2, num_nodes=8)
    tr = TT.finalize_tree(
        cfg, torch.tensor(3, dtype=torch.int32),
        torch.tensor([[0.9, 0.05], [0.8, 0.04]]),
        torch.tensor([[5, 6], [7, 8]], dtype=torch.int32),
        torch.tensor([[0, 1], [0, 0]], dtype=torch.int32), torch.tensor(2))
    toks, par = tr.tokens.numpy(), tr.parents.numpy()
    i5 = int(np.where(toks == 5)[0][0])
    for child in (7, 8):
        ic = int(np.where(toks == child)[0][0])
        assert par[ic] == i5 and int(tr.positions[ic]) == 2
    assert (toks[5:] == -1).all() and not tr.valid[5:].any()


# ---------------------------------------------------------------------------
# the EAGLE expansion, the static expansion and the medusa_choices layout
# ---------------------------------------------------------------------------

def _cfgs(vocab=V):
    kw = dict(vocab_size=vocab, hidden_size=H, layers=2, heads=4,
              intermediate_size=128, max_pos=512)
    return (dataclasses.replace(JC.LlamaConfig.tiny(**kw),
                                residual_dtype="float32"),
            dataclasses.replace(TC.LlamaConfig.tiny(**kw),
                                residual_dtype="float32"))


def _weights(jcfg, medusa_heads=0, seed=0):
    """JAX-initialised target (lm_head x3) and drafts: "msd" and "null"
    (random), "echo" (fc passes the target hidden through plus a little of
    the token's embedding, the layer adds zero: it re-proposes what the
    target predicted, so it is accepted where the target repeats a token
    and its stop depth varies with the target's confidence. The embedding
    term makes each branch's distribution its own: with the same one at
    every node, path weights that are products of the same probabilities
    in another order would tie up to their last rounding, and 1-ulp
    softmax differences between the two implementations would order
    them)."""
    jd = JC.DraftConfig(text=jcfg, medusa_heads=medusa_heads)
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    jtp = JL.init_llama_params(k[0], jcfg)
    jtp["lm_head"] = jtp["lm_head"] * 3.0
    drafts = {}
    for name, key in (("msd", k[1]), ("null", k[2]), ("echo", k[3])):
        dp = JD.init_draft_params(key, jd)
        if medusa_heads:
            dp["medusa"] = JD.init_medusa_params(key, jd)
        dp["embed_tokens"] = jtp["embed_tokens"]
        drafts[name] = dp
    echo = drafts["echo"]
    echo["fc_w"] = jnp.concatenate(
        [0.3 * jax.random.normal(k[3], (H, H)) / H ** 0.5, jnp.eye(H)], 0)
    echo["layers"]["o_proj"] = jnp.zeros_like(echo["layers"]["o_proj"])
    echo["layers"]["down_proj"] = jnp.zeros_like(echo["layers"]["down_proj"])
    if medusa_heads:
        echo["medusa"] = {k_: jnp.zeros_like(v)
                          for k_, v in echo["medusa"].items()}
    return jtp, drafts


def _export(rng):
    table = np.sort(rng.uniform(1e-3, 1 - 1e-3, (3, 5, 2, 3, 16)), axis=-1)
    return {"table": table.astype(np.float32),
            "attn_quantiles": np.sort(rng.uniform(0, 0.05, 4)).astype(
                np.float32),
            "margin_quantiles": np.sort(rng.uniform(0, 0.3, 2)).astype(
                np.float32),
            "global_mean": np.float32(0.5)}


def _statics_pair(jcfg, tcfg, tree, medusa_heads=0, **kw):
    common = dict(n_img=N_IMG, eos_id=-1, max_new=8, **kw)
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    jst = JSE.Statics(tcfg=jcfg, dcfg=JC.DraftConfig(
        text=jcfg, medusa_heads=medusa_heads), tree=JC.TreeConfig(**tree),
        eng=JC.EngineConfig(tree=JC.TreeConfig(**tree), **eng),
        sp=JSP(greedy_round_bits=6), **common)
    tst = TSE.Statics(tcfg=tcfg, dcfg=TC.DraftConfig(
        text=tcfg, medusa_heads=medusa_heads), tree=TC.TreeConfig(**tree),
        eng=TC.EngineConfig(tree=TC.TreeConfig(**tree), **eng),
        sp=TSP(greedy_round_bits=6), **common)
    return jst, tst


def _expand_both(jst, tst, jtp, dp, seed, calib=None, hidden_scale=1.0):
    """One expansion on each side from the same draft cache (random rows
    below E), last hidden, root token and attention feature. Returns (JAX
    tree, port tree, port features or None)."""
    rng = np.random.default_rng(seed)
    s_d = tst.s_draft
    E = int(rng.integers(20, 60))
    kv = {n: (rng.normal(size=(1, s_d, 4, 16)) * 0.5).astype(np.float32)
          for n in ("k", "v")}
    hid = (rng.normal(size=(H,)) * hidden_scale).astype(np.float32)
    af = rng.uniform(0, 0.05, tst.tree.top_k).astype(np.float32)
    cos, sin = JL.make_rope(jst.tcfg, 512)
    jparams = {"target": jtp, "draft": dp}
    tparams = {"target": bridge.to_torch(_host(jtp), "cpu"),
               "draft": bridge.to_torch(_host(dp), "cpu"),
               "cos_t": _t(np.asarray(cos)), "sin_t": _t(np.asarray(sin))}
    if calib is not None:
        vc = rng.integers(0, 3, jst.tcfg.vocab_size)
        jparams["calib"] = JCD.CalibTables.from_host(calib, vc, 4.0)
        tparams["calib"] = TCD.CalibTables.from_host(calib, vc, 4.0,
                                                     device="cpu")
    jtr, _ = _J_EXPAND(jst, jparams, {n: jnp.asarray(a)
                                      for n, a in kv.items()},
                       jnp.int32(E), jnp.asarray(hid), jnp.int32(5), cos,
                       sin, jnp.asarray(af))
    feats = {} if tst.collect_calibration else None
    ttr = TSE._draft_expand(tst, tparams, _t(hid),
                            torch.tensor(5, dtype=torch.int32), _t(af),
                            feats, {n: _t(a) for n, a in kv.items()},
                            torch.tensor(E, dtype=torch.int32))
    return jtr, ttr, feats


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg = _cfgs()
    jtp, drafts = _weights(jcfg)
    return jcfg, tcfg, jtp, drafts


EXPAND = {   # (tree options, statics options)
    "plain": (EAGLE, {}),
    "no_stop": (dict(EAGLE, num_nodes=24, early_stop_threshold=-1.0), {}),
    "padded": (dict(top_k=3, max_depth=4, num_nodes=16), {}),
    "calibrated": (EAGLE, dict(use_calibration=True)),
    "collecting": (EAGLE, dict(collect_calibration=True)),
    "calibrated_collecting": (dict(EAGLE, early_stop_threshold=0.05),
                              dict(use_calibration=True,
                                   collect_calibration=True)),
}


@pytest.mark.parametrize("case", list(EXPAND))
def test_eagle_expand_matches_jax(weights, case):
    """_draft_expand with medusa_heads=0 (EAGLE recursion) on both sides,
    over random draft caches, hiddens of three scales (so the stop fires
    at different depths) and the random and echo drafts: the finalised
    trees equal, and with collection the per-node features within 1e-5.
    The port's loop runs all max_depth - 1 layers, JAX's stops; the trees
    show that the layers past the stop change nothing."""
    jcfg, tcfg, jtp, drafts = weights
    tree, opts = EXPAND[case]
    jst, tst = _statics_pair(jcfg, tcfg, tree, **opts)
    calib = _export(np.random.default_rng(3)) \
        if opts.get("use_calibration") else None
    # the calibrated cases take the random draft only: the echo draft's
    # near-identical frontier rows give margins within a few ulp of each
    # other, which the rerank's 10/90-percentile normalisation (the
    # reference's) stretches to [0, 1], so ulp-level differences between
    # the implementations would pick different biases
    names = ("msd",) if calib is not None else ("msd", "echo")
    depths = set()
    for trial in range(6):
        jtr, ttr, feats = _expand_both(
            jst, tst, jtp, drafts[names[trial % len(names)]], trial, calib,
            hidden_scale=(0.5, 2.0, 6.0)[trial % 3])
        _tree_fields(ttr, jtr)
        depths.add(int(ttr.positions[ttr.valid].max()))
        if feats is not None:
            assert set(feats) == set(jtr.extras)
            # a reranked local_conf is the calibrated probability, a
            # discontinuous function of the features (bins, percentile
            # normalisation over the batch): not held to 1e-5, as in
            # tests/test_torch_calib.py; the trees it orders are
            for key in set(feats) - ({"local_conf"} if calib else set()):
                np.testing.assert_allclose(feats[key].numpy(),
                                           np.asarray(jtr.extras[key]),
                                           atol=1e-5, err_msg=key)
    if case == "no_stop":
        assert depths == {tree["max_depth"]}
    elif case == "plain":
        assert len(depths) >= 2, depths


@pytest.mark.parametrize("choices,nodes,depth", [
    (SMALL_CHOICES, 10, 4), (SMALL_CHOICES, 16, 5),
    (TST.mc_sim_7b_63, 64, 10)])
def test_static_expand_matches_jax(weights, choices, nodes, depth):
    """_draft_expand with static_choices: the same tree as JAX's
    _draft_expand_static, padded to num_nodes, for a small tree (exact and
    padded budget) and EAGLE's mc_sim_7b_63."""
    jcfg, tcfg, jtp, drafts = weights
    tree = dict(top_k=4, max_depth=depth, num_nodes=nodes,
                static_choices=choices)
    jst = JSE.Statics(tcfg=jcfg, dcfg=JC.DraftConfig(text=jcfg),
                      tree=JC.TreeConfig(**tree),
                      eng=JC.EngineConfig(max_seq_len=256),
                      sp=JSP(), n_img=0, eos_id=-1, max_new=8)
    _, tst = _statics_pair(jcfg, tcfg, tree)
    for trial in range(3):
        jtr, ttr, _ = _expand_both(jst, tst, jtp,
                                   drafts[("msd", "echo")[trial % 2]],
                                   10 + trial, hidden_scale=2.0)
        _tree_fields(ttr, jtr)
        assert int(ttr.valid.sum()) == 1 + len(choices)


def test_static_tree_structure_matches_jax():
    """The port's copy of the numpy structure functions and of
    tree_from_tokens give JAX's arrays for mc_sim_7b_63 and a small
    tree given out of order."""
    for choices in (TST.mc_sim_7b_63, SMALL_CHOICES[::-1]):
        lists = [list(c) for c in choices]
        for got, ref in zip(TST.static_layout(choices, 11),
                            JST.static_layout(lists, 11)):
            np.testing.assert_array_equal(got, ref)
        _, _, n, lv = TST.per_depth_structure(choices)
        _, _, jn, jlv = JST.per_depth_structure(lists)
        assert (n, lv) == (jn, jlv)
        child = np.arange(3, 3 + n - 1, dtype=np.int32)
        ttr = TST.tree_from_tokens(choices, torch.tensor(2), _t(child), 11)
        jtr = JST.tree_from_tokens(lists, jnp.int32(2), jnp.asarray(child),
                                   11)
        _tree_fields(ttr, jtr)
    assert [list(c) for c in TST.mc_sim_7b_63] == JST.mc_sim_7b_63


def test_static_tree_refuses_calibration_and_an_undersized_budget():
    _, tcfg = _cfgs()
    tree = TC.TreeConfig(top_k=4, max_depth=4, num_nodes=10,
                         static_choices=SMALL_CHOICES)
    kw = dict(tcfg=tcfg, dcfg=TC.DraftConfig(text=tcfg), tree=tree,
              eng=TC.EngineConfig(tree=tree), sp=TSP(), n_img=0, eos_id=-1,
              max_new=8)
    for opt in ("use_calibration", "collect_calibration"):
        with pytest.raises(ValueError, match="static_choices"):
            TSE.Statics(**kw, **{opt: True})
    with pytest.raises(ValueError, match="does not fit"):
        TST.static_plan(SMALL_CHOICES, 5, 9, "cpu")


@pytest.mark.parametrize("choices,nodes", [
    (BACKBONE, 16), (CROSS, 24), (LEAVES, 16), (CROSS, 12), (CROSS, 40)])
def test_medusa_choices_tree_matches_jax(choices, nodes):
    """medusa_choices trees (the backbone, a cross product, leaves only
    with the prefix closure added, a budget that cuts the closure, and a
    choices path deeper than the draft's heads, cut to them): every field
    of the expanded tree equal to JAX's."""
    jcfg, tcfg = _cfgs()
    heads = 2 if nodes == 40 else 3
    jtp, drafts = _weights(jcfg, medusa_heads=heads)
    tree = dict(top_k=4, max_depth=4, num_nodes=nodes,
                medusa_choices=choices)
    jst, tst = _statics_pair(jcfg, tcfg, tree, medusa_heads=heads)
    hid = np.random.default_rng(nodes).normal(size=(H,)).astype(np.float32)
    jtr, _ = JSE._draft_expand_medusa(
        jst, {"target": jtp, "draft": drafts["msd"]}, None, jnp.asarray(hid),
        jnp.int32(9), jnp.zeros((4,)))
    ttr = TSE._draft_expand(
        tst, {"target": bridge.to_torch(_host(jtp), "cpu"),
              "draft": bridge.to_torch(_host(drafts["msd"]), "cpu")},
        _t(hid), torch.tensor(9, dtype=torch.int32))
    _tree_fields(ttr, jtr)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def _gens(tree, medusa_heads=0, seed=0):
    jcfg, tcfg = _cfgs()
    jtp, drafts = _weights(jcfg, medusa_heads, seed)
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    jgen = JGen(jtp, drafts["msd"], jcfg,
                JC.DraftConfig(text=jcfg, medusa_heads=medusa_heads),
                JC.EngineConfig(tree=JC.TreeConfig(**tree), **eng),
                n_img=N_IMG, eos_id=-1, sp=JSP(greedy_round_bits=6))
    tgen = TGen(bridge.to_torch(_host(jtp), "cpu"),
                bridge.to_torch(_host(drafts["msd"]), "cpu"), tcfg,
                TC.DraftConfig(text=tcfg, medusa_heads=medusa_heads),
                TC.EngineConfig(tree=TC.TreeConfig(**tree), **eng),
                n_img=N_IMG, eos_id=-1, sp=TSP(greedy_round_bits=6),
                device="cpu")
    tdrafts = {n: bridge.to_torch(_host(d), "cpu") for n, d in drafts.items()}
    return jgen, tgen, drafts, tdrafts


def _prompts(n=3):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(3, V - 1, size=13).astype(np.int32)
        ids[1] = JC.IMAGE_TOKEN_INDEX
        out.append(ids)
    return out, rng.normal(size=(N_IMG, H)).astype(np.float32) * 0.1


def _both(bundle, draft, ids, feats, **kw):
    jgen, tgen, drafts, tdrafts = bundle
    jgen.params = dict(jgen.params, draft=drafts[draft])
    tgen.params["draft"] = tdrafts[draft]
    jm = jgen.generate(ids, img_feats=jnp.asarray(feats),
                       max_new_tokens=MAX_NEW, split_programs=True, **kw)
    tm = tgen.generate(ids, img_feats=torch.from_numpy(feats),
                       max_new_tokens=MAX_NEW, **kw)
    return jm, tm


def _same_run(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.accept_steps, a.accept_len_sum) == \
        (b.accept_steps, b.accept_len_sum)
    np.testing.assert_array_equal(a.alpha_hist, b.alpha_hist)


class StopDepths:
    """Records the deepest valid node of every verified tree (the step's
    stop depth when the budget holds every explored node)."""

    def __init__(self, monkeypatch):
        self.depths = []
        real = TSE._verify

        def verify(st, params, s, tr, cos_t, sin_t):
            self.depths.append(int(tr.positions[tr.valid].max()))
            return real(st, params, s, tr, cos_t, sin_t)

        monkeypatch.setattr(TSE, "_verify", verify)


@pytest.fixture(scope="module")
def eagle():
    return _gens(EAGLE)


@pytest.mark.parametrize("draft,prompt", [("msd", 0), ("msd", 1),
                                          ("echo", 1), ("echo", 2)])
def test_eagle_msd_matches_jax_and_null_draft(eagle, monkeypatch, draft,
                                              prompt):
    """Greedy EAGLE MSD: tokens, accept_steps, accept_len_sum and the
    histogram equal to JAX's, the tokens equal to the null draft's; the
    echo draft is accepted and its stop depth varies from step to step."""
    prompts, feats = _prompts()
    stops = StopDepths(monkeypatch)
    jm, tm = _both(eagle, draft, prompts[prompt], feats)
    _same_run(tm, jm)
    depths = list(stops.depths)
    assert len(depths) == tm.accept_steps
    _, tn = _both(eagle, "null", prompts[prompt], feats)
    np.testing.assert_array_equal(tm.tokens, tn.tokens)
    if draft == "echo":
        assert tm.alpha_hist[2:].sum() > 0, tm.alpha_hist
        assert len(set(depths)) >= 3, depths


def test_eagle_collecting_and_calibrated_runs_match_jax(eagle):
    """A collecting EAGLE run's calib_data equal to JAX's (integer fields
    exact, float fields within 1e-5); with tables installed on both sides
    a calibrated collecting run gives JAX's tokens, counts and trees, and
    the null-draft tokens."""
    jgen, tgen, _, _ = eagle
    prompts, feats = _prompts()
    jm, tm = _both(eagle, "echo", prompts[2], feats, collect_calibration=True)
    _same_run(tm, jm)
    steps = tm.accept_steps
    for key, ref in jm.calib_data.items():
        got = tm.calib_data[key]
        assert got.shape == (steps, EAGLE["num_nodes"]), key
        if ref.dtype == np.int32:
            np.testing.assert_array_equal(got, ref, err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=key)
    valid = tm.calib_data["valid"].astype(bool)
    assert valid[:, 1:].sum() > 0 and not valid[:, 0].any()
    export = _export(np.random.default_rng(5))
    vc = np.random.default_rng(6).integers(0, 3, V)
    jgen.set_calibrator(JCD.CalibTables.from_host(export, vc, 4.0))
    tgen.set_calibrator(TCD.CalibTables.from_host(export, vc, 4.0,
                                                  device="cpu"))
    jc, tc = _both(eagle, "echo", prompts[0], feats, use_calibration=True,
                   collect_calibration=True)
    _same_run(tc, jc)
    for key in ("token", "depth", "valid", "accept"):
        np.testing.assert_array_equal(tc.calib_data[key],
                                      jc.calib_data[key], err_msg=key)
    _, tn = _both(eagle, "null", prompts[0], feats)
    np.testing.assert_array_equal(tc.tokens, tn.tokens)


def test_eagle_sampling_matches_jax_given_its_draws(eagle, monkeypatch):
    """Sampled EAGLE MSD (T=1, top-p, top-k): fed each step's uniforms and
    Gumbel noise that JAX draws from its key (the first token pinned on
    both sides), the port commits JAX's tokens with JAX's counts."""
    jgen, tgen, drafts, tdrafts = eagle
    prompts, feats = _prompts()
    kw = dict(temperature=1.0, top_p=0.9, top_k=20, greedy_round_bits=6)
    jsp, tsp = JSP(**kw), TSP(**kw)
    first = int(tgen.generate(prompts[1], torch.from_numpy(feats), 1)
                .tokens[0])
    D = EAGLE["max_depth"]
    K = TT.sampling_width(EAGLE["num_nodes"], EAGLE["top_k"])
    key = jax.random.split(jax.random.PRNGKey(4))[0]   # after the prefill
    draws = []
    for _ in range(MAX_NEW):
        key, sub = jax.random.split(key)
        us, gs = _jax_draws(sub, D, K, V)
        draws.append((_t(np.asarray(us)), _t(np.asarray(gs))))
    state = tgen.state
    monkeypatch.setattr(TSE, "_step_draws",
                        lambda st, s: draws[int(state.steps)])
    jgen.params = dict(jgen.params, draft=drafts["echo"])
    tgen.params["draft"] = tdrafts["echo"]
    jm = jgen.generate(prompts[1], img_feats=jnp.asarray(feats),
                       max_new_tokens=MAX_NEW, seed=4, sp=jsp,
                       first_token=first, split_programs=True)
    tm = tgen.generate(prompts[1], img_feats=torch.from_numpy(feats),
                       max_new_tokens=MAX_NEW, seed=4, sp=tsp,
                       first_token=first)
    _same_run(tm, jm)
    assert tm.alpha_hist[2:].sum() > 0, tm.alpha_hist


@pytest.mark.parametrize("mode", ["mc_sim_7b_63", "medusa_cross"])
def test_static_and_medusa_choices_msd_match_jax(mode):
    """Greedy MSD with the mc_sim_7b_63 static tree and a cross-product
    medusa_choices tree: JAX's tokens and counts, and the null-draft
    tokens."""
    tree = {"mc_sim_7b_63": dict(top_k=4, max_depth=10, num_nodes=64,
                                 static_choices=TST.mc_sim_7b_63),
            "medusa_cross": dict(top_k=4, max_depth=4, num_nodes=24,
                                 medusa_choices=CROSS)}[mode]
    heads = 3 if mode.startswith("medusa") else 0
    bundle = _gens(tree, medusa_heads=heads)
    prompts, feats = _prompts()
    for draft in ("msd", "echo"):
        jm, tm = _both(bundle, draft, prompts[0], feats)
        _same_run(tm, jm)
        _, tn = _both(bundle, "null", prompts[0], feats)
        np.testing.assert_array_equal(tm.tokens, tn.tokens)
    assert tm.alpha_hist[2:].sum() > 0, tm.alpha_hist


# ---------------------------------------------------------------------------
# the steps under the host-sync guard
# ---------------------------------------------------------------------------

GUARDED_TREES = {
    "eagle": (EAGLE, 0, {}),
    "eagle_calibrated_collecting": (EAGLE, 0, dict(
        use_calibration=True, collect_calibration=True)),
    "static": (dict(top_k=4, max_depth=10, num_nodes=64,
                    static_choices=TST.mc_sim_7b_63), 0, {}),
    "medusa_choices": (dict(top_k=4, max_depth=4, num_nodes=24,
                            medusa_choices=CROSS), 3, {}),
}


@pytest.mark.parametrize("kind", list(GUARDED_TREES))
def test_drafting_steps_issue_no_host_sync_or_upload(kind):
    """Three verify steps of each drafting mode under the guard of
    tests/test_torch_graphs.py, after a request that made the first-use
    uploads (the static plan, the medusa layout), as a capture's warm-up
    does."""
    tree, heads, opts = GUARDED_TREES[kind]
    _, tgen, _, tdrafts = _gens(tree, medusa_heads=heads)
    tgen.params["draft"] = tdrafts["echo"]
    if opts.get("use_calibration"):
        tgen.set_calibrator(TCD.CalibTables.from_host(
            _export(np.random.default_rng(0)),
            np.zeros(V, np.int8), 4.0, device="cpu"))
    prompts, feats = _prompts()
    feats = torch.from_numpy(feats)
    tgen.generate(prompts[0], feats, MAX_NEW, **opts)
    st = tgen._statics(MAX_NEW, **opts)
    _, padded, img_pos = tgen._prompt(prompts[0])
    s = tgen.state
    TSE.prefill(st, tgen.params, s, padded, len(prompts[0]), feats, img_pos)
    e0 = int(s.cur_len)
    with no_host_sync():
        for _ in range(3):
            TSE.decode_step(st, tgen.params, s)
    assert int(s.steps) == 3 and int(s.cur_len) == e0 + int(s.acc_sum)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

def test_autotune_total_token_picks_jax_pick(monkeypatch):
    """With the verify timings injected (the same table on both sides),
    the port's autotune_total_token returns JAX's tree; widths_tree
    builds JAX's TreeConfig."""
    rng = np.random.default_rng(0)
    cands = (40, 48, 50, 56, 60, 96, 128)
    for trial in range(5):
        secs = dict(zip(cands, rng.uniform(0.01, 0.03, len(cands))))
        monkeypatch.setattr(JA, "time_verify_forward",
                            lambda p, c, n, s, **kw: secs[n])
        monkeypatch.setattr(TA, "time_verify_forward",
                            lambda p, c, t, n, s, **kw: secs[n])
        jtree = JA.autotune_total_token(
            None, None, JC.EngineConfig(tree=JC.TreeConfig(**EAGLE)),
            candidates=cands)
        ttree = TA.autotune_total_token(
            None, None, TC.EngineConfig(tree=TC.TreeConfig(**EAGLE)),
            candidates=cands, device="cpu")
        assert ttree == TC.TreeConfig(**dict(EAGLE,
                                             num_nodes=jtree.num_nodes))
    for widths in ((4, 2, 1), (6, 3, 2, 1, 1)):
        j = JA.widths_tree(widths, JC.TreeConfig())
        t = TA.widths_tree(widths, TC.TreeConfig())
        assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_time_verify_forward_runs_the_windowed_forward():
    """The timed forward is the verify step's own (verify_forward): at a
    tiny size on the CPU it runs for every candidate budget, beyond
    max_depth * top_k included, and the generator's autotune_tree adopts
    a candidate."""
    _, tgen, _, _ = _gens(EAGLE)
    for n in (5, 16, 40):
        t = TA.time_verify_forward(tgen.params["target"], tgen.tcfg,
                                   tgen.eng.tree, n, 384, prefix_len=100,
                                   repeats=2, device="cpu")
        assert 0 < t < 10
    tgen.autotune_tree(candidates=(12, 24))
    assert tgen.eng.tree.num_nodes in (12, 24)
    assert tgen.state.calib_log["token"].shape[1] == tgen.eng.tree.num_nodes


def test_retuned_generator_equals_a_fresh_one():
    """Setting eng (what the autotuners do) reallocates the state and the
    rope tables; later requests equal a fresh generator's with the new
    tree, for an EAGLE tree and a medusa width plan."""
    bundle = _gens(EAGLE)
    _, tgen, _, tdrafts = bundle
    prompts, feats = _prompts()
    feats = torch.from_numpy(feats)
    tgen.params["draft"] = tdrafts["echo"]
    tgen.generate(prompts[0], feats, MAX_NEW)
    for tree in (dict(EAGLE, num_nodes=24), dict(top_k=6, max_depth=6,
                                                  num_nodes=20)):
        old = tgen.state
        tgen.eng = dataclasses.replace(tgen.eng,
                                       tree=TC.TreeConfig(**tree))
        assert tgen.state is not old
        assert tgen.params["cos_t"].shape[0] == 256 + tree["num_nodes"] + 64
        _, fresh, _, fdrafts = _gens(tree)
        fresh.params["draft"] = fdrafts["echo"]
        _same_run(tgen.generate(prompts[1], feats, MAX_NEW),
                  fresh.generate(prompts[1], feats, MAX_NEW))


def test_autotune_tree_alpha_picks_and_applies():
    """autotune_tree_alpha over three medusa width plans (one deeper than
    the heads, trimmed) reports each plan's alpha and ms/step, picks the
    best score, leaves the generator on it, and a request after equals a
    fresh generator's on the picked tree."""
    heads = 3
    _, tgen, _, tdrafts = _gens(dict(top_k=4, max_depth=4, num_nodes=11,
                                     medusa_widths=(4, 3, 2, 1)),
                                medusa_heads=heads)
    tgen.params["draft"] = tdrafts["echo"]
    prompts, feats = _prompts()
    feats = torch.from_numpy(feats)
    plans = [TA.widths_tree(w, tgen.eng.tree)
             for w in ((4, 2, 1, 1), (2, 2, 2, 2, 2, 2), (6,))]
    lines = []
    out = TA.autotune_tree_alpha(tgen, plans, prompts[0], feats,
                                 max_new=MAX_NEW, repeats=1, log=lines.append)
    sweep = out["sweep"]
    assert [r["widths"] for r in sweep] == [(4, 2, 1, 1), (2, 2, 2, 2),
                                            (6,)]
    assert any("trimming" in ln for ln in lines)
    best = max(sweep, key=lambda r: r["score"])
    assert out["picked_widths"] == best["widths"] == \
        tgen.eng.tree.medusa_widths
    assert all(r["alpha"] >= 1.0 and r["ms_per_step"] > 0 for r in sweep)
    _, fresh, _, fdrafts = _gens(dataclasses.asdict(tgen.eng.tree),
                                 medusa_heads=heads)
    fresh.params["draft"] = fdrafts["echo"]
    _same_run(tgen.generate(prompts[1], feats, MAX_NEW),
              fresh.generate(prompts[1], feats, MAX_NEW))


# ---------------------------------------------------------------------------
# the smoke's [eagle] phase, rehearsed
# ---------------------------------------------------------------------------

def test_smoke_eagle_phase_at_tiny_size():
    """chip_smoke.run_eagle on the CPU at a tiny width, after its main
    path: EAGLE MSD with a random draft, without the stop, and distilled
    (then calibrated), static and medusa_choices trees, each equal to its
    null-draft tokens and eager; the stop depth fires at several depths
    with the distilled draft; both autotuners re-tune and a request after
    equals a fresh generator's (the phase raises otherwise)."""
    import chip_smoke

    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=2, intermediate_size=512, max_pos=2048),
        residual_dtype="float32")
    res = chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                   device="cpu", dtype=torch.float32)
    out = chip_smoke.run_eagle(res, tree=dict(top_k=4, max_depth=5,
                                              num_nodes=24),
                               static_tree=dict(top_k=4, max_depth=10,
                                                num_nodes=64),
                               train_steps=60, autotune=(12, 24))
    assert out["no_stop_depths"] == {5}
    assert len(out["distilled_depths"]) >= 3
    assert out["alpha"]["distilled"] > out["alpha"]["random"]
