"""The port's calibration (msd_tpu_torch.calib, the calibrated rerank and
the feature collection of the engine) against the JAX package's, on the
same inputs made from seeds with numpy, at tiny fp32 sizes on the CPU.

Host calibrator copies: the same fit gives bitwise-equal tables and equal
predictions. Device lookups, attention probabilities and the feature
vector: within the stated tolerances. Rerank: ids exact. Engine: a
collecting run's features equal JAX's (integer fields exact, float fields
within 1e-5), and calibrated runs give JAX's tokens, trees and acceptance
counts and the null-draft tokens (greedy losslessness).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.calib import device as JCD
from msd_tpu.calib import grouped as JG
from msd_tpu.calib import isotonic as JI
from msd_tpu.calib import token_class as JTC
from msd_tpu.engine import spec_engine as JSE
from msd_tpu.models import draft as JD
from msd_tpu.ops import attention as JA
from msd_tpu.ops import rope as JR
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.calib import device as TCD
from msd_tpu_torch.calib import grouped as TG
from msd_tpu_torch.calib import isotonic as TI
from msd_tpu_torch.calib import token_class as TTC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.models import draft as TD
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops import attention as TA
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from tests.test_torch_engine import MAX_NEW, WIDTHS, _bundle, _prompts
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

INT_FIELDS = ("token", "depth", "base_top1", "accept", "valid")
FLOAT_FIELDS = ("draft_conf", "attn", "margin", "base_conf", "base_margin")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _fake_features(n, rng):
    return {
        "token_category": rng.choice(["content", "func_punct", "number"], n),
        "avg_visual_attention_intensity": rng.uniform(size=n),
        "tree_depth": rng.integers(1, 7, n).astype(float),
        "draft_margin": rng.uniform(size=n),
        "draft_confidence": rng.uniform(size=n),
    }


# ---------------------------------------------------------------------------
# host copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_isotonic_copy_matches_jax(weighted):
    rng = np.random.default_rng(3)
    x = np.round(rng.uniform(size=300), 2)        # duplicates get pooled
    y = (rng.uniform(size=300) < x).astype(float)
    w = rng.uniform(0.5, 2.0, 300) if weighted else None
    ref = JI.IsotonicRegression().fit(x, y, w)
    got = TI.IsotonicRegression().fit(x, y, w)
    np.testing.assert_array_equal(got.x_thresholds_, ref.x_thresholds_)
    np.testing.assert_array_equal(got.y_thresholds_, ref.y_thresholds_)
    q = np.linspace(-0.2, 1.2, 57)
    np.testing.assert_array_equal(got.predict(q), ref.predict(q))


@pytest.mark.parametrize("target,level", [("hard", 2), ("soft", 4)])
def test_grouped_copy_exports_the_same_tables(target, level):
    rng = np.random.default_rng(1)
    n = 3000
    feats = _fake_features(n, rng)
    hard = (rng.uniform(size=n) < feats["draft_confidence"]).astype(float)
    p_base = rng.uniform(size=n)
    soft = JG.soft_labels_from(p_base, feats["draft_confidence"])
    np.testing.assert_array_equal(
        TG.soft_labels_from(p_base, feats["draft_confidence"]), soft)
    kw = dict(min_samples_per_group=50, target=target,
              max_grouping_level=level)
    ref = JG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard)
    got = TG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard)
    ex_ref, ex_got = ref.export_tables(64), got.export_tables(64)
    assert ex_got["table"].shape == (3, 5, 2, 3, 64)
    assert ex_got.keys() == ex_ref.keys()
    for key in ex_ref:
        assert np.asarray(ex_got[key]).dtype == np.float32, key
        np.testing.assert_array_equal(ex_got[key], ex_ref[key], err_msg=key)
    test = _fake_features(500, np.random.default_rng(2))
    test["draft_confidence"][:5] = [np.nan, -0.1, 1.3, 0.0, 1.0]
    np.testing.assert_array_equal(got.predict_proba(test),
                                  ref.predict_proba(test))


def test_token_classes_match_jax():
    words = ["the", "The", " cat", "42", "3.14", "7.", ",", "...", "<s>",
             "</s>", "", "  ", "dog", "x1", "always", "Neither", "12a", "-"]
    for w in words:
        assert TTC.classify_text(w) == JTC.classify_text(w), repr(w)
    assert (TTC.CONTENT, TTC.FUNC_PUNCT, TTC.NUMBER) == \
        (JTC.CONTENT, JTC.FUNC_PUNCT, JTC.NUMBER)
    np.testing.assert_array_equal(TTC.synthetic_vocab_table(300, 4),
                                  JTC.synthetic_vocab_table(300, 4))


# ---------------------------------------------------------------------------
# device lookups
# ---------------------------------------------------------------------------

def _export(rng, B=16):
    table = np.sort(rng.uniform(1e-4, 1 - 1e-4, (3, 5, 2, 3, B)),
                    axis=-1).astype(np.float32)
    return {"table": table,
            "attn_quantiles": np.sort(rng.uniform(size=4)).astype(np.float32),
            "margin_quantiles": np.sort(rng.uniform(size=2)).astype(
                np.float32),
            "global_mean": np.float32(rng.uniform())}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_lookup_matches_jax(seed):
    """predict_proba, adaptive_alpha and calibration_bias on a random batch
    with conf outside [0, 1] and NaN, attention and margin values on the
    quantiles, and every depth: atol 1e-6, rtol 1e-5."""
    rng = np.random.default_rng(seed)
    V, n = 50, 140
    vc = rng.integers(0, 3, V)
    export = _export(rng)
    jct = JCD.CalibTables.from_host(export, vc, base_alpha=2.5)
    tct = TCD.CalibTables.from_host(export, vc, base_alpha=2.5, device="cpu")
    ids = rng.integers(-3, V + 3, n).astype(np.int32)
    conf = rng.uniform(-0.2, 1.2, n).astype(np.float32)
    conf[:4] = [np.nan, np.inf, 0.0, 1.0]
    attn = rng.uniform(size=n).astype(np.float32)
    attn[:4] = export["attn_quantiles"]
    depth = rng.integers(0, 15, n).astype(np.int32)
    margin = rng.uniform(size=n).astype(np.float32)
    margin[4:6] = export["margin_quantiles"]
    args_j = [jnp.asarray(a) for a in (ids, conf, attn, depth, margin)]
    args_t = [_t(a) for a in (ids, conf, attn, depth, margin)]
    for name in ("predict_proba", "adaptive_alpha", "calibration_bias"):
        ref = np.asarray(getattr(JCD, name)(jct, *args_j))
        got = getattr(TCD, name)(tct, *args_t).numpy()
        assert got.dtype == np.float32, name
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5,
                                   err_msg=name)


def test_adaptive_alpha_with_a_constant_feature_matches_jax():
    """Percentile bounds that collapse (every margin equal) take the
    min/max fallback."""
    rng = np.random.default_rng(5)
    export = _export(rng)
    vc = np.zeros(10, np.int64)
    vc[4] = 2
    jct = JCD.CalibTables.from_host(export, vc)
    tct = TCD.CalibTables.from_host(export, vc, device="cpu")
    ids = np.arange(10, dtype=np.int32)
    arrays = (ids, np.full(10, 0.5, np.float32),
              rng.uniform(size=10).astype(np.float32),
              np.arange(10, dtype=np.int32), np.full(10, 0.25, np.float32))
    ref = np.asarray(JCD.adaptive_alpha(jct, *map(jnp.asarray, arrays)))
    got = TCD.adaptive_alpha(tct, *map(_t, arrays)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# attention probabilities and the feature vector
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_attention_probs_matches_jax(hq, hkv):
    rng = np.random.default_rng(9)
    t, s, d = 5, 24, 16
    q = rng.normal(size=(t, hq, d)).astype(np.float32)
    k = rng.normal(size=(s, hkv, d)).astype(np.float32)
    bias = np.where(rng.uniform(size=(t, s)) < 0.3, -1e30, 0.0).astype(
        np.float32)
    bias[:, 0] = 0.0
    ref = np.asarray(JA.attention_probs(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(bias)))
    got = TA.attention_probs(_t(q), _t(k), _t(bias)).numpy()
    assert got.shape == (hq, t, s)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _draft_bundle():
    cfg = JC.LlamaConfig.tiny(vocab_size=64, hidden_size=64, layers=2,
                              heads=4, intermediate_size=128, max_pos=256)
    tcfg = TC.LlamaConfig.tiny(vocab_size=64, hidden_size=64, layers=2,
                               heads=4, intermediate_size=128, max_pos=256)
    jd = JC.DraftConfig(text=cfg)
    td = TC.DraftConfig(text=tcfg)
    dp = JD.init_draft_params(jax.random.PRNGKey(4), jd)
    return jd, td, dp, bridge.to_torch(jax.tree.map(np.asarray, dp), "cpu")


@pytest.mark.parametrize("write_pos", [0, 7])
def test_draft_forward_return_attn_matches_jax(write_pos):
    """Layer 0's attention probabilities over a cache holding earlier rows,
    all rows and a subset (attn_rows), and the hidden and KV unchanged by
    the request for them."""
    jd, td, jdp, tdp = _draft_bundle()
    rng = np.random.default_rng(11)
    t, s, h = 6, 32, 64
    x = rng.normal(size=(t, h)).astype(np.float32)
    pos = np.arange(write_pos, write_pos + t, dtype=np.int32)
    kv = {n: rng.normal(size=(1, s, 4, 16)).astype(np.float32)
          for n in ("k", "v")}
    bias = np.where(np.arange(s)[None] <= pos[:, None], 0.0,
                    -1e30).astype(np.float32)
    cos_j, sin_j = JR.rope_table(64, 16)
    cos_t, sin_t = TL.make_rope(td.text, 64, "cpu")
    hj, kvj, pj = JD.draft_forward(
        jdp, jd, jnp.asarray(x), jnp.asarray(pos),
        {n: jnp.asarray(a) for n, a in kv.items()}, jnp.int32(write_pos),
        jnp.asarray(bias), cos_j, sin_j, return_attn=True)
    kv_t = {n: _t(a.copy()) for n, a in kv.items()}
    ht, _, pt = TD.draft_forward(tdp, td, _t(x), _t(pos), kv_t, write_pos,
                                 _t(bias), cos_t, sin_t, return_attn=True)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6)
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(kv_t[n].numpy(), np.asarray(kvj[n]),
                                   atol=1e-5)
    rows = torch.tensor([4, 0, 5])
    kv_t = {n: _t(a.copy()) for n, a in kv.items()}
    _, _, sub = TD.draft_forward(tdp, td, _t(x), _t(pos), kv_t, write_pos,
                                 _t(bias), cos_t, sin_t, return_attn=True,
                                 attn_rows=rows)
    np.testing.assert_allclose(sub.numpy(), np.asarray(pj)[:, [4, 0, 5]],
                               atol=1e-6)


def _statics(mode, n_img=8, top_k=4):
    kw = dict(n_img=n_img, eos_id=-1, max_new=8, attn_feature_mode=mode)
    cfg = JC.LlamaConfig.tiny()
    jst = JSE.Statics(tcfg=cfg, dcfg=JC.DraftConfig(text=cfg),
                      tree=JC.TreeConfig(top_k=top_k), eng=JC.EngineConfig(),
                      sp=JSP(), **kw)
    tcfg = TC.LlamaConfig.tiny()
    tst = TSE.Statics(tcfg=tcfg, dcfg=TC.DraftConfig(text=tcfg),
                      tree=TC.TreeConfig(top_k=top_k), eng=TC.EngineConfig(),
                      sp=TSP(), **kw)
    return jst, tst


@pytest.mark.parametrize("mode", ["reference", "last_row"])
@pytest.mark.parametrize("t_rows,valid,img_pos,n_img", [
    (15, 0, 3, 8), (15, 3, 3, 8), (15, 15, 1, 8), (2, 2, 5, 8),
    (40, 40, 30, 8), (15, 6, 0, 8), (15, 6, 4, 0)])
def test_attn_feature_vec_matches_jax(mode, t_rows, valid, img_pos, n_img):
    """Rows past the valid length, fewer rows than slots, a span that the
    cache end clamps, an image at the start, and a text-only engine."""
    rng = np.random.default_rng(t_rows * 31 + valid)
    s = 36
    probs = rng.uniform(size=(4, t_rows, s)).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    jst, tst = _statics(mode, n_img)
    ref = np.asarray(JSE._attn_feature_vec(jst, jnp.asarray(probs),
                                           jnp.int32(img_pos),
                                           jnp.int32(valid)))
    vr = torch.tensor(valid, dtype=torch.int32)
    rows = TSE._attn_rows(tst, t_rows, vr)
    got = TSE._attn_feature_vec(tst, _t(probs)[:, rows],
                                torch.tensor(img_pos, dtype=torch.int32),
                                vr, t_rows).numpy()
    assert got.shape == (4,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)


# ---------------------------------------------------------------------------
# the rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("K,af_len", [(4, 4), (4, 2), (1, 4)])
def test_rerank_matches_jax(K, af_len):
    """K=4, K wider than the attention slots (padded with zeros) and the
    width-1 plan (the margin falls back to the top-1 probability)."""
    rng = np.random.default_rng(K * 10 + af_len)
    V, R = 40, 5
    vc = rng.integers(0, 3, V)
    export = _export(rng)
    jst, tst = _statics("reference", top_k=af_len)
    jp = {"calib": JCD.CalibTables.from_host(export, vc, base_alpha=3.0)}
    tp = {"calib": TCD.CalibTables.from_host(export, vc, base_alpha=3.0,
                                             device="cpu")}
    for trial in range(5):
        logits = (rng.normal(size=(R, V)) * 2).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        cand = np.argsort(-probs, axis=1, kind="stable")[:, :K].astype(
            np.int32)
        cp = np.take_along_axis(probs, cand, 1).astype(np.float32)
        af = rng.uniform(size=af_len).astype(np.float32)
        depth = np.arange(1, R + 1, dtype=np.int32)
        ri, rs, rm = JSE._rerank(jst, jp, jnp.asarray(logits),
                                 jnp.asarray(cand), jnp.asarray(cp),
                                 jnp.asarray(af), jnp.asarray(depth))
        gi, gs, gm = TSE._rerank(tst, tp, _t(logits), _t(cand), _t(cp),
                                 _t(af), _t(depth))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri),
                                      err_msg=str(trial))
        np.testing.assert_allclose(gs.numpy(), np.asarray(rs), atol=1e-6)
        np.testing.assert_allclose(gm.numpy(), np.asarray(rm), atol=1e-6)


def test_rerank_changes_candidate_order():
    """A calibrator that kills one candidate's acceptance probability
    pushes it to the last place; the others keep their order."""
    V, K = 64, 4
    table = np.full((3, 5, 2, 3, 8), 0.5, np.float32)
    table[2] = 1e-3   # 'number' type: near-zero acceptance
    vt = np.zeros((V,), np.int8)
    bad_token = 7
    vt[bad_token] = 2
    export = {"table": table, "attn_quantiles": np.asarray([.2, .4, .6, .8]),
              "margin_quantiles": np.asarray([.33, .67]),
              "global_mean": np.float32(0.5)}
    _, tst = _statics("reference", top_k=K)
    tp = {"calib": TCD.CalibTables.from_host(export, vt, base_alpha=10.0,
                                             device="cpu")}
    cand = torch.tensor([[bad_token, 3, 5, 9]], dtype=torch.int32)
    probs = torch.tensor([[0.4, 0.3, 0.2, 0.1]])
    new_ids, _, _ = TSE._rerank(tst, tp, torch.zeros(1, V), cand, probs,
                                torch.zeros(K), torch.tensor([1]))
    assert new_ids[0].tolist() == [3, 5, 9, bad_token]


# ---------------------------------------------------------------------------
# the engine: collection and calibrated decoding against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mha():
    return _bundle()


def _run(bundle, mode, ids, feats, **kw):
    jgen, tgen, drafts, tdrafts, _ = bundle
    jgen.attn_feature_mode = tgen.attn_feature_mode = mode
    jgen.params = dict(jgen.params, draft=drafts["msd"])
    tgen.params["draft"] = tdrafts["msd"]
    jm = jgen.generate(ids, img_feats=None if feats is None
                       else jnp.asarray(feats), max_new_tokens=MAX_NEW,
                       split_programs=True, **kw)
    tm = tgen.generate(ids, img_feats=None if feats is None
                       else torch.from_numpy(feats), max_new_tokens=MAX_NEW,
                       **kw)
    return jm, tm


def _null_tokens(bundle, ids, feats):
    _, tgen, _, tdrafts, _ = bundle
    tgen.params["draft"] = tdrafts["null"]
    out = tgen.generate(ids, None if feats is None
                        else torch.from_numpy(feats), MAX_NEW).tokens
    tgen.params["draft"] = tdrafts["msd"]
    return out


def _assert_same_calib_data(got, ref, steps, floats=FLOAT_FIELDS):
    assert got.keys() == ref.keys()
    for key in INT_FIELDS:
        assert got[key].dtype == np.int32, key
        assert got[key].shape == (steps, ref[key].shape[1]), key
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    for key in FLOAT_FIELDS:
        assert got[key].dtype == np.float32, key
    for key in floats:
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5,
                                   err_msg=key)


def _fit_tables(cd, vocab, base_alpha=1.0):
    """The bench's fit on a collecting run's valid nodes, with both
    calibrator copies; their tables must be equal."""
    valid = cd["valid"].astype(bool)
    feats = {"token_category": np.asarray(["content"] * int(valid.sum())),
             "avg_visual_attention_intensity": cd["attn"][valid],
             "tree_depth": cd["depth"][valid].astype(float),
             "draft_margin": cd["margin"][valid],
             "draft_confidence": cd["draft_conf"][valid]}
    soft = JG.soft_labels_from(cd["base_conf"][valid].astype(np.float64),
                               np.maximum(cd["draft_conf"][valid], 1e-6))
    hard = cd["base_top1"][valid].astype(float)
    kw = dict(min_samples_per_group=20, max_grouping_level=2, target="soft")
    ex_j = JG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard) \
        .export_tables(64)
    ex_t = TG.GroupedIsotonicCalibrator(**kw).fit(feats, soft, hard) \
        .export_tables(64)
    for key in ex_j:
        np.testing.assert_array_equal(ex_t[key], ex_j[key], err_msg=key)
    vc = TTC.synthetic_vocab_table(vocab, 0)
    return (JCD.CalibTables.from_host(ex_j, vc, base_alpha),
            TCD.CalibTables.from_host(ex_t, vc, base_alpha, device="cpu"))


@pytest.mark.parametrize("mode", ["reference", "last_row"])
@pytest.mark.parametrize("prompt", ["image", "text"])
def test_collect_and_calibrated_runs_match_jax(mha, mode, prompt):
    """A collecting run's features equal JAX's; after fitting on them and
    set_calibrator on both sides, a calibrated (and collecting) run on
    another prompt gives JAX's tokens, trees, accept_steps and
    accept_len_sum, and the null-draft tokens.

    The calibrated run takes another prompt than the fit: quantiles fitted
    on a run's own features land exactly on its margin values (each is
    repeated over a depth's slots), where the two implementations' softmax
    roundings (within 1e-6) fall on either side of a bin edge. Its
    ``draft_conf`` is the reranked probability, a discontinuous function
    of those features (bins, percentile normalisation over the batch), so
    it is not held to 1e-5; the trees it orders are held exactly."""
    jgen, tgen, _, _, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    fit_ids, ids = prompts[1], prompts[3]
    if prompt == "text":
        fit_ids, ids, feats = fit_ids[:9].copy(), ids[:9].copy(), None
        fit_ids[1] = ids[1] = 5
    jm, tm = _run(mha, mode, fit_ids, feats, collect_calibration=True)
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    assert tm.accept_steps == jm.accept_steps
    _assert_same_calib_data(tm.calib_data, jm.calib_data, tm.accept_steps)
    cd = tm.calib_data
    valid = cd["valid"].astype(bool)
    assert valid.sum() == tm.accept_steps * sum(WIDTHS)
    assert not (cd["accept"][:, 1:] & ~valid[:, 1:]).any()
    assert (cd["draft_conf"][valid] >= 0).all() and \
        (cd["draft_conf"][valid] <= 1).all()
    assert (cd["attn"][valid] > 0).any()

    jct, tct = _fit_tables(cd, jcfg.vocab_size, base_alpha=4.0)
    jgen.set_calibrator(jct)
    tgen.set_calibrator(tct)
    jc, tc = _run(mha, mode, ids, feats, use_calibration=True,
                  collect_calibration=True)
    np.testing.assert_array_equal(tc.tokens, jc.tokens)
    assert (tc.accept_steps, tc.accept_len_sum) == \
        (jc.accept_steps, jc.accept_len_sum)
    _assert_same_calib_data(tc.calib_data, jc.calib_data, tc.accept_steps,
                            floats=FLOAT_FIELDS[1:])
    np.testing.assert_array_equal(tc.tokens, _null_tokens(mha, ids, feats))


def test_demote_calibrator_reorders_trees_and_stays_lossless(mha):
    """A table that sends one token class to ~0 with a large base_alpha
    changes the trees (the rerank is not a no-op) as JAX's does, and the
    committed tokens stay the null-draft tokens."""
    jgen, tgen, _, _, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    ids = prompts[2]
    table = np.full((3, 5, 2, 3, 8), 0.5, np.float32)
    table[2] = 1e-3
    export = {"table": table, "attn_quantiles": np.asarray([.2, .4, .6, .8]),
              "margin_quantiles": np.asarray([.33, .67]),
              "global_mean": np.float32(0.5)}
    vc = TTC.synthetic_vocab_table(jcfg.vocab_size, 1)
    jgen.set_calibrator(JCD.CalibTables.from_host(export, vc, 10.0))
    tgen.set_calibrator(TCD.CalibTables.from_host(export, vc, 10.0, "cpu"))
    _, plain = _run(mha, "reference", ids, feats, collect_calibration=True)
    jd, td = _run(mha, "reference", ids, feats, use_calibration=True,
                  collect_calibration=True)
    _assert_same_calib_data(td.calib_data, jd.calib_data, td.accept_steps)
    np.testing.assert_array_equal(td.tokens, jd.tokens)
    np.testing.assert_array_equal(td.tokens, plain.tokens)
    np.testing.assert_array_equal(td.tokens, _null_tokens(mha, ids, feats))
    n = min(td.accept_steps, plain.accept_steps)
    changed = (td.calib_data["token"][:n] !=
               plain.calib_data["token"][:n]).any(axis=1)
    assert changed.any()


def test_width1_plan_calibrated_matches_jax():
    """A width-1 medusa plan: _rerank sees one candidate column (the margin
    falls back to the top-1 probability); calibrated tokens equal JAX's
    and the null-draft tokens."""
    jgen, tgen, drafts, tdrafts, jcfg = _bundle()
    tree = dict(top_k=1, max_depth=4, num_nodes=4, medusa_widths=(1, 1, 1))
    for gen, C in ((jgen, JC), (tgen, TC)):
        gen.eng = dataclasses.replace(gen.eng, tree=C.TreeConfig(**tree))
        gen.dcfg = dataclasses.replace(gen.dcfg, medusa_heads=3)
    tgen.state = TSE.alloc_state(tgen._statics(0), torch.float32, "cpu")
    bundle = (jgen, tgen, drafts, tdrafts, jcfg)
    prompts, feats = _prompts(jcfg.vocab_size)
    jm, tm = _run(bundle, "reference", prompts[0], feats,
                  collect_calibration=True)
    _assert_same_calib_data(tm.calib_data, jm.calib_data, tm.accept_steps)
    jct, tct = _fit_tables(tm.calib_data, jcfg.vocab_size, base_alpha=4.0)
    jgen.set_calibrator(jct)
    tgen.set_calibrator(tct)
    jc, tc = _run(bundle, "reference", prompts[0], feats,
                  use_calibration=True)
    np.testing.assert_array_equal(tc.tokens, jc.tokens)
    assert (tc.accept_steps, tc.accept_len_sum) == \
        (jc.accept_steps, jc.accept_len_sum)
    np.testing.assert_array_equal(
        tc.tokens, _null_tokens(bundle, prompts[0], feats))


def test_calibration_needs_tables():
    _, tgen, _, _, jcfg = _bundle()
    prompts, feats = _prompts(jcfg.vocab_size, n=1)
    with pytest.raises(ValueError, match="set_calibrator"):
        tgen.generate(prompts[0], torch.from_numpy(feats), 8,
                      use_calibration=True)


def test_smoke_calib_and_sampling_phases_at_tiny_size():
    """chip_smoke's [calib] and [sampling] phases on the CPU at a tiny
    width, after its main path: collection, the bench's fit, calibrated
    MSD graph-free and eager (== null-draft tokens), the demote calibrator
    changing the trees, the calibrated oracle at full depth, sampled MSD
    and AR reproducible from their seed, and the walk's total variation."""
    import chip_smoke

    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=2, intermediate_size=512, max_pos=2048),
        residual_dtype="float32")
    res = chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                   device="cpu", dtype=torch.float32)
    cal = chip_smoke.run_calib(res)
    assert cal["collecting"] > 0 and cal["graph calibrated"] > 0
    samp = chip_smoke.run_sampling(res)
    assert samp["tv"] < 0.05 and samp["alpha"] >= 1.0
