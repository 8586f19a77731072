"""The generator's remaining paths under tensor parallelism, against the
JAX package's, on tiny fp32 configs on the CPU.

One world of two gloo ranks (``tests/torch_parallel_paths_ranks.py``,
spawned once for the module) runs the port's sharded generator (TP=2) on
the JAX package's weights (tests/test_parallel.py's config, an image
prompt's 8 feature rows), while this process runs JAX's single-device
generator and JAX's sharded one (``make_mesh(2, dp=1, tp=2)`` on the
virtual CPU mesh of tests/conftest.py):

- ``generate_batch`` of two prompts of different lengths gives JAX's
  tokens and accept_steps per lane, single and sharded, and each lane its
  own solo TP run's;
- a ``ContinuousScheduler`` of 2 slots over 3 staggered requests gives
  JAX's tokens per request;
- a collecting run gives JAX's integer and boolean features exactly and
  its float features (the attention feature, the confidences and
  margins) within 1e-6 of JAX's sharded run; leaving the feature's
  ``x @ q_proj`` partial sums unsummed (the planted fault) moves the
  attention feature beyond that;
- a calibrated run, on tables fitted from JAX's records, gives JAX's
  tokens and accept_steps, and every rank holds rank 0's tables;
- a two-image ``generate`` and ``naive_generate`` give JAX's tokens;
- ``score`` lies within 1e-5 relative of JAX's logprob sum, with its
  ``is_greedy``;
- ``generate`` with ``canonical_attn=False`` (the ``tree_bias``
  verification; the port's tree rows through K1's twin at the local
  heads, ``attn_impl="pallas"``) gives JAX's sharded tokens and steps
  (JAX at "xla");
- inline prompts and ``cuda_graphs=True`` are refused under TP; the
  lane-variant set is the union over the ranks; and the ranks agree
  bitwise on everything.
"""

import dataclasses
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.calib import device as JCD
from msd_tpu.calib import grouped as JG
from msd_tpu.calib import token_class as JTC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.parallel import sharding as JS
from msd_tpu.serve.continuous import (ContinuousScheduler as JSched,
                                      Request as JReq)
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_parallel import BASE, ENG, TREE, host, spawn_ranks

WORLD = 2
N_IMG = 8
FEATURE_TOL = 1e-6
SCORE_TOL = 1e-5
NEW = {"batch": 12, "calib": 16, "multi": 10}
SEGMENT = 4
# (prompt, max_new) of the scheduler's requests; the third is submitted
# after the first segment
REQUESTS = (("a", 12), ("b", 6), ("c", 8))
INT_FIELDS = ("token", "depth", "base_top1", "accept", "valid")
FLOAT_FIELDS = ("draft_conf", "attn", "margin", "base_conf", "base_margin")
BASE_ALPHA = 4.0


def _inputs():
    """The JAX package's weights, the prompts and feature rows."""
    cfg = JC.LlamaConfig.tiny(**BASE)
    dcfg = JC.DraftConfig(text=cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp, dp = JL.init_llama_params(k1, cfg), JD.init_draft_params(k2, dcfg)
    rng = np.random.default_rng(22)

    def prompt(n, *spots):
        ids = rng.integers(3, cfg.vocab_size - 1, size=n).astype(np.int32)
        ids[list(spots)] = JC.IMAGE_TOKEN_INDEX
        return ids

    ids = {"a": prompt(12, 1), "b": prompt(19, 2), "c": prompt(9, 1),
           "m": prompt(14, 1, 6)}
    feats = {k: (rng.normal(size=(n, cfg.hidden_size)) * 0.1)
             .astype(np.float32)
             for k, n in (("a", N_IMG), ("b", N_IMG), ("c", N_IMG),
                          ("m0", N_IMG), ("m1", 6))}
    cont = rng.integers(3, cfg.vocab_size - 1, size=6).astype(np.int32)
    inp = {"cfg": BASE, "tp": host(tp), "dp": host(dp), "tree": TREE,
           "eng": ENG, "n_img": N_IMG, "ids": ids, "feats": feats,
           "new": NEW, "segment": SEGMENT, "requests": REQUESTS,
           "score": (np.concatenate([ids["a"], cont]), len(ids["a"])),
           "base_alpha": BASE_ALPHA}
    return inp, (cfg, dcfg, tp, dp)


def _generators(ref):
    cfg, dcfg, tp, dp = ref
    eng = JC.EngineConfig(tree=JC.TreeConfig(**TREE), **ENG)
    mesh = JS.make_mesh(WORLD, dp=1, tp=WORLD)
    tp_sh = JS.shard_params(tp, JS.llama_param_specs(cfg), mesh)
    dp_sh = JS.shard_params(dp, JS.draft_param_specs(dcfg, "fc_b" in dp),
                            mesh)
    return {side: JGen(t, d, cfg, dcfg, eng, n_img=N_IMG, eos_id=-1)
            for side, t, d in (("single", tp, dp), ("sharded", tp_sh, dp_sh))}


def _fit(cd: dict, vocab: int) -> tuple:
    """Tables fitted on a collecting run's valid nodes (the JAX
    calibrator; the port's copy fits the same tables,
    tests/test_torch_calib.py): (export, vocab classes)."""
    valid = cd["valid"].astype(bool)
    feats = {"token_category": np.asarray(["content"] * int(valid.sum())),
             "avg_visual_attention_intensity": cd["attn"][valid],
             "tree_depth": cd["depth"][valid].astype(float),
             "draft_margin": cd["margin"][valid],
             "draft_confidence": cd["draft_conf"][valid]}
    soft = JG.soft_labels_from(cd["base_conf"][valid].astype(np.float64),
                               np.maximum(cd["draft_conf"][valid], 1e-6))
    hard = cd["base_top1"][valid].astype(float)
    export = JG.GroupedIsotonicCalibrator(
        min_samples_per_group=20, max_grouping_level=2, target="soft").fit(
        feats, soft, hard).export_tables(64)
    return export, JTC.synthetic_vocab_table(vocab, 0)


def _jax_side(gens, inp, vc) -> dict:
    """JAX's results of every path but the collection (run before the
    ranks start, as the calibrated runs need its tables)."""
    ids = inp["ids"]
    feats = {k: jnp.asarray(v) for k, v in inp["feats"].items()}
    out = {}
    for side, g in gens.items():
        lanes = g.generate_batch([ids["a"], ids["b"]],
                                 [feats["a"], feats["b"]],
                                 max_new_tokens=NEW["batch"])
        out[side] = {"batch": [(np.asarray(r.tokens), r.accept_steps)
                               for r in lanes]}
    g = gens["sharded"]
    sched = JSched(g, n_slots=2, segment=SEGMENT)
    reqs = [JReq(ids=ids[k], img_feats=feats[k], max_new=n)
            for k, n in REQUESTS]
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    sched.submit(reqs[2])
    sched.run_all()
    out["sched"] = [np.asarray(r.tokens) for r in reqs]
    g.set_calibrator(JCD.CalibTables.from_host(inp["export"], vc,
                                               BASE_ALPHA))
    u = g.generate(ids["b"], feats["b"], max_new_tokens=NEW["calib"],
                   use_calibration=True)
    out["use"] = (np.asarray(u.tokens), u.accept_steps, u.accept_len_sum)
    blocks = [feats["m0"], feats["m1"]]
    out["multi"] = {
        "msd": np.asarray(g.generate(ids["m"], blocks,
                                     max_new_tokens=NEW["multi"]).tokens),
        "ar": np.asarray(g.naive_generate(ids["m"], blocks,
                                          max_new_tokens=NEW["multi"])
                         .tokens)}
    ids_s, start = inp["score"]
    out["score"] = g.score(ids_s, start, feats["a"])
    g.eng = dataclasses.replace(g.eng, canonical_attn=False)
    r = g.generate(ids["a"], feats["a"], max_new_tokens=NEW["batch"])
    out["noncanonical"] = (np.asarray(r.tokens), r.accept_steps)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX's results, each rank's results): JAX's collecting run and the
    tables fitted on it first, then the two ranks run while this process
    computes the rest of the JAX side."""
    work = tmp_path_factory.mktemp("tp_paths")
    inp, ref = _inputs()
    gens = _generators(ref)
    c = gens["sharded"].generate(inp["ids"]["a"],
                                 jnp.asarray(inp["feats"]["a"]),
                                 max_new_tokens=NEW["calib"],
                                 collect_calibration=True)
    collect = {"tokens": np.asarray(c.tokens), "steps": c.accept_steps,
               "data": c.calib_data}
    inp["export"], vc = _fit(c.calib_data, ref[0].vocab_size)
    inp["vocab_class"] = vc
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    procs = spawn_ranks("tests.torch_parallel_paths_ranks", WORLD, work)
    try:
        jax_out = _jax_side(gens, inp, vc)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    jax_out["collect"] = collect
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return jax_out, ranks


def test_batch_lanes_match_jax_and_their_solo_runs(world):
    """generate_batch of two prompts of different lengths under TP=2:
    each lane's tokens and accept_steps are JAX's single-device and JAX's
    sharded lane's, and the lane's own solo TP run's."""
    jax_out, ranks = world
    for r in ranks:
        for b, (tokens, steps) in enumerate(r["batch"]):
            for side in ("single", "sharded"):
                want = jax_out[side]["batch"][b]
                np.testing.assert_array_equal(tokens, want[0])
                assert steps == want[1], (side, b)
            np.testing.assert_array_equal(tokens, r["solo"][b][0])
            assert steps == r["solo"][b][1]


def test_continuous_scheduler_matches_jax(world):
    """A 2-slot ContinuousScheduler under TP=2 over 3 staggered requests
    (the third joins a running batch in the slot the second retires):
    JAX's sharded scheduler's tokens per request."""
    jax_out, ranks = world
    for r in ranks:
        for (tokens, error), want, (_, n) in zip(r["sched"], jax_out["sched"],
                                                  REQUESTS):
            assert error is None
            assert len(tokens) == n
            np.testing.assert_array_equal(tokens, want)


def test_collected_calibration_matches_jax_sharded(world):
    """collect_calibration under TP=2: JAX's tokens and steps, its integer
    and boolean features exactly, and the attention feature, confidences
    and margins within 1e-6 of JAX's sharded run."""
    jax_out, ranks = world
    want = jax_out["collect"]
    for r in ranks:
        got = r["collect"]
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        assert got["steps"] == want["steps"]
        assert got["data"].keys() == want["data"].keys()
        for key in INT_FIELDS:
            np.testing.assert_array_equal(got["data"][key],
                                          want["data"][key], err_msg=key)
        for key in FLOAT_FIELDS:
            np.testing.assert_allclose(got["data"][key], want["data"][key],
                                       rtol=0, atol=FEATURE_TOL,
                                       err_msg=key)
        valid = want["data"]["valid"].astype(bool)
        assert (want["data"]["attn"][valid] > 0).any()


def test_unsummed_feature_query_fails_the_bound(world):
    """The planted fault: the feature's ``x @ q_proj`` left as this
    rank's partial product moves the attention feature beyond the 1e-6
    bound that the summed one meets."""
    jax_out, ranks = world
    want = jax_out["collect"]["data"]["attn"]
    for r in ranks:
        assert np.abs(r["fault_attn"] - want).max() > FEATURE_TOL


def test_calibrated_run_matches_jax(world):
    """use_calibration under TP=2 on the tables fitted from JAX's
    collected records: JAX's tokens, accept_steps and accept_len_sum; rank
    1 offered other tables, and every rank installed rank 0's."""
    jax_out, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["use"][0], jax_out["use"][0])
        assert r["use"][1:] == jax_out["use"][1:]
    alphas = [float(r["tables"][-1]) for r in ranks]
    assert alphas == [BASE_ALPHA] * WORLD


@pytest.mark.parametrize("path", ["msd", "ar"])
def test_two_image_prompt_matches_jax(world, path):
    """A two-image prompt (blocks of 8 and 6 rows, fused through the
    gathered embedding) under TP=2: JAX's generate (msd) and
    naive_generate (ar) tokens."""
    jax_out, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["multi"][path],
                                      jax_out["multi"][path])
        assert len(r["multi"][path]) == NEW["multi"]


def test_score_matches_jax(world):
    """score under TP=2 (the image prefill over local KV heads, the
    gathered vocabulary, the log-sum-exp): JAX's logprob sum within 1e-5
    relative and its is_greedy."""
    jax_out, ranks = world
    want_lp, want_greedy = jax_out["score"]
    for r in ranks:
        lp, greedy = r["score"]
        assert abs(lp - want_lp) <= SCORE_TOL * abs(want_lp)
        assert greedy == want_greedy


def test_noncanonical_verify_matches_jax_sharded(world):
    """canonical_attn=False under TP=2, the tree rows through K1's twin
    at each rank's local heads: JAX's sharded generate's tokens and
    accept_steps."""
    jax_out, ranks = world
    for r in ranks:
        tokens, steps = r["noncanonical"]
        np.testing.assert_array_equal(tokens, jax_out["noncanonical"][0])
        assert steps == jax_out["noncanonical"][1]
        assert len(tokens) == NEW["batch"]


def test_inline_prompts_and_graphs_are_refused(world):
    """Under TP inline (Qwen) prompts are refused with the JAX package's
    reason, and cuda_graphs=True with the collectives'."""
    _, ranks = world
    for r in ranks:
        assert "shard_params cannot shard a Qwen tree" in \
            r["refused"]["inline"]
        assert "cuda_graphs=True" in r["refused"]["graphs"]


def test_lane_variant_set_is_the_union_over_ranks(world):
    """agreed_union (which llama.lane_variant's set passes) gives every
    rank the union of the ranks' sets."""
    _, ranks = world
    for r in ranks:
        assert r["union"] == frozenset({"q_proj", "down_proj"})


def test_ranks_agree_bitwise(world):
    """Every rank's tokens, steps, features, tables and score are rank
    0's, bit for bit."""
    _, ranks = world

    def flat(x):
        if isinstance(x, dict):
            return [v for k in sorted(x) for v in flat(x[k])]
        if isinstance(x, (list, tuple)):
            return [v for e in x for v in flat(e)]
        if isinstance(x, torch.Tensor):
            return [x.numpy().tobytes()]
        if isinstance(x, np.ndarray):
            return [x.tobytes()]
        return [x]

    first = flat({k: v for k, v in ranks[0].items() if k != "rank"})
    for r in ranks[1:]:
        assert flat({k: v for k, v in r.items() if k != "rank"}) == first
