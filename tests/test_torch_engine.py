"""The port's engine (msd_tpu_torch.engine) against the JAX package's, on
tiny fp32 configs on the CPU: the slice as a whole.

The same JAX-initialised target and draft go through both generators
(bridged), on bench-style image prompts with 6-bit canonical rounding.
Tokens, acceptance statistics and the static tree must be EQUAL (no
tolerance): both sides compute the same fp32 functions and round logits to
6 mantissa bits before every argmax, so a token would differ only on a
logit within ~1e-6 of a rounding boundary, which these seeds do not hit.
Within the port, greedy MSD must equal its own null-draft run (canonical
greedy AR) and its AR baseline.
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
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.engine import tree as TT
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

WIDTHS = (4, 3, 2, 2, 1, 1)
N_IMG = 8
MAX_NEW = 64


def _echo(jd, jp_target, key):
    """Draft that re-proposes the bonus token at every depth (accepted
    wherever the target repeats a token): fc passes the target hidden
    through, the decoder layer and medusa blocks add zero."""
    h = jd.text.hidden_size
    dp = JD.init_draft_params(key, jd)
    dp["fc_w"] = jnp.concatenate([jnp.zeros((h, h)), jnp.eye(h)], 0)
    dp["layers"]["o_proj"] = jnp.zeros_like(dp["layers"]["o_proj"])
    dp["layers"]["down_proj"] = jnp.zeros_like(dp["layers"]["down_proj"])
    med = JD.init_medusa_params(key, jd)
    dp["medusa"] = {k: jnp.zeros_like(v) for k, v in med.items()}
    dp["embed_tokens"] = jp_target["embed_tokens"]
    return dp


def _bundle(kv_heads=None, vocab=64):
    kw = dict(vocab_size=vocab, hidden_size=64, layers=2, heads=4,
              kv_heads=kv_heads, intermediate_size=128, max_pos=512)
    jcfg = dataclasses.replace(JC.LlamaConfig.tiny(**kw),
                               residual_dtype="float32")
    tcfg = dataclasses.replace(TC.LlamaConfig.tiny(**kw),
                               residual_dtype="float32")
    heads = len(WIDTHS) - 1
    jd = JC.DraftConfig(text=jcfg, medusa_heads=heads)
    td = TC.DraftConfig(text=tcfg, medusa_heads=heads)
    tree = dict(top_k=WIDTHS[0], max_depth=len(WIDTHS),
                num_nodes=1 + sum(WIDTHS), medusa_widths=WIDTHS)
    je = JC.EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                         tree=JC.TreeConfig(**tree))
    te = TC.EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                         tree=TC.TreeConfig(**tree))
    k = jax.random.split(jax.random.PRNGKey(0), 6)
    jtp = JL.init_llama_params(k[0], jcfg)
    jtp["lm_head"] = jtp["lm_head"] * 3.0
    drafts = {}
    for name, (ka, kb) in (("msd", (k[1], k[2])), ("null", (k[3], k[4]))):
        dp = JD.init_draft_params(ka, jd)
        dp["medusa"] = JD.init_medusa_params(kb, jd)
        dp["embed_tokens"] = jtp["embed_tokens"]
        drafts[name] = dp
    drafts["echo"] = _echo(jd, jtp, k[5])

    def host(tree_):
        return jax.tree.map(np.asarray, tree_)

    jgen = JGen(jtp, drafts["msd"], jcfg, jd, je, n_img=N_IMG, eos_id=-1,
                sp=JSP(greedy_round_bits=6))
    tgen = TGen(bridge.to_torch(host(jtp), "cpu"),
                bridge.to_torch(host(drafts["msd"]), "cpu"), tcfg, td, te,
                n_img=N_IMG, eos_id=-1, sp=TSP(greedy_round_bits=6),
                device="cpu")
    tdrafts = {n: bridge.to_torch(host(d), "cpu") for n, d in drafts.items()}
    return jgen, tgen, drafts, tdrafts, jcfg


def _prompts(vocab, n=4):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        ids = rng.integers(3, vocab - 1, size=13).astype(np.int32)
        ids[1] = JC.IMAGE_TOKEN_INDEX
        out.append(ids)
    feats = rng.normal(size=(N_IMG, 64)).astype(np.float32) * 0.1
    return out, feats


@pytest.fixture(scope="module")
def mha():
    return _bundle()


def _run(jgen, tgen, drafts, tdrafts, draft, ids, feats):
    jgen.params = dict(jgen.params, draft=drafts[draft])
    tgen.params["draft"] = tdrafts[draft]
    jm = jgen.generate(ids, img_feats=None if feats is None
                       else jnp.asarray(feats),
                       max_new_tokens=MAX_NEW, split_programs=True)
    tm = tgen.generate(ids, img_feats=None if feats is None
                       else torch.from_numpy(feats), max_new_tokens=MAX_NEW)
    return jm, tm


def _assert_same_run(jm, tm):
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    assert (tm.accept_steps, tm.accept_len_sum) == \
        (jm.accept_steps, jm.accept_len_sum)
    np.testing.assert_array_equal(tm.alpha_hist, jm.alpha_hist)


@pytest.mark.parametrize("draft", ["msd", "echo"])
@pytest.mark.parametrize("prompt", [0, 2])
def test_msd_matches_jax_and_null_draft(mha, draft, prompt):
    jgen, tgen, drafts, tdrafts, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    ids = prompts[prompt]
    jm, tm = _run(jgen, tgen, drafts, tdrafts, draft, ids, feats)
    _assert_same_run(jm, tm)
    _, tn = _run(jgen, tgen, drafts, tdrafts, "null", ids, feats)
    np.testing.assert_array_equal(tm.tokens, tn.tokens)
    if draft == "echo":
        # deep acceptances: the commit gathers overlapping KV rows
        assert tm.alpha_hist[3:].sum() > 0, tm.alpha_hist


@pytest.mark.parametrize("draft", ["msd", "echo"])
def test_collected_hiddens_match_jax(mha, draft):
    """generate(collect_hiddens=True) on both sides: equal tokens and
    expanded ids, the trajectory's hiddens (prefill rows, then each step's
    accepted rows; the echo draft commits several rows a step) within
    2e-5; collecting changes no token, fetch_hiddens=False returns none,
    and the AR baseline from a collecting prefill gives its tokens."""
    jgen, tgen, drafts, tdrafts, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    jgen.params = dict(jgen.params, draft=drafts[draft])
    tgen.params["draft"] = tdrafts[draft]
    jm = jgen.generate(prompts[1], img_feats=jnp.asarray(feats),
                       max_new_tokens=MAX_NEW, split_programs=True,
                       collect_hiddens=True)
    tm = tgen.generate(prompts[1], img_feats=torch.from_numpy(feats),
                       max_new_tokens=MAX_NEW, collect_hiddens=True)
    _assert_same_run(jm, tm)
    np.testing.assert_array_equal(tm.exp_ids, jm.exp_ids)
    assert tm.traj_hidden.shape == jm.traj_hidden.shape == \
        (len(prompts[1]) + N_IMG - 1 + tm.accept_len_sum, 64)
    np.testing.assert_allclose(tm.traj_hidden, jm.traj_hidden, atol=2e-5,
                               rtol=2e-5)
    plain = tgen.generate(prompts[1], img_feats=torch.from_numpy(feats),
                          max_new_tokens=MAX_NEW)
    _assert_same_run(plain, tm)
    quiet = tgen.generate(prompts[1], img_feats=torch.from_numpy(feats),
                          max_new_tokens=MAX_NEW, collect_hiddens=True,
                          fetch_hiddens=False)
    _assert_same_run(quiet, tm)
    assert quiet.traj_hidden is None and quiet.exp_ids is None
    ar = [tgen.naive_generate(prompts[1], img_feats=torch.from_numpy(feats),
                              max_new_tokens=MAX_NEW, share_prefill=True,
                              collect_hiddens=collect) for collect in (0, 1)]
    np.testing.assert_array_equal(ar[1].tokens, ar[0].tokens)
    if draft == "echo":
        assert tm.alpha_hist[3:].sum() > 0, tm.alpha_hist


@pytest.mark.parametrize("share_prefill", [True, False])
def test_ar_baseline_matches_jax_and_msd(mha, share_prefill):
    jgen, tgen, drafts, tdrafts, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    ja = jgen.naive_generate(prompts[0], img_feats=jnp.asarray(feats),
                             max_new_tokens=MAX_NEW,
                             share_prefill=share_prefill)
    ta = tgen.naive_generate(prompts[0], img_feats=torch.from_numpy(feats),
                             max_new_tokens=MAX_NEW,
                             share_prefill=share_prefill)
    np.testing.assert_array_equal(ta.tokens, ja.tokens)
    tgen.params["draft"] = tdrafts["msd"]
    tm = tgen.generate(prompts[0], img_feats=torch.from_numpy(feats),
                       max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(tm.tokens, ta.tokens)
    assert tm.avg_accept_len >= 1.0


def test_first_token_and_text_only_prompt_match_jax(mha):
    jgen, tgen, drafts, tdrafts, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    assert tgen.first_token(prompts[1], torch.from_numpy(feats)) == \
        jgen.first_token(prompts[1], jnp.asarray(feats))
    text = prompts[1][:9].copy()
    text[1] = 5
    _assert_same_run(*_run(jgen, tgen, drafts, tdrafts, "msd", text, None))


def test_gqa_target_matches_jax():
    jgen, tgen, drafts, tdrafts, jcfg = _bundle(kv_heads=2)
    prompts, feats = _prompts(jcfg.vocab_size, n=1)
    jm, tm = _run(jgen, tgen, drafts, tdrafts, "echo", prompts[0], feats)
    _assert_same_run(jm, tm)


def test_pinned_first_token_and_eos_stop():
    jgen, tgen, drafts, tdrafts, jcfg = _bundle()
    prompts, feats = _prompts(jcfg.vocab_size, n=1)
    ref = tgen.generate(prompts[0], torch.from_numpy(feats), MAX_NEW)
    pinned = tgen.generate(prompts[0], torch.from_numpy(feats), MAX_NEW,
                           first_token=int(ref.tokens[0]))
    np.testing.assert_array_equal(pinned.tokens, ref.tokens)
    tgen.eos_id = int(ref.tokens[5])
    stop = int(np.argmax(ref.tokens == tgen.eos_id))
    got = tgen.generate(prompts[0], torch.from_numpy(feats), MAX_NEW)
    np.testing.assert_array_equal(got.tokens, ref.tokens[:stop])
    ar = tgen.naive_generate(prompts[0], torch.from_numpy(feats), MAX_NEW)
    np.testing.assert_array_equal(ar.tokens, ref.tokens[:stop])


@pytest.mark.parametrize("widths,nodes", [(WIDTHS, 1 + sum(WIDTHS)),
                                          ((3, 3, 3, 3), 9), (None, 14)])
def test_medusa_tree_matches_jax(widths, nodes):
    """Width plans, a node budget that cuts the plan, and the top_k
    default."""
    jgen, tgen, drafts, tdrafts, jcfg = _bundle()
    heads = len(WIDTHS) - 1
    tree = dict(top_k=4, max_depth=len(WIDTHS), num_nodes=nodes,
                medusa_widths=widths)
    jst = JSE.Statics(tcfg=jcfg, dcfg=JC.DraftConfig(text=jcfg,
                                                      medusa_heads=heads),
                      tree=JC.TreeConfig(**tree), eng=jgen.eng,
                      sp=JSP(greedy_round_bits=6), n_img=0, eos_id=-1,
                      max_new=8)
    tst = TSE.Statics(tcfg=tgen.tcfg, dcfg=tgen.dcfg,
                      tree=TC.TreeConfig(**tree), eng=tgen.eng,
                      sp=TSP(greedy_round_bits=6), n_img=0, eos_id=-1,
                      max_new=8)
    hid = np.random.default_rng(7).normal(size=(64,)).astype(np.float32)
    jparams = dict(jgen.params, draft=drafts["msd"])
    jtr, _ = JSE._draft_expand_medusa(jst, jparams, None, jnp.asarray(hid),
                                      jnp.int32(9), jnp.zeros((4,)))
    tgen.params["draft"] = tdrafts["msd"]
    # the port expands a batch of lanes: this one lane is lane 0
    ttr = TSE._draft_expand(tst, tgen.params, torch.from_numpy(hid)[None],
                            torch.tensor([9], dtype=torch.int32))
    ttr = TT.Tree(*(x[0] for x in ttr))
    for field in TT.Tree._fields:
        np.testing.assert_array_equal(getattr(ttr, field).numpy(),
                                      np.asarray(getattr(jtr, field)),
                                      err_msg=field)


def test_evaluate_greedy_matches_jax():
    rng = np.random.default_rng(8)
    jgen, tgen, drafts, tdrafts, jcfg = _bundle()
    tst = TSE.Statics(tcfg=tgen.tcfg, dcfg=tgen.dcfg, tree=tgen.eng.tree,
                      eng=tgen.eng, sp=TSP(), n_img=0, eos_id=-1, max_new=8)
    tgen.params["draft"] = tdrafts["msd"]
    for trial in range(6):
        ttr = TSE._draft_expand(tst, tgen.params, torch.from_numpy(
            rng.normal(size=(1, 64)).astype(np.float32)),
            torch.tensor([3], dtype=torch.int32))
        ttr = TT.Tree(*(x[0] for x in ttr))
        logits = rng.normal(size=(ttr.tokens.shape[0], 64)).astype(np.float32)
        # plant agreements along a branch so acceptance goes deep
        for node in range(1, ttr.tokens.shape[0]):
            if rng.uniform() < 0.6:
                par = int(ttr.parents[node])
                logits[par, int(ttr.tokens[node])] = 50.0 + trial
        jtr = JT.Tree(**{f: jnp.asarray(getattr(ttr, f).numpy())
                         for f in TT.Tree._fields},
                      node_depth=jnp.asarray(ttr.positions.numpy()),
                      node_weight=jnp.zeros(ttr.tokens.shape), extras={})
        ref = JT.evaluate_greedy(jtr, jnp.asarray(logits))
        out = TT.evaluate_greedy(ttr, torch.from_numpy(logits))
        assert [int(x) for x in out] == [int(x) for x in ref], trial


@pytest.mark.parametrize("heads", [2, 4])
def test_smoke_main_path_and_oracle_gate_at_tiny_size(heads):
    """chip_smoke.run_main_path on the CPU at a tiny width (head_dim 128
    and 64): the AR baseline, MSD, the null-draft equality gate, the
    launch-count gate (no launch: CPU tensors take the plain twin) and the
    oracle-draft gate, which must accept the reference chain to full
    depth at every step."""
    import chip_smoke

    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=heads, intermediate_size=512,
                            max_pos=2048), residual_dtype="float32")
    res = chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                   device="cpu", dtype=torch.float32)
    assert res["launches"] == 0
    assert res["ar_decoded"] == 2 * 23
    steps, hist = chip_smoke.oracle_schedule(5, 24)
    assert steps == 4 and hist[6] == 4
