"""The port's sampling mode (msd_tpu_torch.ops.sampling, the
speculative-sampling walk of msd_tpu_torch.engine.tree, the sampled engine)
against the JAX package's, on the same inputs made from seeds with numpy,
on the CPU.

The port's random functions take their draws as tensors, so each is fed
exactly the uniforms and Gumbel noise that the JAX function draws from its
key (the test replays the JAX key splits): the sampled tokens, the accepted
node and the acceptance length must then be EQUAL. The walk must keep the
target distribution (total variation against the target's conditional),
and a sampled request must be reproducible from its seed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu.engine import tree as JT
from msd_tpu.ops import sampling as JS
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.engine import tree as TT
from msd_tpu_torch.ops import sampling as TS
from tests.test_torch_engine import MAX_NEW, _bundle, _prompts
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

SP_CASES = [dict(temperature=0.7), dict(temperature=1.0, top_k=5),
            dict(temperature=1.3, top_p=0.8),
            dict(temperature=1.0, top_p=0.9, top_k=20)]


@pytest.mark.parametrize("kw", SP_CASES, ids=[str(k) for k in SP_CASES])
def test_process_logits_matches_jax(kw):
    rng = np.random.default_rng(len(kw))
    logits = (rng.normal(size=(6, 64)) * 3).astype(np.float32)
    logits[0, :4] = logits[0, 4]          # ties at the cut
    ref = np.asarray(JS.process_logits(jnp.asarray(logits), JS.SamplingParams(
        **kw)))
    got = TS.process_logits(torch.from_numpy(logits),
                            TS.SamplingParams(**kw)).numpy()
    np.testing.assert_array_equal(got == TS.NEG_INF, ref == JS.NEG_INF)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    greedy = TS.process_logits(torch.from_numpy(logits), TS.SamplingParams())
    np.testing.assert_array_equal(greedy.numpy(), logits)


@pytest.mark.parametrize("cur_len", [0, 5, 40])
def test_repetition_penalty_matches_jax(cur_len):
    rng = np.random.default_rng(cur_len)
    logits = rng.normal(size=(3, 50)).astype(np.float32)
    ids = rng.integers(0, 50, 40).astype(np.int32)
    ref = np.asarray(JS.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(ids), jnp.int32(cur_len), 1.3))
    got = TS.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(ids),
        torch.tensor(cur_len), 1.3).numpy()
    np.testing.assert_array_equal(got != logits, ref != logits)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_sample_token_matches_jax_given_its_gumbel_noise():
    """jax.random.categorical(key, x) is argmax(gumbel(key, x.shape) + x):
    the port, fed that noise, samples the same token (200 seeds)."""
    sp_kw = dict(temperature=0.8, top_p=0.9, top_k=20)
    jsp, tsp = JS.SamplingParams(**sp_kw), TS.SamplingParams(**sp_kw)
    V = 64
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(200, V)) * 2).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), 200)
    ref = np.asarray(jax.vmap(lambda k, x: JS.sample_token(k, x, jsp))(
        keys, jnp.asarray(logits)))
    noise = np.array(jax.vmap(lambda k: jax.random.gumbel(
        k, (V,), jnp.float32))(keys))
    got = TS.sample_token(torch.from_numpy(logits), tsp,
                          torch.from_numpy(noise)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(got.tolist())) > 10
    # the engine's noise: standard Gumbel from uniforms
    u = torch.rand(20000, generator=torch.Generator().manual_seed(0))
    g = TS.gumbel_noise(u)
    assert abs(g.mean().item() - 0.5772) < 0.03
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.1


# ---------------------------------------------------------------------------
# the speculative-sampling walk
# ---------------------------------------------------------------------------

def _tree(tokens, parents, max_path_len):
    """A Tree from a parent list in topological order (-1 token = dead)."""
    n = len(tokens)
    tokens = np.asarray(tokens, np.int32)
    parents = np.asarray(parents, np.int32)
    depth = np.zeros(n, np.int32)
    ret = np.full((n, max_path_len), -1, np.int32)
    mask = np.eye(n, dtype=bool)
    ret[0, 0] = 0
    for i in range(1, n):
        depth[i] = depth[parents[i]] + 1
        ret[i] = ret[parents[i]]
        ret[i, depth[i]] = i
        mask[i] = mask[parents[i]]
        mask[i, i] = True
    arrays = dict(tokens=tokens, parents=parents, mask=mask, positions=depth,
                  retrieve=ret, valid=tokens >= 0)
    return arrays


def _medusa_tree(widths, rng, V):
    t = TC.TreeConfig(top_k=widths[0], max_depth=len(widths),
                      num_nodes=1 + sum(widths), medusa_widths=widths)
    _, _, par, _, _, _, _, _, _ = TSE._medusa_layout(t, len(widths) - 1,
                                                     "cpu")
    tokens = rng.integers(0, V, t.num_nodes)
    return _tree(tokens, par.numpy(), t.max_path_len)


def _shapes(V):
    rng = np.random.default_rng(1)
    dead = _tree([2, 3, 7, 12, 5, 9, -1, -1], [0, 0, 0, 0, 1, 4, 0, 0], 4)
    return {"small": _tree([2, 3, 7, 12, 5], [0, 0, 0, 0, 1], 3),
            "medusa": _medusa_tree((4, 3, 2, 2, 1, 1), rng, V),
            "dead_slots": dead}


def _jax_draws(key, D, K, V):
    """The uniforms and the final Gumbel noise that JAX's
    evaluate_sampling draws from ``key``: one split per child step, threaded
    through every depth, then the final key."""
    us = []
    for _ in range(D * K):
        key, sub = jax.random.split(key)
        us.append(jax.random.uniform(sub))
    return jnp.stack(us).reshape(D, K), jax.random.gumbel(key, (V,),
                                                          jnp.float32)


@pytest.mark.parametrize("shape", ["small", "medusa", "dead_slots"])
def test_evaluate_sampling_matches_jax_given_its_draws(shape):
    """best, accept_len and next_token equal over 200 seeds, with target
    distributions that put mass on the drafted tokens so walks go deep."""
    V, top_k, n_seeds = 24, 4, 200
    arrays = _shapes(V)[shape]
    N, P = arrays["retrieve"].shape
    D, K = P - 1, TT.sampling_width(N, top_k)
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(n_seeds, N, V)) * 1.5
    for i in range(1, N):
        if arrays["tokens"][i] >= 0:
            logits[:, arrays["parents"][i], arrays["tokens"][i]] += \
                rng.uniform(0, 3, n_seeds)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    probs = probs.astype(np.float32)
    jtree = JT.Tree(**{k: jnp.asarray(v) for k, v in arrays.items()},
                    node_depth=jnp.asarray(arrays["positions"]),
                    node_weight=jnp.zeros(N), extras={})
    ttree = TT.Tree(**{k: torch.from_numpy(np.asarray(v))
                       for k, v in arrays.items()})
    keys = jax.random.split(jax.random.PRNGKey(11), n_seeds)
    ref = jax.jit(jax.vmap(lambda k, p: JT.evaluate_sampling(
        jtree, p, k, top_k)))(keys, jnp.asarray(probs))
    us, gs = jax.jit(jax.vmap(lambda k: _jax_draws(k, D, K, V)))(keys)
    ref = [np.asarray(r) for r in ref]
    us, gs = np.asarray(us), np.asarray(gs)
    got = np.asarray([[int(x) for x in TT.evaluate_sampling(
        ttree, torch.from_numpy(probs[i]), torch.from_numpy(us[i]),
        torch.from_numpy(gs[i]), top_k)] for i in range(n_seeds)])
    for col, name in enumerate(("best", "accept_len", "next_token")):
        np.testing.assert_array_equal(got[:, col], ref[col], err_msg=name)
    assert got[:, 1].max() >= 2 and (got[:, 1] == 0).any()


def test_speculative_sampling_preserves_distribution():
    """The first token emitted after the root (accepted draft child or
    residual-sampled bonus) is distributed as the target's conditional
    distribution at the root, whatever the draft proposed: 4000 walks with
    draws from a seeded torch.Generator, total variation < 0.05."""
    V = 16
    rng = np.random.default_rng(0)
    arrays = _tree([2, 3, 7, 12, 5], [0, 0, 0, 0, 1], 3)
    tree = TT.Tree(**{k: torch.from_numpy(np.asarray(v))
                      for k, v in arrays.items()})
    logits = rng.normal(size=(5, V)) * 1.5
    probs = torch.from_numpy(
        (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(
            np.float32))
    n, K = 4000, TT.sampling_width(5, 10)
    g = torch.Generator().manual_seed(42)
    us = torch.rand(n, 2, K, generator=g)
    noise = TS.gumbel_noise(torch.rand(n, V, generator=g))
    firsts = []
    for i in range(n):
        best, acc, nxt = TT.evaluate_sampling(tree, probs, us[i], noise[i])
        firsts.append(int(tree.tokens[tree.retrieve[best, 1]]) if acc >= 1
                      else int(nxt))
    emp = np.bincount(firsts, minlength=V) / n
    tv = 0.5 * np.abs(emp - probs[0].numpy()).sum()
    assert tv < 0.05, f"total variation {tv:.4f}"


def test_evaluate_sampling_checks_its_draws():
    arrays = _tree([2, 3, 7, 12, 5], [0, 0, 0, 0, 1], 3)
    tree = TT.Tree(**{k: torch.from_numpy(np.asarray(v))
                      for k, v in arrays.items()})
    with pytest.raises(ValueError, match="uniforms"):
        TT.evaluate_sampling(tree, torch.full((5, 8), 0.125),
                             torch.zeros(2, 3), torch.zeros(8))


# ---------------------------------------------------------------------------
# the sampled engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mha():
    return _bundle()


SP = dict(temperature=1.0, top_p=0.9, top_k=20, greedy_round_bits=6)


@pytest.mark.parametrize("share_prefill", [None, True, False])
def test_sampled_request_reproduces_from_its_seed(mha, share_prefill):
    """MSD (share_prefill None) and both AR baselines: seed 7 twice gives
    the same tokens, seed 8 others; the tokens are valid ids."""
    _, tgen, _, tdrafts, jcfg = mha
    tgen.params["draft"] = tdrafts["msd"]
    prompts, feats = _prompts(jcfg.vocab_size)
    sp = TS.SamplingParams(**SP)

    def run(seed):
        if share_prefill is None:
            return tgen.generate(prompts[0], torch.from_numpy(feats),
                                 MAX_NEW, seed=seed, sp=sp)
        return tgen.naive_generate(prompts[0], torch.from_numpy(feats),
                                   MAX_NEW, seed=seed, sp=sp,
                                   share_prefill=share_prefill)

    a, b, c = run(7), run(7), run(8)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.shape == (MAX_NEW,)
    assert 0 <= a.tokens.min() and a.tokens.max() < jcfg.vocab_size
    assert not np.array_equal(a.tokens, c.tokens)
    if share_prefill is None:
        assert (a.accept_steps, a.accept_len_sum) == \
            (b.accept_steps, b.accept_len_sum)


def test_sampled_msd_with_repetition_penalty_runs(mha):
    _, tgen, _, tdrafts, jcfg = mha
    tgen.params["draft"] = tdrafts["msd"]
    prompts, _ = _prompts(jcfg.vocab_size)
    sp = TS.SamplingParams(temperature=1.0, repetition_penalty=1.3)
    r = tgen.generate(prompts[0][2:], max_new_tokens=12, sp=sp, seed=3)
    assert r.accept_steps > 0 and len(r.tokens) == 12
    ar = tgen.naive_generate(prompts[0][2:], max_new_tokens=12, sp=sp,
                             seed=3)
    assert len(ar.tokens) == 12
