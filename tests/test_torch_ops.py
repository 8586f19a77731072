"""Port ops (msd_tpu_torch.ops) against the JAX package's ops, on the CPU.

Inputs come from numpy seeds and go through both functions. Tolerances:
fp32 elementwise ops and reductions over <= 128 terms agree to 1e-6
relative; attention (two fp32 products and a softmax) to 2e-5 absolute;
masks, canonical rounding and argmax must be bitwise equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu.ops import attention as JA
from msd_tpu.ops import norms as JN
from msd_tpu.ops import rope as JR
from msd_tpu.ops import sampling as JS
from msd_tpu_torch.ops import attention as TA
from msd_tpu_torch.ops import norms as TN
from msd_tpu_torch.ops import rope as TR
from msd_tpu_torch.ops import sampling as TS

ATTN_TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("shape", [(7, 64), (3, 5, 128)])
def test_rms_norm_matches_jax(shape):
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32) * 3
    w = rng.normal(size=shape[-1:]).astype(np.float32)
    ref = np.asarray(JN.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    out = TN.rms_norm(_t(x), _t(w), 1e-5).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_rope_table_and_apply_match_jax():
    cos_j, sin_j = JR.rope_table(96, 16, 10000.0)
    cos_t, sin_t = TR.rope_table(96, 16, 10000.0, device="cpu")
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(5, 2, 16)).astype(np.float32)
    pos = np.array([0, 3, 3, 40, 95], np.int32)
    qj, kj = JR.apply_rope(jnp.asarray(q), jnp.asarray(k), cos_j, sin_j,
                           jnp.asarray(pos))
    qt, kt = TR.apply_rope(_t(q), _t(k), _t(np.asarray(cos_j)),
                           _t(np.asarray(sin_j)), _t(pos))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-6)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6)


@pytest.mark.parametrize("t,hq,hkv,s", [(6, 4, 4, 40), (3, 8, 2, 33),
                                         (1, 4, 4, 17)])
def test_masked_attention_matches_jax(t, hq, hkv, s):
    rng = np.random.default_rng(t + hq)
    q = rng.normal(size=(t, hq, 16)).astype(np.float32)
    k = rng.normal(size=(s, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(s, hkv, 16)).astype(np.float32)
    keep = rng.uniform(size=(t, s)) < 0.7
    keep[:, 0] = True
    bias = np.where(keep, 0.0, JA.NEG_INF).astype(np.float32)
    ref = JA.masked_attention(*(jnp.asarray(a) for a in (q, k, v, bias)))
    out = TA.masked_attention(_t(q), _t(k), _t(v), _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


def _window_inputs(seed, t=5, s=48, w=4, hq=8, hkv=4, d=16, e=20):
    """Row i sits at logical position e + i with ancestors rows 0..i-1
    (physical == logical); its last w positions go through window slots."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(t, hq, d)).astype(np.float32)
    k = rng.normal(size=(s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(s, hkv, d)).astype(np.float32)
    win_start = e + np.arange(t) - (w - 1)
    lpos = win_start[:, None] + np.arange(w)[None, :]
    win_idx = np.clip(lpos, 0, s - 1).astype(np.int64)
    win_bias = np.where(lpos >= 0, 0.0, JA.NEG_INF).astype(np.float32)
    cols = np.arange(s)[None, :]
    bias = np.where(cols < win_start[:, None], 0.0,
                    JA.NEG_INF).astype(np.float32)
    return q, k, v, bias, win_idx, win_bias, win_start.astype(np.int32)


@pytest.mark.parametrize("compact", [True, False])
@pytest.mark.parametrize("seed,e,hkv", [(0, 20, 4), (1, 2, 2), (2, 43, 8)])
def test_windowed_attention_matches_jax(compact, seed, e, hkv):
    args = _window_inputs(seed, e=e, hkv=hkv)
    ref = JA.windowed_attention(*(jnp.asarray(a) for a in args),
                                compact=compact)
    out = TA.windowed_attention(*(_t(a) for a in args), compact=compact)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **ATTN_TOL)


def test_windowed_compact_is_bitwise_general():
    args = [_t(a) for a in _window_inputs(3, e=30)]
    a = TA.windowed_attention(*args, compact=True)
    b = TA.windowed_attention(*args, compact=False)
    assert torch.equal(a, b)


def test_biases_match_jax_bitwise():
    np.testing.assert_array_equal(
        TA.causal_prefill_bias(9, 20, start=3, device="cpu").numpy(),
        np.asarray(JA.causal_prefill_bias(9, 20, start=3)))
    kpos = np.arange(24, dtype=np.int32)
    np.testing.assert_array_equal(
        TA.length_mask_bias(_t(kpos), 11, 3).numpy(),
        np.asarray(JA.length_mask_bias(jnp.asarray(kpos), 11, 3)))
    rng = np.random.default_rng(4)
    m = rng.uniform(size=(6, 6)) < 0.5
    np.fill_diagonal(m, True)
    np.testing.assert_array_equal(
        TA.tree_bias(_t(m), 7, 20).numpy(),
        np.asarray(JA.tree_bias(jnp.asarray(m), 7, 20)))


def _edge_logits():
    edge = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 1.0 + 2 ** -7,
                     1.0 + 3 * 2 ** -7, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8,
                     3.4028235e38, -3.4028235e38, 1e-45, -1e-45,
                     1.1754942e-38, -5e-39, 1.1754944e-38], np.float32)
    rng = np.random.default_rng(5)
    rand = rng.integers(-2 ** 31, 2 ** 31 - 1, size=4000).astype(np.int32)
    return np.concatenate([edge, rng.normal(size=2000).astype(np.float32) * 50,
                           rand.view(np.float32)])


@pytest.mark.parametrize("bits", [0, 1, 6, 7, 10, 22])
def test_canon_logits_bitwise_matches_reduce_precision(bits):
    x = _edge_logits()
    ref = np.asarray(JS.canon_logits(jnp.asarray(x), bits))
    out = TS.canon_logits(_t(x), bits).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


def test_sample_token_greedy_matches_jax_and_takes_lowest_tie():
    rng = np.random.default_rng(6)
    logits = rng.normal(size=(20, 50)).astype(np.float32)
    logits[3, [7, 30]] = 9.0          # exact tie: index 7 wins
    logits[5, [11, 12]] = [4.0, 4.0 + 2 ** -12]   # tie after rounding
    jsp, tsp = JS.SamplingParams(greedy_round_bits=6), \
        TS.SamplingParams(greedy_round_bits=6)
    key = jax.random.PRNGKey(0)
    ref = np.array([int(JS.sample_token(key, jnp.asarray(r), jsp))
                    for r in logits])
    out = TS.sample_token(_t(logits), tsp).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[3] == 7 and out[5] == 11
