"""Port LLaMA (msd_tpu_torch.models.llama) against the JAX package's
``models/llama`` on tiny fp32 configs, on the CPU.

The same JAX-initialised params go through both sides via the bridge.
Tolerance 2e-4 absolute on hiddens and logits: a few layers of fp32
matmuls and softmaxes summed in different orders on two frameworks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.models import llama as JL
from msd_tpu.ops.attention import NEG_INF, causal_prefill_bias
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops import decode_attention as K1

TOL = dict(atol=2e-4, rtol=2e-4)


def _cfgs(residual=None, **kw):
    base = dict(vocab_size=128, hidden_size=64, layers=2, heads=4,
                intermediate_size=96, max_pos=256)
    base.update(kw)
    return (dataclasses.replace(JC.LlamaConfig.tiny(**base),
                                residual_dtype=residual),
            dataclasses.replace(TC.LlamaConfig.tiny(**base),
                                residual_dtype=residual))


def _params(jcfg, seed=0):
    jp = JL.init_llama_params(jax.random.PRNGKey(seed), jcfg)
    return jp, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def _prefill(jcfg, tcfg, jp, tp, t=11, s=32, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, jcfg.vocab_size, size=t).astype(np.int32)
    cos_j, sin_j = JL.make_rope(jcfg, 64)
    cos_t, sin_t = TL.make_rope(tcfg, 64, "cpu")
    bias = np.array(causal_prefill_bias(t, s))
    pos = np.arange(t, dtype=np.int32)
    jkv = JL.init_kv_cache(jcfg, s)
    jh, jkv = JL.llama_forward(jp, jcfg, JL.embed_tokens(jp, jnp.asarray(ids)),
                               jnp.asarray(pos), jkv, jnp.int32(0),
                               jnp.asarray(bias), cos_j, sin_j)
    tkv = TL.init_kv_cache(tcfg, s, torch.float32, "cpu")
    th, tkv2 = TL.llama_forward(tp, tcfg, TL.embed_tokens(tp, torch.from_numpy(ids)),
                                torch.from_numpy(pos), tkv, 0,
                                torch.from_numpy(bias), cos_t, sin_t)
    assert tkv2 is tkv           # updated in place
    return (jh, jkv, cos_j, sin_j), (th, tkv, cos_t, sin_t)


@pytest.mark.parametrize("residual", [None, "float32"])
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_prefill_hiddens_logits_and_kv_match_jax(residual, kv_heads):
    jcfg, tcfg = _cfgs(residual, kv_heads=kv_heads)
    jp, tp = _params(jcfg)
    (jh, jkv, *_), (th, tkv, *_) = _prefill(jcfg, tcfg, jp, tp)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(TL.lm_head(tp, th).numpy(),
                               np.asarray(JL.lm_head(jp, jh)), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   **TOL)


@pytest.mark.parametrize("kv_heads", [2, 1])
def test_ar_step_through_kernel_route_matches_jax(kv_heads):
    """head_dim 128 and G*T <= 4: _attend sends the decode row to K1 (its
    plain twin on the CPU); JAX on the CPU uses masked attention."""
    jcfg, tcfg = _cfgs("float32", hidden_size=256, heads=2,
                       kv_heads=kv_heads, intermediate_size=128)
    assert tcfg.head_dim == K1.HEAD_DIM
    jp, tp = _params(jcfg, seed=2)
    s, t = 32, 9
    (jh, jkv, cos_j, sin_j), (th, tkv, cos_t, sin_t) = _prefill(
        jcfg, tcfg, jp, tp, t=t, s=s)
    cur = t
    tok = np.array([5], np.int32)
    bias = np.where(np.arange(s) <= cur, 0.0, NEG_INF).astype(np.float32)[None]
    jh2, jkv = JL.llama_forward(jp, jcfg, JL.embed_tokens(jp, jnp.asarray(tok)),
                                jnp.asarray([cur], jnp.int32), jkv,
                                jnp.int32(cur), jnp.asarray(bias), cos_j, sin_j,
                                kv_len=jnp.int32(cur + 1))
    cur_t = torch.tensor(cur, dtype=torch.int32)
    th2, tkv = TL.llama_forward(tp, tcfg, TL.embed_tokens(tp, torch.from_numpy(tok)),
                                cur_t[None], tkv, cur_t, torch.from_numpy(bias),
                                cos_t, sin_t, kv_len=cur_t + 1)
    np.testing.assert_allclose(th2.numpy(), np.asarray(jh2), **TOL)
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]), **TOL)


def test_write_pos_clamps_like_dynamic_update_slice():
    assert TL.update_rows(10, 8, 4, "cpu").tolist() == [6, 7, 8, 9]
    assert TL.update_rows(10, torch.tensor(-3), 2, "cpu").tolist() == [0, 1]
    assert TL.update_rows(10, torch.tensor(3), 2, "cpu").tolist() == [3, 4]


def test_init_is_seeded_and_keeps_the_jax_layouts():
    _, tcfg = _cfgs(kv_heads=2)
    a = TL.init_llama_params(tcfg, torch.Generator().manual_seed(7), "cpu",
                             torch.bfloat16)
    b = TL.init_llama_params(tcfg, torch.Generator().manual_seed(7), "cpu",
                             torch.bfloat16)
    jcfg, _ = _cfgs(kv_heads=2)
    ref = jax.eval_shape(lambda: JL.init_llama_params_stacked(
        jax.random.PRNGKey(0), jcfg))
    flat_a, flat_b = bridge.flatten(a), bridge.flatten(b)
    flat_ref = bridge.flatten(ref)
    assert flat_a.keys() == flat_ref.keys()
    for key, x in flat_a.items():
        assert tuple(x.shape) == tuple(flat_ref[key].shape), key
        assert x.dtype == torch.bfloat16
        assert torch.equal(x, flat_b[key]), key


@pytest.mark.parametrize("heads,kv_heads", [(4, 4), (4, 2), (2, 2)])
def test_attend_sends_every_decode_row_to_the_kernel_wrapper(
        monkeypatch, heads, kv_heads):
    """G*T <= 4 with kv_len given goes to the decode-attention wrapper at
    every head_dim (16 and 32 here; 128 at 7B), so on the card a shape the
    kernel does not take raises there instead of running plain attention;
    verify rows (win) and rows without kv_len never reach it."""
    _, tcfg = _cfgs(hidden_size=64, heads=heads, kv_heads=kv_heads)
    calls = []

    def spy(q, k, v, bias, kv_len):
        calls.append(tuple(q.shape))
        return K1.decode_attention(q, k, v, bias, kv_len)

    monkeypatch.setattr(TL, "decode_attention", spy)
    g = torch.Generator().manual_seed(0)
    d = tcfg.head_dim
    k = torch.randn(16, kv_heads, d, generator=g)
    bias = torch.zeros(1, 16)
    n = torch.tensor(9, dtype=torch.int32)
    q1 = torch.randn(1, heads, d, generator=g)
    TL._attend(tcfg, q1, k, k, bias, n)
    assert calls == [(1, heads, d)]
    TL._attend(tcfg, q1, k, k, bias, None)
    q5 = torch.randn(5, heads, d, generator=g)
    TL._attend(tcfg, q5, k, k, torch.zeros(5, 16), n)
    assert calls == [(1, heads, d)]
