"""Teacher-forced scoring of the PyTorch port (``engine/scoring.py``,
``MSDGenerator.score`` and ``max_prompt_tokens``) against the JAX
package's, on one set of tiny fp32 weights carried across (CPU).

The counterparts of tests/test_loglikelihood.py:40-113 (a greedy
continuation is greedy, additivity, the plain recompute, the image) run
on the port; the JAX and port scores of the same requests agree to 1e-4
relative with equal greedy flags; the adapter's prompt truncation keeps
one ``<image>`` (cf. tests/test_harness.py:674).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from msd_tpu.harness.models.llava_msd import LlavaMSD as JLlavaMSD
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu_torch.configs import IMAGE_TOKEN_INDEX
from msd_tpu_torch.harness.models.llava_msd import LlavaMSD, SimpleTokenizer
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops.attention import causal_prefill_bias
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_serve import MEDUSA, V, _feats, _lcfgs, _stack

RTOL = 1e-4


@pytest.fixture(scope="module")
def stack():
    """(JAX generator, port generator, port LLaVA weights) over the same
    tiny weights."""
    jgen, tgen, _, tlp = _stack(MEDUSA, medusa_heads=4)
    return jgen, tgen, tlp


@pytest.fixture(scope="module")
def gens(stack):
    """(JAX generator, port generator, image rows for each); the rows come
    from the port's tower, carried to JAX."""
    jgen, tgen, tlp = stack
    feats = _feats(tlp)
    return jgen, tgen, jnp.asarray(feats.numpy()), feats


def _request(seed, n, image=False):
    ids = np.random.default_rng(seed).integers(3, V - 1, size=n) \
        .astype(np.int32)
    if image:
        ids[2] = IMAGE_TOKEN_INDEX
    return ids


@pytest.mark.parametrize("image", [False, True], ids=["text", "image"])
@pytest.mark.parametrize("cont_start", [1, 5, 17, 39])
def test_score_matches_jax(gens, image, cont_start):
    """The same request through both packages: the summed log-probability
    to 1e-4 relative and the same greedy flag, with and without the
    image, across continuation splits (one of 40 tokens up to 39)."""
    jgen, tgen, jfeats, tfeats = gens
    ids = _request(10 + cont_start, 40, image)
    lp_j, greedy_j = jgen.score(ids, cont_start,
                                img_feats=jfeats if image else None)
    lp_t, greedy_t = tgen.score(ids, cont_start,
                                img_feats=tfeats if image else None)
    assert lp_t == pytest.approx(lp_j, rel=RTOL)
    assert greedy_t == greedy_j


@pytest.mark.parametrize("image", [False, True], ids=["text", "image"])
def test_greedy_continuation_matches_jax(gens, image):
    """A continuation the target generated itself is greedy in both
    packages, at the same log-probability."""
    jgen, tgen, jfeats, tfeats = gens
    prompt = _request(3, 12, image)
    cont = tgen.naive_generate(prompt, tfeats if image else None,
                               max_new_tokens=8).tokens
    full = np.concatenate([prompt, cont]).astype(np.int32)
    lp_j, greedy_j = jgen.score(full, len(prompt),
                                jfeats if image else None)
    lp_t, greedy_t = tgen.score(full, len(prompt),
                                tfeats if image else None)
    assert greedy_t and greedy_j
    assert lp_t == pytest.approx(lp_j, rel=RTOL)


def test_score_greedy_continuation_is_greedy(gens):
    _, tgen, _, _ = gens
    prompt = _request(0, 12)
    cont = tgen.naive_generate(prompt, max_new_tokens=8).tokens
    full = np.concatenate([prompt, cont]).astype(np.int32)
    lp, greedy = tgen.score(full, cont_start=len(prompt))
    assert greedy
    assert lp < 0.0
    # perturbing one continuation token breaks greediness and drops the
    # log-probability
    bad = full.copy()
    bad[len(prompt) + 2] = (bad[len(prompt) + 2] + 7) % 500 + 3
    lp_bad, greedy_bad = tgen.score(bad, cont_start=len(prompt))
    assert not greedy_bad
    assert lp_bad < lp


def test_score_additivity(gens):
    """Causality: lp(full, s) == lp(full[:m], s) + lp(full, m)."""
    _, tgen, _, _ = gens
    full = _request(1, 24)
    s, m = 10, 17
    lp_all, _ = tgen.score(full, cont_start=s)
    lp_head, _ = tgen.score(full[:m], cont_start=s)
    lp_tail, _ = tgen.score(full, cont_start=m)
    assert lp_all == pytest.approx(lp_head + lp_tail, abs=1e-3)


def test_score_matches_manual_forward(gens):
    """The scoring forward against a direct softmax over an unpadded
    forward (float64 on the host)."""
    _, tgen, _, _ = gens
    full = _request(2, 16)
    s = 9
    lp, greedy = tgen.score(full, cont_start=s)
    tp, T = tgen.params["target"], len(full)
    ids = torch.from_numpy(full)
    emb = TL.embed_tokens(tp, ids)
    kv = TL.init_kv_cache(tgen.tcfg, T, emb.dtype, "cpu")
    hidden, _ = TL.llama_forward(tp, tgen.tcfg, emb,
                                 torch.arange(T, dtype=torch.int32), kv, 0,
                                 causal_prefill_bias(T, T, device="cpu"),
                                 tgen.params["cos_t"], tgen.params["sin_t"])
    logits = TL.lm_head(tp, hidden).double().numpy()
    mx = logits.max(-1, keepdims=True)
    logp = logits - mx - np.log(np.exp(logits - mx).sum(-1, keepdims=True))
    want = sum(logp[r, full[r + 1]] for r in range(s - 1, T - 1))
    assert lp == pytest.approx(want, rel=RTOL)
    assert greedy == all(int(np.argmax(logits[r])) == int(full[r + 1])
                         for r in range(s - 1, T - 1))


def test_score_with_image(gens):
    _, tgen, _, tfeats = gens
    prompt = _request(3, 10, image=True)
    cont = tgen.naive_generate(prompt, img_feats=tfeats,
                               max_new_tokens=6).tokens
    full = np.concatenate([prompt, cont]).astype(np.int32)
    lp, greedy = tgen.score(full, cont_start=len(prompt), img_feats=tfeats)
    assert greedy and lp < 0.0
    # without the image the same continuation scores otherwise
    lp_noimg, _ = tgen.score(np.where(full == IMAGE_TOKEN_INDEX, 3, full)
                             .astype(np.int32), cont_start=len(prompt))
    assert lp_noimg != pytest.approx(lp, abs=1e-6)


@pytest.mark.parametrize("cont_start", [0, 12, -1])
def test_score_rejects_a_split_outside_the_request(gens, cont_start):
    """Same ValueError as the JAX package for a split that leaves the
    context or the continuation empty."""
    jgen, tgen, _, _ = gens
    ids = _request(4, 12)
    with pytest.raises(ValueError, match="cont_start"):
        jgen.score(ids, cont_start)
    with pytest.raises(ValueError, match="cont_start"):
        tgen.score(ids, cont_start)


def test_max_prompt_tokens_matches_jax(gens):
    """The adapters' truncation budget, and the longest prompt each
    package's generate accepts: one token more is refused by both."""
    jgen, tgen, jfeats, tfeats = gens
    cap = tgen.max_prompt_tokens
    assert cap == jgen.max_prompt_tokens
    ids = _request(5, cap, image=True)
    assert len(tgen.generate(ids, tfeats, max_new_tokens=2).tokens) >= 1
    longer = _request(5, cap + 1, image=True)
    with pytest.raises(ValueError, match="prompt too long"):
        tgen.generate(longer, tfeats, max_new_tokens=2)
    with pytest.raises(ValueError, match="prompt too long"):
        jgen.generate(longer, jfeats, max_new_tokens=2)


def test_prompt_truncation_keeps_one_image_token(stack):
    """Middle truncation keeps exactly one <image> near the head, even when
    the context embeds a literal '<image>' in the part kept; the ids equal
    the JAX adapter's."""
    jgen, tgen, tlp = stack
    _, tl = _lcfgs()
    mine = LlavaMSD.from_llava(tgen, SimpleTokenizer(V), tlp, tl)
    theirs = JLlavaMSD(jgen, JTok(V), lambda px: None, image_size=28)
    cap = tgen.max_prompt_tokens
    ctx = ("word " * (cap * 2)) + " <image> " + ("tail " * 64) + "question?"
    image = [np.zeros((28, 28, 3), np.uint8)]
    ids, feats = mine._prepare(ctx, image)
    assert len(ids) <= cap
    assert int(np.sum(ids == IMAGE_TOKEN_INDEX)) == 1
    assert int(np.argmax(ids == IMAGE_TOKEN_INDEX)) < cap // 2
    assert tuple(feats.shape) == (tgen.n_img, tgen.tcfg.hidden_size)
    ref, _ = theirs._prepare(ctx, image)
    np.testing.assert_array_equal(ids, ref)
