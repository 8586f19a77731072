"""Port draft head (msd_tpu_torch.models.draft) and LLaVA fusion
(msd_tpu_torch.models.llava) against the JAX package, on the CPU.

Same JAX-initialised params on both sides via the bridge. Tolerance
2e-5 on single fp32 products and one decoder layer; gathers, selects and
id expansion must be exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.models import llava as JV
from msd_tpu.ops.attention import causal_prefill_bias
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.models import draft as TD
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.models import llava as TV

TOL = dict(atol=2e-5, rtol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _draft(medusa_heads=3, kv_heads=None):
    kw = dict(vocab_size=96, hidden_size=32, layers=1, heads=4,
              kv_heads=kv_heads, intermediate_size=64, max_pos=128)
    jd = JC.DraftConfig(text=JC.LlamaConfig.tiny(**kw),
                        medusa_heads=medusa_heads)
    td = TC.DraftConfig(text=TC.LlamaConfig.tiny(**kw),
                        medusa_heads=medusa_heads)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = JD.init_draft_params(k1, jd)
    jp["fc_b"] = jax.random.normal(k2, jp["fc_b"].shape) * 0.1
    jp["medusa"] = JD.init_medusa_params(k2, jd)
    jp["medusa"]["mb"] = jax.random.normal(k1, jp["medusa"]["mb"].shape)
    return jd, td, jp, bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")


def test_draft_fuse_with_image_bypass_matches_jax():
    jd, td, jp, tp = _draft()
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(7, 32)).astype(np.float32)
    hid = rng.normal(size=(7, 32)).astype(np.float32)
    mask = np.array([0, 1, 1, 0, 0, 1, 0], bool)
    for m in (None, mask):
        ref = JD.draft_fuse(jp, jnp.asarray(emb), jnp.asarray(hid),
                            None if m is None else jnp.asarray(m))
        out = TD.draft_fuse(tp, _t(emb), _t(hid), None if m is None else _t(m))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    out = TD.draft_fuse(tp, _t(emb), _t(hid), _t(mask))
    assert torch.equal(out[1], _t(emb)[1])      # image rows pass through


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_draft_forward_matches_jax(kv_heads):
    """Layer 0 skips input_layernorm; the KV rows land at write_pos."""
    jd, td, jp, tp = _draft(kv_heads=kv_heads)
    rng = np.random.default_rng(1)
    t, s, wp = 6, 24, 5
    x = rng.normal(size=(t, 32)).astype(np.float32)
    pos = np.arange(wp, wp + t, dtype=np.int32)
    bias = np.array(causal_prefill_bias(t, s, start=wp))
    cos_j, sin_j = JL.make_rope(jd.text, 64)
    jkv = JD.init_draft_kv(jd, s)
    jkv = {k: v.at[:, :wp].set(0.5) for k, v in jkv.items()}
    ref, jkv = JD.draft_forward(jp, jd, jnp.asarray(x), jnp.asarray(pos), jkv,
                                jnp.int32(wp), jnp.asarray(bias), cos_j, sin_j)
    tkv = TD.init_draft_kv(td, s, torch.float32, "cpu")
    for v in tkv.values():
        v[:, :wp] = 0.5
    cos_t, sin_t = TL.make_rope(td.text, 64, "cpu")
    out, tkv = TD.draft_forward(tp, td, _t(x), _t(pos), tkv, wp, _t(bias),
                                cos_t, sin_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tkv["k"].numpy(), np.asarray(jkv["k"]), **TOL)


@pytest.mark.parametrize("shape", [(32,), (5, 32)])
def test_medusa_hiddens_matches_jax(shape):
    jd, td, jp, tp = _draft(medusa_heads=4)
    x = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    ref = JD.medusa_hiddens(jp["medusa"], jnp.asarray(x))
    out = TD.medusa_hiddens(tp["medusa"], _t(x))
    assert tuple(out.shape) == tuple(ref.shape)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_draft_init_is_seeded_and_keeps_the_jax_layouts():
    jd, td, jp, _ = _draft(medusa_heads=3, kv_heads=2)
    g = torch.Generator().manual_seed(11)
    tp = TD.init_draft_params(td, g, "cpu", torch.float32)
    tp["medusa"] = TD.init_medusa_params(td, g, "cpu", torch.float32)
    flat_j, flat_t = bridge.flatten(jp), bridge.flatten(tp)
    assert flat_j.keys() == flat_t.keys()
    for key, x in flat_t.items():
        assert tuple(x.shape) == tuple(flat_j[key].shape), key
    g2 = torch.Generator().manual_seed(11)
    again = TD.init_draft_params(td, g2, "cpu", torch.float32)
    assert torch.equal(again["fc_w"], tp["fc_w"])


def test_projector_matches_jax():
    cfg = JC.LlavaConfig(text=JC.LlamaConfig.tiny(hidden_size=32),
                         vision=JC.ClipVisionConfig.tiny(hidden_size=24))
    jp = JV.init_projector_params(jax.random.PRNGKey(4), cfg)
    tp = bridge.to_torch(jax.tree.map(np.asarray, jp), "cpu")
    feats = np.random.default_rng(3).normal(size=(9, 24)).astype(np.float32)
    ref = JV.projector_apply(jp, jnp.asarray(feats))
    out = TV.projector_apply(tp, _t(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("img_pos,n_img", [(1, 6), (0, 4), (5, 1), (7, 3)])
def test_expand_and_fuse_match_jax(img_pos, n_img):
    rng = np.random.default_rng(img_pos + n_img)
    ids = rng.integers(3, 50, size=8).astype(np.int32)
    ids[img_pos] = JC.IMAGE_TOKEN_INDEX
    out_len = 8 + n_img - 1 + 2
    table = rng.normal(size=(50, 16)).astype(np.float32)
    feats = rng.normal(size=(n_img, 16)).astype(np.float32)
    safe = np.where(ids < 0, 0, ids)
    np.testing.assert_array_equal(
        TV.expand_ids(_t(safe), img_pos, n_img, out_len).numpy(),
        np.asarray(JV.expand_ids(jnp.asarray(safe), img_pos, n_img,
                                 out_len)))
    ref = JV.fuse_embeddings(jnp.asarray(table), jnp.asarray(ids),
                             jnp.asarray(feats), img_pos, out_len)
    out = TV.fuse_embeddings({"embed_tokens": _t(table)}, _t(ids), _t(feats),
                             img_pos, out_len)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
