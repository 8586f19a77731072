"""The port's Qwen2-VL decoder pieces (``models/qwen2vl``, the qkv biases
of ``models/llama``, mrope in ``ops/rope``, ``pos_delta`` in the draft and
verify forwards, the attention routes) against the JAX package's and HF's,
on tiny fp32 configs on the CPU, inputs made from seeds with numpy.

Hiddens and logits agree within 1e-5 of JAX's (5e-5 for the drafts' fp32
forwards), positions, ids and trees EQUAL; against HF's Qwen2 decoder the
JAX package's own golden tolerance (atol 2e-4, rtol 2e-3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine import spec_engine as JSE
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.models import qwen2vl as JQ
from msd_tpu.ops.attention import causal_prefill_bias as j_causal
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.ops import rope as TR
from msd_tpu_torch.ops.attention import causal_prefill_bias
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_package_surface import DEPARTURES

ATOL = 1e-5
QKW = dict(vocab=128, hidden=64, layers=2, heads=4, kv_heads=2, inter=128)


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def _host(tree_):
    return jax.tree.map(np.asarray, tree_)


def jax_qwen_params(qcfg, seed=0, bias_std=0.1):
    """JAX Qwen2 params with random q/k/v biases (``init_qwen2_params``
    makes them zero, which would leave the bias add untested) and a
    sharpened head."""
    k = jax.random.split(jax.random.PRNGKey(seed), 4)
    p = JQ.init_qwen2_params(k[0], qcfg)
    for i, name in enumerate(("q_bias", "k_bias", "v_bias")):
        p["layers"][name] = jax.random.normal(
            k[i + 1], p["layers"][name].shape) * bias_std
    p["lm_head"] = p["lm_head"] * 3.0
    return p


@pytest.fixture(scope="module")
def decoder():
    jq = JQ.Qwen2VLTextConfig.tiny(**QKW)
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    jp = jax_qwen_params(jq)
    return jq, tq, jp, bridge.to_torch(_host(jp), "cpu")


def test_text_config_matches_jax():
    """Qwen2-VL-7B's defaults and the tiny constructor, field by field,
    and ``as_llama``."""
    for jc, tc in ((JQ.Qwen2VLTextConfig(), TQ.Qwen2VLTextConfig()),
                   (JQ.Qwen2VLTextConfig.tiny(**QKW),
                    TQ.Qwen2VLTextConfig.tiny(**QKW))):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        jl, tl = jc.as_llama(), tc.as_llama()
        for f in dataclasses.fields(tl):
            want = getattr(jl, f.name)
            if f.name in DEPARTURES:
                # the port's documented attention-routing defaults
                assert (want, getattr(tl, f.name)) == DEPARTURES[f.name]
            else:
                assert getattr(tl, f.name) == want, f.name
    q = TQ.Qwen2VLTextConfig()
    assert (q.vocab_size, q.hidden_size, q.num_attention_heads,
            q.num_key_value_heads, q.mrope_section) == \
        (152064, 3584, 28, 4, (16, 24, 24))
    assert (TQ.VISION_START_ID, TQ.VISION_END_ID, TQ.IMAGE_PAD_ID,
            TQ.VIDEO_PAD_ID) == (JQ.VISION_START_ID, JQ.VISION_END_ID,
                                 JQ.IMAGE_PAD_ID, JQ.VIDEO_PAD_ID)


@pytest.mark.parametrize("rows", [1, 13])
def test_decoder_with_biases_matches_jax(decoder, rows):
    """``llama_forward`` + ``lm_head`` of the qkv-bias GQA decoder over a
    causal prompt: hiddens and logits within 1e-5 of JAX's."""
    jq, tq, jp, tp = decoder
    jl, tl = jq.as_llama(), tq.as_llama()
    ids = np.random.default_rng(rows).integers(0, jq.vocab_size, rows)
    cos, sin = JL.make_rope(jl, 64)
    jh, _ = JL.llama_forward(jp, jl, jp["embed_tokens"][jnp.asarray(ids)],
                             jnp.arange(rows), JL.init_kv_cache(jl, 64),
                             jnp.int32(0), j_causal(rows, 64), cos, sin)
    tcos, tsin = TL.make_rope(tl, 64, "cpu")
    th, _ = TL.llama_forward(tp, tl, TL.embed_tokens(tp, _t(ids)),
                             torch.arange(rows),
                             TL.init_kv_cache(tl, 64, device="cpu"), 0,
                             causal_prefill_bias(rows, 64, device="cpu"),
                             tcos, tsin)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(TL.lm_head(tp, th).numpy(),
                               np.asarray(JL.lm_head(jp, jh)), atol=ATOL,
                               rtol=ATOL)


def test_decoder_matches_hf_qwen2():
    """``params_from_hf_qwen2`` over a HF ``Qwen2ForCausalLM`` state (nothing
    downloaded): the port's logits equal HF's (the JAX package's
    tests/test_qwen2vl.py:23-53)."""
    from transformers import Qwen2Config, Qwen2ForCausalLM

    qcfg = TQ.Qwen2VLTextConfig.tiny(vocab=128, hidden=32, layers=2,
                                     heads=4, kv_heads=2, inter=64)
    torch.manual_seed(0)
    hf = Qwen2ForCausalLM(Qwen2Config(
        vocab_size=qcfg.vocab_size, hidden_size=qcfg.hidden_size,
        intermediate_size=qcfg.intermediate_size,
        num_hidden_layers=qcfg.num_hidden_layers,
        num_attention_heads=qcfg.num_attention_heads,
        num_key_value_heads=qcfg.num_key_value_heads,
        max_position_embeddings=qcfg.max_position_embeddings,
        rms_norm_eps=qcfg.rms_norm_eps, rope_theta=qcfg.rope_theta,
        tie_word_embeddings=False, use_cache=True)).eval()
    with torch.no_grad():
        for name, w in hf.named_parameters():   # non-zero biases
            if name.endswith("proj.bias"):
                w.normal_(0.0, 0.1)
    state = {k: v.detach().float() for k, v in hf.state_dict().items()}
    params = TQ.params_from_hf_qwen2(state, qcfg, device="cpu")
    assert params["layers"]["k_bias"].shape == (2, 16)
    lc = qcfg.as_llama()
    ids = np.random.default_rng(4).integers(0, qcfg.vocab_size, 13)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids[None])).logits[0].numpy()
    cos, sin = TL.make_rope(lc, 64, "cpu")
    hidden, _ = TL.llama_forward(params, lc, TL.embed_tokens(
        params, _t(ids)), torch.arange(13),
        TL.init_kv_cache(lc, 64, device="cpu"), 0,
        causal_prefill_bias(13, 64, device="cpu"), cos, sin)
    np.testing.assert_allclose(TL.lm_head(params, hidden).numpy(), ref,
                               atol=2e-4, rtol=2e-3)


MROPE = {   # (prompt_len, img_start, n_img, grid_h, grid_w, grid_t)
    "image": (13, 4, 6, 2, 3, 1),
    "image_at_0": (9, 0, 4, 2, 2, 1),
    "video": (17, 0, 12, 2, 2, 3),
    "span_past_prompt": (7, 4, 6, 2, 3, 1),
    "wide_grid": (40, 3, 24, 2, 12, 1),
    "no_image": (11, 11, 0, 1, 1, 1),
}


@pytest.mark.parametrize("case", list(MROPE))
def test_mrope_positions_match_jax(case):
    """3-D positions and the post-image delta equal JAX's (images, a video
    with grid_t 3, a span cut by the prompt's end, text only)."""
    p_t, d_t = TQ.mrope_positions(*MROPE[case])
    p_j, d_j = JQ.mrope_positions(*MROPE[case])
    np.testing.assert_array_equal(p_t, p_j)
    assert d_t == d_j


@pytest.mark.parametrize("lanes", [0, 2])
def test_mrope_gather_matches_jax(lanes):
    """Per-token cos/sin tables equal JAX's, with or without a leading lane
    axis, and equal 1-D rope wherever the three positions are equal."""
    q = TQ.Qwen2VLTextConfig.tiny(**QKW)
    jcos, jsin = JL.make_rope(JQ.Qwen2VLTextConfig.tiny(**QKW).as_llama(), 64)
    tcos, tsin = _t(jcos), _t(jsin)     # the same tables on both sides
    pos = [JQ.mrope_positions(20, 3 + b, 6, 2, 3)[0]
           for b in range(max(lanes, 1))]
    jg = [JQ.mrope_gather(jcos, jsin, jnp.asarray(p, jnp.int32),
                          q.mrope_section) for p in pos]
    p3 = _t(np.stack(pos)) if lanes else _t(pos[0])
    gc, gs = TQ.mrope_gather(tcos, tsin, p3, q.mrope_section)
    want_c = np.stack([np.asarray(c) for c, _ in jg])
    want_s = np.stack([np.asarray(s) for _, s in jg])
    np.testing.assert_array_equal(gc.numpy().reshape(want_c.shape), want_c)
    np.testing.assert_array_equal(gs.numpy().reshape(want_s.shape), want_s)
    flat = np.tile(np.arange(10), (3, 1))
    c1, s1 = TQ.mrope_gather(tcos, tsin, _t(flat), q.mrope_section)
    assert torch.equal(c1, tcos[:10]) and torch.equal(s1, tsin[:10])


def test_rope_takes_per_lane_gathered_tables():
    """``apply_rope`` with per-token tables and row-index positions (the
    gathered-cos trick), with a lane axis on the tables: each lane as the
    single-lane call, which equals rope at the tables' own positions."""
    q = TQ.Qwen2VLTextConfig.tiny(**QKW)
    cos, sin = TL.make_rope(q.as_llama(), 64, "cpu")
    rng = np.random.default_rng(0)
    qs = _t(rng.normal(size=(2, 9, 4, 16)).astype(np.float32))
    ks = _t(rng.normal(size=(2, 9, 2, 16)).astype(np.float32))
    p3 = _t(np.stack([TQ.mrope_positions(9, 2 + b, 4, 2, 2)[0]
                      for b in range(2)]))
    gc, gs = TQ.mrope_gather(cos, sin, p3, q.mrope_section)   # [2, 9, 16]
    rows = torch.arange(9).expand(2, 9)
    qa, ka = TR.apply_rope(qs, ks, gc, gs, rows)
    for b in range(2):
        qb, kb = TR.apply_rope(qs[b], ks[b], gc[b], gs[b], torch.arange(9))
        assert torch.equal(qa[b], qb) and torch.equal(ka[b], kb)
    # equal positions: the gathered rows are the table's rows
    flat = _t(np.tile(np.arange(3, 12), (3, 1)))
    fc, fs = TQ.mrope_gather(cos, sin, flat, q.mrope_section)
    q1, k1 = TR.apply_rope(qs[0], ks[0], fc, fs, torch.arange(9))
    q2, k2 = TR.apply_rope(qs[0], ks[0], cos, sin, torch.arange(3, 12))
    assert torch.equal(q1, q2) and torch.equal(k1, k2)


def test_fuse_qwen_embeddings_matches_jax():
    """The image-pad span replaced by the vision rows, everything else the
    embedding (ids past a tiny vocabulary clamped, as JAX's gather)."""
    table = np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32)
    ids = np.asarray([1, 2, 3, 3, 3, 4, 151652], np.int32)
    feats = -np.ones((3, 4), np.float32)
    want = JQ.fuse_qwen_embeddings(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(feats), jnp.int32(2), 3)
    got = TQ.fuse_qwen_embeddings(_t(table), _t(ids), _t(feats), 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_only_qwen_lookups_clamp_ids():
    """``qwen2vl.embed_ids`` clamps ids past the table as JAX's gather
    does; the shared ``llama.embed_tokens`` (every LLaVA lookup) still
    refuses an id past its vocabulary."""
    table = np.random.default_rng(1).normal(size=(10, 4)).astype(np.float32)
    ids = np.asarray([0, 9, 151655], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    np.testing.assert_array_equal(TQ.embed_ids(_t(table), _t(ids)).numpy(),
                                  want)
    with pytest.raises(IndexError):
        TL.embed_tokens({"embed_tokens": _t(table)}, _t(ids))


def test_quantized_qwen_layers_keep_their_biases(decoder):
    """Weight-only int8/int4: the biases pass through unquantized, and the
    quantized layers hold them in layer order."""
    _, _, _, tp = decoder
    for bits in (8, 4):
        qp = TL.quantize_llama_params(tp, bits=bits)
        for name in ("q_bias", "k_bias", "v_bias"):
            assert torch.equal(qp["layers"][name], tp["layers"][name])
            assert not any(k.startswith(name + "_qs")
                           for k in qp["layers"])
    assert TL.lane_variant(tp, 2, 12) == frozenset()   # exact on the CPU


# ---------------------------------------------------------------------------
# attention routes
# ---------------------------------------------------------------------------

ROUTES = {   # (heads, kv_heads, T, kv_len given, window given) -> route
    "llava_ar_row": ((32, 32, 1, True, False), "decode_attention"),
    "llava_gqa_ar_row": ((32, 8, 1, True, False), "decode_attention"),
    "grouped_rows_4": ((4, 2, 2, True, False), "decode_attention"),
    "grouped_rows_8": ((8, 2, 2, True, False), "masked_attention"),
    "qwen_ar_row": ((28, 4, 1, True, False), "decode_attention"),
    "verify": ((28, 4, 6, True, True), "windowed_attention"),
    "llava_verify": ((32, 32, 6, True, True), "windowed_attention"),
    "prefill": ((28, 4, 5, False, False), "masked_attention"),
    "draft_row": ((28, 4, 1, False, False), "masked_attention"),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_attend_routes(monkeypatch, case):
    """``llama._attend``: the verify (a window) goes to the windowed
    attention; a call with kv_len goes to K1's wrapper at G*T <= 4, as
    before, and now also at T = 1 whatever G (Qwen2-VL-7B's AR row, G = 7);
    every other call to the masked attention. No LLaVA route changes."""
    (hq, hkv, t, with_len, with_win), want = ROUTES[case]
    cfg = TC.LlamaConfig(hidden_size=hq * 128, num_attention_heads=hq,
                         num_key_value_heads=hkv)
    called = []
    for name in ("decode_attention", "masked_attention",
                 "windowed_attention"):
        monkeypatch.setattr(TL, name, lambda *a, _n=name, **k:
                            called.append(_n))
    s = 8
    TL._attend(cfg, torch.zeros(t, hq, 128), torch.zeros(s, hkv, 128),
               torch.zeros(s, hkv, 128), torch.zeros(t, s),
               torch.tensor(3) if with_len else None,
               (None,) * 3 if with_win else None)
    assert called == [want]


def test_qwen_ar_row_through_k1_twin_equals_masked_attention():
    """On the CPU the Qwen AR row (T=1, G=7) takes K1's plain twin, which
    computes the masked attention's function over the live keys."""
    from msd_tpu_torch.ops.attention import masked_attention

    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(1, 28, 128)).astype(np.float32))
    k = _t(rng.normal(size=(40, 4, 128)).astype(np.float32))
    v = _t(rng.normal(size=(40, 4, 128)).astype(np.float32))
    bias = torch.where(torch.arange(40) < 23, 0.0, -1e30)[None]
    cfg = TC.LlamaConfig(hidden_size=28 * 128, num_attention_heads=28,
                         num_key_value_heads=4)
    got = TL._attend(cfg, q, k, v, bias, torch.tensor(23))
    want = masked_attention(q, k, v, bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# pos_delta in the draft and the verify
# ---------------------------------------------------------------------------

N_IMG = 6
DELTAS = [0, -4, 3]
EAGLE = dict(top_k=4, max_depth=5, num_nodes=16)
SMALL_CHOICES = ((0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (0, 0, 0),
                 (0, 0, 1), (0, 0, 0, 0))


def _statics(jq, tq, tree, medusa_heads=0):
    jl, tl = jq.as_llama(), tq.as_llama()
    common = dict(n_img=N_IMG, eos_id=-1, max_new=8, image_mode="inline",
                  mrope_section=tq.mrope_section)
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    jst = JSE.Statics(tcfg=jl, dcfg=JC.DraftConfig(
        text=jl, medusa_heads=medusa_heads), tree=JC.TreeConfig(**tree),
        eng=JC.EngineConfig(tree=JC.TreeConfig(**tree), **eng),
        sp=JSP(greedy_round_bits=6), **common)
    tst = TSE.Statics(tcfg=tl, dcfg=TC.DraftConfig(
        text=tl, medusa_heads=medusa_heads), tree=TC.TreeConfig(**tree),
        eng=TC.EngineConfig(tree=TC.TreeConfig(**tree), **eng),
        sp=TSP(greedy_round_bits=6), **common)
    return jst, tst


_J_EXPAND = jax.jit(JSE._draft_expand, static_argnums=(0,))
_J_SUFFIX = jax.jit(JSE._draft_suffix_forward, static_argnums=(0,))


def _params_both(decoder, seed=1):
    jq, tq, jp, tp = decoder
    jd = JD.init_draft_params(jax.random.PRNGKey(seed),
                              JC.DraftConfig(text=jq.as_llama()))
    jd["embed_tokens"] = jp["embed_tokens"]
    cos, sin = JL.make_rope(jq.as_llama(), 512)
    jparams = {"target": jp, "draft": jd, "cos_t": cos, "sin_t": sin}
    tparams = {"target": tp, "draft": bridge.to_torch(_host(jd), "cpu"),
               "cos_t": _t(cos), "sin_t": _t(sin)}
    return jparams, tparams


@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("mode", ["eagle", "static"])
def test_draft_expand_with_pos_delta_matches_jax(decoder, mode, delta):
    """The EAGLE frontier and the static tree's levels rope their rows at
    E + pos_delta + depth: the trees equal JAX's for negative, zero and
    positive deltas (and differ between deltas: the position reaches the
    proposals)."""
    jq, tq, _, _ = decoder
    tree = EAGLE if mode == "eagle" else dict(
        top_k=4, max_depth=5, num_nodes=12, static_choices=SMALL_CHOICES)
    jst, tst = _statics(jq, tq, tree)
    jparams, tparams = _params_both(decoder)
    rng = np.random.default_rng(7)
    E = 41
    kv = {n: (rng.normal(size=(1, tst.s_draft, 2, 16)) * 0.5).astype(
        np.float32) for n in ("k", "v")}
    hid = rng.normal(size=(64,)).astype(np.float32)
    af = np.zeros(4, np.float32)
    jtr, _ = _J_EXPAND(jst, jparams, {n: jnp.asarray(a) for n, a in
                                      kv.items()}, jnp.int32(E),
                       jnp.asarray(hid), jnp.int32(5), jparams["cos_t"],
                       jparams["sin_t"], jnp.asarray(af), jnp.int32(delta))
    ttr = TSE._draft_expand(tst, tparams, _t(hid)[None],
                            torch.tensor([5], dtype=torch.int32),
                            _t(af)[None], None,
                            {n: _t(a)[None] for n, a in kv.items()},
                            torch.tensor([E], dtype=torch.int32),
                            torch.tensor([delta], dtype=torch.int32))
    for field in ("tokens", "parents", "positions", "retrieve", "valid"):
        np.testing.assert_array_equal(getattr(ttr, field)[0].numpy(),
                                      np.asarray(getattr(jtr, field)),
                                      err_msg=field)


@pytest.mark.parametrize("delta", DELTAS)
def test_draft_suffix_forward_with_pos_delta_matches_jax(decoder, delta):
    """The suffix rows rope at draft_len + i + pos_delta and write, and
    attend, at cache slots draft_len + i: the last hidden and the cache
    rows equal JAX's."""
    jq, tq, _, _ = decoder
    jst, tst = _statics(jq, tq, EAGLE)
    jparams, tparams = _params_both(decoder)
    rng = np.random.default_rng(3)
    P, dlen, n_suffix = tst.tree.max_path_len, 37, 3
    kv = {n: (rng.normal(size=(1, tst.s_draft, 2, 16)) * 0.5).astype(
        np.float32) for n in ("k", "v")}
    toks = rng.integers(0, 128, P).astype(np.int32)
    hsuf = rng.normal(size=(P, 64)).astype(np.float32)
    prev = rng.normal(size=(64,)).astype(np.float32)
    jh, jkv, jlen, _ = _J_SUFFIX(
        jst, jparams, {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.int32(dlen), jnp.asarray(toks), jnp.asarray(hsuf),
        jnp.int32(n_suffix), jnp.asarray(prev), jparams["cos_t"],
        jparams["sin_t"], jnp.int32(5), jnp.zeros(4), jnp.int32(delta))
    s = TSE.alloc_state(tst, torch.float32, "cpu")
    s.draft_kv["k"].copy_(_t(kv["k"])[None])
    s.draft_kv["v"].copy_(_t(kv["v"])[None])
    s.draft_len.fill_(dlen)
    s.suffix_tokens.copy_(_t(toks)[None])
    s.suffix_hidden.copy_(_t(hsuf)[None])
    s.suffix_len.fill_(n_suffix)
    s.last_draft_hidden.copy_(_t(prev)[None])
    s.pos_delta.fill_(delta)
    th, _ = TSE._draft_suffix_forward(tst, tparams, s, tparams["cos_t"],
                                      tparams["sin_t"])
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh), atol=5e-5,
                               rtol=5e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(s.draft_kv[n][0].numpy(),
                                   np.asarray(jkv[n]), atol=5e-5, rtol=5e-5)
    assert int(jlen) == dlen + n_suffix


@pytest.mark.parametrize("delta", DELTAS)
def test_verify_forward_with_pos_delta_matches_jax(decoder, delta):
    """The verify nodes rope at E + depth + pos_delta while their cache
    rows and windows stay at E + depth: hiddens within 1e-5 of JAX's
    ``_verify`` forward (its logits' greedy acceptance equal)."""
    jq, tq, _, _ = decoder
    jst, tst = _statics(jq, tq, dict(top_k=4, max_depth=4, num_nodes=12,
                                     medusa_widths=(4, 3, 2, 2)),
                        medusa_heads=3)
    jparams, tparams = _params_both(decoder)
    rng = np.random.default_rng(11)
    E = 29
    L_, S = jq.num_hidden_layers, tst.s_target
    kv = {n: (rng.normal(size=(L_, S, 2, 16)) * 0.5).astype(np.float32)
          for n in ("k", "v")}
    lay = TSE._medusa_layout(tst.tree, 3, "cpu")
    tokens = rng.integers(0, 128, 12).astype(np.int32)
    tr = TSE.Tree(tokens=_t(tokens)[None], parents=lay[2][None],
                  mask=lay[3][None], positions=lay[4][None],
                  retrieve=lay[5][None], valid=lay[6][None])
    jtr = JSE.Tree(tokens=jnp.asarray(tokens), parents=jnp.asarray(lay[2]),
                   mask=jnp.asarray(lay[3]), positions=jnp.asarray(lay[4]),
                   retrieve=jnp.asarray(lay[5]), valid=jnp.asarray(lay[6]),
                   node_depth=jnp.asarray(lay[4]),
                   node_weight=jnp.ones(12), extras={})
    jh, _, jbest, jacc, jnext, _, _ = jax.jit(
        JSE._verify, static_argnums=(0,))(
        jst, jparams, {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.int32(E), jtr, jax.random.PRNGKey(0), jparams["cos_t"],
        jparams["sin_t"], jnp.int32(delta))
    tkv = {n: _t(a)[None] for n, a in kv.items()}
    th = TSE.verify_forward(tparams["target"], tst.tcfg, tkv,
                            torch.tensor([E], dtype=torch.int32), tr,
                            tparams["cos_t"], tparams["sin_t"],
                            pos_delta=torch.tensor([delta],
                                                   dtype=torch.int32))
    np.testing.assert_allclose(th[0].numpy(), np.asarray(jh), atol=ATOL,
                               rtol=ATOL)
