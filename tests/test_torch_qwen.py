"""The port's inline-image (Qwen2-VL) engine paths against the JAX
package's, on a tiny fp32 Qwen2-VL decoder (GQA 4/2, q/k/v biases) on the
CPU: ``qwen_prefill`` / ``qwen_ar_prefill`` with mrope, ``pos_delta``
through every drafting mode, streaming, batched lanes, a continuous slot
with ``img_grid`` and ``qwen_score_program``; the weights are JAX's,
carried across, the prompts made from seeds with numpy.

Tokens and acceptance counts must be EQUAL to JAX's (both sides round the
logits to 6 mantissa bits before every argmax), greedy MSD equal to the
port's own AR baseline; scores within 1e-4 (relative) with equal greedy
flags. ``chip_smoke.py``'s ``[qwen]`` phase runs here at a tiny width.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import qwen2vl as JQ
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from msd_tpu_torch.serve.continuous import ContinuousScheduler, Request
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_qwen_model import QKW, _host, jax_qwen_params

N_IMG, GRID, MAX_NEW = 6, (2, 3), 16
SMALL_CHOICES = ((0,), (1,), (2,), (0, 0), (0, 1), (1, 0), (0, 0, 0),
                 (0, 0, 1), (0, 0, 0, 0))
MODES = {   # tree, medusa heads
    "medusa": (dict(top_k=4, max_depth=5, num_nodes=13,
                    medusa_widths=(4, 3, 2, 2, 1)), 4),
    "eagle": (dict(top_k=4, max_depth=5, num_nodes=16), 0),
    "static": (dict(top_k=4, max_depth=5, num_nodes=12,
                    static_choices=SMALL_CHOICES), 0),
}


def _bundle(mode):
    tree, heads = MODES[mode]
    jq = JQ.Qwen2VLTextConfig.tiny(**QKW)
    jl = jq.as_llama()
    tl = TQ.Qwen2VLTextConfig.tiny(**QKW).as_llama()
    jd = JC.DraftConfig(text=jl, medusa_heads=heads)
    td = TC.DraftConfig(text=tl, medusa_heads=heads)
    jtp = jax_qwen_params(jq)
    k = jax.random.split(jax.random.PRNGKey(5), 2)
    dp = JD.init_draft_params(k[0], jd)
    if heads:
        dp["medusa"] = JD.init_medusa_params(k[1], jd)
    dp["embed_tokens"] = jtp["embed_tokens"]
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    common = dict(n_img=N_IMG, eos_id=-1, image_mode="inline",
                  mrope_section=jq.mrope_section)
    jgen = JGen(jtp, dp, jl, jd, JC.EngineConfig(
        tree=JC.TreeConfig(**tree), **eng), sp=JSP(greedy_round_bits=6),
        **common)
    tgen = TGen(bridge.to_torch(_host(jtp), "cpu"),
                bridge.to_torch(_host(dp), "cpu"), tl, td,
                TC.EngineConfig(tree=TC.TreeConfig(**tree), **eng),
                sp=TSP(greedy_round_bits=6), device="cpu", **common)
    return jgen, tgen


@pytest.fixture(scope="module", params=list(MODES))
def gens(request):
    return request.param, _bundle(request.param)


@pytest.fixture(scope="module")
def medusa():
    return _bundle("medusa")


def _prompt(seed, image=True, n=17, start=5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, QKW["vocab"] - 1, size=n).astype(np.int32)
    feats = None
    if image:
        ids[start - 1] = TQ.VISION_START_ID
        ids[start:start + N_IMG] = TQ.IMAGE_PAD_ID
        ids[start + N_IMG] = TQ.VISION_END_ID
        feats = (rng.normal(size=(N_IMG, QKW["hidden"])) * 0.1).astype(
            np.float32)
    return ids, feats


def _jf(feats):
    return None if feats is None else jnp.asarray(feats)


def _tf(feats):
    return None if feats is None else torch.from_numpy(feats)


def _grid(feats):
    return None if feats is None else GRID


def _same(tm, jm):
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    assert (tm.accept_steps, tm.accept_len_sum) == \
        (jm.accept_steps, jm.accept_len_sum)


@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_inline_msd_matches_jax(gens, image):
    """Greedy MSD of an inline prompt (with the image span: mrope in the
    prefill, pos_delta in every later rope position of the draft and the
    verify; or text only) in each drafting mode: tokens and acceptance
    counts equal to JAX's, and equal to the port's AR baseline."""
    mode, (jgen, tgen) = gens
    ids, feats = _prompt(1, image)
    jm = jgen.generate(ids, img_feats=_jf(feats), max_new_tokens=MAX_NEW,
                       img_grid=_grid(feats))
    tm = tgen.generate(ids, img_feats=_tf(feats), max_new_tokens=MAX_NEW,
                       img_grid=_grid(feats))
    _same(tm, jm)
    ar = tgen.naive_generate(ids, img_feats=_tf(feats),
                             max_new_tokens=MAX_NEW, img_grid=_grid(feats))
    np.testing.assert_array_equal(ar.tokens, tm.tokens)
    assert int(tgen.state.pos_delta) == (
        max(GRID) - N_IMG if image else 0)


@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_inline_ar_matches_jax(medusa, image):
    """``naive_generate`` (``qwen_ar_prefill`` + the AR token at cache
    index + pos_delta) gives JAX's tokens."""
    jgen, tgen = medusa
    ids, feats = _prompt(2, image)
    jm = jgen.naive_generate(ids, img_feats=_jf(feats),
                             max_new_tokens=MAX_NEW, img_grid=_grid(feats))
    tm = tgen.naive_generate(ids, img_feats=_tf(feats),
                             max_new_tokens=MAX_NEW, img_grid=_grid(feats))
    np.testing.assert_array_equal(tm.tokens, jm.tokens)


def test_inline_stream_matches_oneshot(medusa):
    """``generate_stream`` over the inline path: the chunks concatenate to
    ``generate``'s tokens."""
    _, tgen = medusa
    ids, feats = _prompt(3)
    one = tgen.generate(ids, img_feats=_tf(feats), max_new_tokens=MAX_NEW,
                        img_grid=GRID)
    chunks = list(tgen.generate_stream(ids, img_feats=_tf(feats),
                                       max_new_tokens=MAX_NEW, segment=5,
                                       img_grid=GRID))
    np.testing.assert_array_equal(np.concatenate(chunks), one.tokens)
    assert len(chunks) > 1


def test_inline_batch_matches_single_and_jax(medusa):
    """``generate_batch`` over inline image prompts of different lengths
    and image offsets, one shared grid: each lane equals its solo run and
    JAX's batch."""
    jgen, tgen = medusa
    prompts = [_prompt(10 + b, n=15 + b, start=3 + b) for b in range(3)]
    ids = [p[0] for p in prompts]
    tb = tgen.generate_batch(ids, [_tf(p[1]) for p in prompts],
                             max_new_tokens=MAX_NEW, img_grid=GRID)
    jb = jgen.generate_batch(ids, [jnp.asarray(p[1]) for p in prompts],
                             max_new_tokens=MAX_NEW, img_grid=GRID)
    for b, (ids_b, feats_b) in enumerate(prompts):
        solo = tgen.generate(ids_b, img_feats=_tf(feats_b),
                             max_new_tokens=MAX_NEW, img_grid=GRID)
        _same(tb[b], solo)
        _same(tb[b], jb[b])


def test_mixed_batch_lanes_keep_their_positions(medusa):
    """An image lane and a text lane in one batch: each lane's pos_delta is
    its own (the text lane's 1-D positions), so each equals its solo run."""
    _, tgen = medusa
    img, txt = _prompt(20), _prompt(21, image=False)
    tb = tgen.generate_batch([img[0], txt[0]], [_tf(img[1]), None],
                             max_new_tokens=MAX_NEW, img_grid=GRID)
    for r, (ids, feats) in zip(tb, (img, txt)):
        _same(r, tgen.generate(ids, img_feats=_tf(feats),
                               max_new_tokens=MAX_NEW, img_grid=_grid(feats)))


def test_continuous_slot_with_img_grid(medusa):
    """A continuous batcher's slots prefilled with ``qwen_prefill`` from the
    request's ``img_grid`` (image and text requests joining at different
    segments): each request's tokens equal its lone ``generate``."""
    _, tgen = medusa
    reqs = [(_prompt(30), 12), (_prompt(31, image=False), 16),
            (_prompt(32, n=19, start=7), 9)]
    sched = ContinuousScheduler(tgen, n_slots=2, segment=4)
    for (ids, feats), n in reqs:
        sched.submit(Request(ids=ids, img_feats=_tf(feats),
                             img_grid=_grid(feats), max_new=n))
    done = sched.run_all()
    sched.close()
    assert len(done) == 3 and sched.joined == 3
    for r, ((ids, feats), n) in zip(sorted(done, key=lambda r: len(r.ids)
                                           * 100 + r.max_new), sorted(
            reqs, key=lambda q: len(q[0][0]) * 100 + q[1])):
        solo = tgen.generate(ids, img_feats=_tf(feats), max_new_tokens=n,
                             img_grid=_grid(feats))
        np.testing.assert_array_equal(r.tokens, solo.tokens)


@pytest.mark.parametrize("image", [True, False], ids=["image", "text"])
def test_qwen_score_matches_jax(medusa, image):
    """``MSDGenerator.score`` of an inline request (``qwen_score_program``:
    the fused span, mrope tables from the grid): the continuation's
    log-probability within 1e-4 (relative) of JAX's, the greedy flag
    equal; the AR continuation scores as greedy."""
    jgen, tgen = medusa
    ids, feats = _prompt(40, image)
    ar = tgen.naive_generate(ids, img_feats=_tf(feats), max_new_tokens=6,
                             img_grid=_grid(feats)).tokens
    rnd = np.random.default_rng(41).integers(3, 120, 5).astype(np.int32)
    for cont in (ar, rnd):
        full = np.concatenate([ids, cont]).astype(np.int32)
        tlp, tg = tgen.score(full, len(ids), _tf(feats), img_grid=_grid(
            feats))
        jlp, jg = jgen.score(full, len(ids), _jf(feats),
                             img_grid=_grid(feats))
        assert tlp == pytest.approx(jlp, rel=1e-4)
        assert tg == jg
    assert tgen.score(np.concatenate([ids, ar]), len(ids), _tf(feats),
                      img_grid=_grid(feats))[1]


def test_inline_prompt_budget(medusa):
    """An inline prompt holds its image rows: ``max_prompt_tokens`` is the
    engine limit less one (no expansion), as JAX's."""
    jgen, tgen = medusa
    assert tgen.max_prompt_tokens == jgen.max_prompt_tokens
    assert tgen._e0(np.zeros(20, np.int32), torch.zeros(N_IMG, 64)) == 20


def test_inline_options_jax_refuses_raise(medusa):
    """A pinned first token and the shared prefill are expand-mode only, as
    in JAX: inline engines raise instead of dropping them."""
    _, tgen = medusa
    ids, feats = _prompt(50)
    with pytest.raises(ValueError, match="inline"):
        tgen.generate(ids, img_feats=_tf(feats), max_new_tokens=4,
                      img_grid=GRID, first_token=5)
    with pytest.raises(ValueError, match="inline"):
        tgen.first_token(ids, _tf(feats))
    with pytest.raises(ValueError, match="expand-mode"):
        tgen.naive_generate(ids, img_feats=_tf(feats), max_new_tokens=4,
                            img_grid=GRID, share_prefill=True)


def test_smoke_qwen_phase_at_tiny_size(tmp_path):
    """chip_smoke's [qwen] phase on the CPU at a tiny width: graph (here
    eager) MSD == eager MSD == the null draft on two image prompts and a
    text prompt; every committed token the independent mrope recompute's
    argmax; AR == MSD (fp32: no split); the oracle draft accepted to full
    depth after the image; B = 2 == solo; the checkpoint written by
    ``save_qwen2_vl`` loaded back bitwise; the harness CLI's A (MSD), B
    (AR) and D (null draft) runs with equal token ids, bitwise equal
    scores within 1e-4 of their recompute; its [video] part on 4 frames
    (the tower against its block-per-block evaluation, the planted
    cross-block attention rejected, the adapter's video_gen MSD == null
    draft == AR, every token the recompute's argmax at grid_t 2). The
    phase raises otherwise."""
    import chip_smoke

    from msd_tpu_torch.models.qwen2vl_vision import Qwen2VisionConfig

    q = TQ.Qwen2VLTextConfig.tiny(**dict(QKW, vocab=512))
    out = chip_smoke.run_qwen(
        str(tmp_path), device="cpu", qcfg=q,
        vcfg=Qwen2VisionConfig.tiny(hidden=q.hidden_size),
        widths=(4, 3, 2, 2, 1), max_seq=512, max_new=12, prompt_tokens=20,
        limit=2, harness_new=8, video_frames=4)
    video = out["video"]
    assert video["n_vid"] == 2 * 144 and video["launches"] == 0
    assert video["check"]["off"] == 0 and video["check"]["split"] is None
    assert video["tower_rel"] <= 1e-5 < video["fault_rel"]
    assert out["launches"] == out["harness_launches"] == 0   # CPU: twin
    assert out["harness_splits"] == []
    assert out["recompute_worst"] == 0.0
    # the recomputes at the engine's row shapes agree with the unpadded one
    # far inside one bf16 ulp in fp32, so the card's noise allowance
    # measures rounding, not a wrong position or mask
    assert out["recompute_noise"] < 0.01
    assert out["fault"]["bad"] > 0
    assert out["worst_score_rel"] <= 1e-4
    assert out["A"]["payload"]["msd_stats"]["accept_steps"] > 0
