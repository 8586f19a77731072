"""The port's serving layer against the JAX package: streaming
(``generate_stream``), batched lanes (``generate_batch`` and the engine's
lane masking), the continuous batcher (``serve/continuous.py``) and the
HTTP front end (``serve/server.py``).

Mirrors tests/test_continuous.py, tests/test_spec_engine.py (batched and
streamed generation) and tests/test_harness.py (the HTTP surface). The
invariant is the serving-level losslessness claim: however requests share
a batch, stream or join, each one's tokens are exactly those of a lone
``generate()`` call, and on tiny fp32 weights carried from the JAX package
they equal the JAX package's tokens. Every server binds port 0, runs on
daemon threads, gives each request a timeout and is shut down in
``finally``.
"""

import base64
import dataclasses
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.harness.models.llava_msd import LlavaMSD
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import clip_vit as JCV
from msd_tpu.models import llava as JV
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu.serve import continuous as JCont
from msd_tpu.serve import server as JServer
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.calib import device as TCD
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from msd_tpu_torch.serve import cli
from msd_tpu_torch.serve import server as TServer
from msd_tpu_torch.serve.adapter import ServeAdapter, SimpleTokenizer
from msd_tpu_torch.serve.continuous import ContinuousScheduler, Request
from msd_tpu_torch.utils.conversation import vicuna_v1
from tests.test_torch_drafting import EAGLE, SMALL_CHOICES, _export, _weights
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

V, H, MAX_NEW = 512, 64, 24
MEDUSA = dict(top_k=4, max_depth=5, num_nodes=12,
              medusa_widths=(4, 3, 2, 1, 1))
VISION = dict(hidden_size=32, layers=2, heads=4, image_size=28,
              patch_size=14, intermediate_size=64)
N_IMG = 4       # (28 / 14) ** 2 patches
ENG = dict(max_seq_len=256, prompt_pad_multiple=32)
FAVOURED = np.array([7, 9, 11, 13])


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _stack(tree, medusa_heads=0, draft="echo", sp=None):
    """(JAX generator, port generator, JAX llava params, port llava params)
    over the same tiny weights: a 512-token target (the byte tokenizer's
    vocabulary) whose lm_head favours four tokens and less so EOS (2), so
    the echo draft of ``tests/test_torch_drafting._weights`` is accepted
    deep where the target repeats and requests end at different steps; a
    CLIP tower whose 28-pixel images give 4 rows."""
    jcfg = JC.LlamaConfig.tiny(vocab_size=V, hidden_size=H, layers=2,
                               heads=4, intermediate_size=128, max_pos=1024)
    tcfg = TC.LlamaConfig.tiny(vocab_size=V, hidden_size=H, layers=2,
                               heads=4, intermediate_size=128, max_pos=1024)
    jtp, drafts = _weights(jcfg, medusa_heads)
    jtp["lm_head"] = jtp["lm_head"].at[:, FAVOURED].multiply(4.0) \
        .at[:, 2].multiply(2.0)
    jsp = JSP() if sp is None else JSP(**sp)
    tsp = TSP() if sp is None else TSP(**sp)
    jgen = JGen(jtp, drafts[draft], jcfg,
                JC.DraftConfig(text=jcfg, medusa_heads=medusa_heads),
                JC.EngineConfig(tree=JC.TreeConfig(**tree), **ENG),
                n_img=N_IMG, eos_id=2, sp=jsp)
    tgen = TGen(bridge.to_torch(_host(jtp), "cpu"),
                bridge.to_torch(_host(drafts[draft]), "cpu"), tcfg,
                TC.DraftConfig(text=tcfg, medusa_heads=medusa_heads),
                TC.EngineConfig(tree=TC.TreeConfig(**tree), **ENG),
                n_img=N_IMG, eos_id=2, sp=tsp, device="cpu")
    jl = JC.LlavaConfig(text=jcfg, vision=JC.ClipVisionConfig.tiny(**VISION))
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    jlp = _host({"vision": JCV.init_clip_params(k1, jl.vision),
                 "projector": JV.init_projector_params(k2, jl)})
    return jgen, tgen, jlp, bridge.to_torch(jlp, "cpu")


def _lcfgs():
    return (JC.LlavaConfig(text=JC.LlamaConfig.tiny(vocab_size=V,
                                                    hidden_size=H),
                           vision=JC.ClipVisionConfig.tiny(**VISION)),
            TC.LlavaConfig(text=TC.LlamaConfig.tiny(vocab_size=V,
                                                    hidden_size=H),
                           vision=TC.ClipVisionConfig.tiny(**VISION)))


def _ids(seed, n, image=False):
    ids = np.random.default_rng(seed).integers(3, V - 1, size=n) \
        .astype(np.int32)
    if image:
        ids[2] = TC.IMAGE_TOKEN_INDEX
    return ids


def _feats(tlp, seed=3):
    from msd_tpu_torch.models.llava import encode_image
    px = np.random.default_rng(seed).normal(size=(3, 28, 28)) \
        .astype(np.float32)
    return encode_image(tlp, _lcfgs()[1], torch.from_numpy(px))


def _same_tokens(req, gen, **kw):
    """A scheduled request's tokens equal its solo run's. Its step counts
    may not: a slot is retired once its surfaced tokens reach max_new,
    where a solo run commits one more step (the JAX scheduler's rule)."""
    solo = gen.generate(req.ids, req.img_feats, req.max_new, seed=req.seed,
                        **kw)
    np.testing.assert_array_equal(req.tokens, solo.tokens)


def _same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.accept_steps, a.accept_len_sum) == \
        (b.accept_steps, b.accept_len_sum)


@pytest.fixture(scope="module")
def medusa():
    return _stack(MEDUSA, medusa_heads=4, sp=dict(greedy_round_bits=6))


@pytest.fixture(scope="module")
def eagle():
    return _stack(EAGLE, sp=dict(greedy_round_bits=6))


@pytest.fixture(scope="module")
def static():
    return _stack(dict(top_k=4, max_depth=5, num_nodes=12,
                       static_choices=SMALL_CHOICES),
                  sp=dict(greedy_round_bits=6))


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def test_stream_matches_generate_and_jax(eagle):
    """generate_stream's chunks concatenate to generate()'s tokens over
    several segments, with the same stats, and equal JAX's chunks."""
    jgen, tgen, _, _ = eagle
    ids = _ids(1, 19)
    one = tgen.generate(ids, max_new_tokens=40, seed=0)
    chunks = list(tgen.generate_stream(ids, max_new_tokens=40, segment=8))
    assert len(chunks) >= 2
    np.testing.assert_array_equal(np.concatenate(chunks), one.tokens)
    assert tgen.last_stream_stats == {"accept_steps": one.accept_steps,
                                      "accept_len_sum": one.accept_len_sum}
    jchunks = list(jgen.generate_stream(ids, max_new_tokens=40, segment=8))
    assert [c.tolist() for c in chunks] == [c.tolist() for c in jchunks]
    assert jgen.last_stream_stats == tgen.last_stream_stats


# ---------------------------------------------------------------------------
# batched lanes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["medusa", "eagle", "static"])
def test_generate_batch_matches_solo_and_jax(kind, request):
    """Three text prompts of different lengths as one batch: every lane
    equals its solo run (tokens, steps, accepted tokens, histogram) and
    JAX's generate_batch lane; one lane finishes at its first step and is
    masked for the rest of the batch."""
    jgen, tgen, _, _ = request.getfixturevalue(kind)
    prompts = [_ids(s, n) for s, n in ((102, 9), (59, 17), (100, 24))]
    solos = [tgen.generate(p, max_new_tokens=MAX_NEW) for p in prompts]
    batch = tgen.generate_batch(prompts, max_new_tokens=MAX_NEW)
    jbatch = jgen.generate_batch(prompts, max_new_tokens=MAX_NEW)
    for s, b, j in zip(solos, batch, jbatch):
        _same(b, s)
        np.testing.assert_array_equal(b.alpha_hist, s.alpha_hist)
        _same(b, j)
    # the lanes end at different steps (one at its first, by EOS) and one
    # accepts deep
    assert len({b.accept_steps for b in batch}) == 3
    assert min(len(b.tokens) for b in batch) < MAX_NEW
    assert max(b.avg_accept_len for b in batch) > 3.0


def test_generate_batch_mixed_images_and_reuse(medusa):
    """Image and text prompts in one batch equal their solo runs; a second
    batch of the same size on the kept state equals the first."""
    _, tgen, _, tlp = medusa
    feats = _feats(tlp)
    prompts = [_ids(20, 9, image=True), _ids(21, 30), _ids(22, 14, True)]
    fl = [feats, None, feats * 0.5]
    solos = [tgen.generate(p, f, MAX_NEW) for p, f in zip(prompts, fl)]
    first = tgen.generate_batch(prompts, fl, MAX_NEW)
    tgen.generate_batch([_ids(23, 40)] * 3, None, MAX_NEW)
    again = tgen.generate_batch(prompts, fl, MAX_NEW)
    assert sorted(tgen.lane_states) == [1, 4]     # 3 lanes padded to 4
    assert tgen.lane_states[1] is tgen.bstate
    for s, a, b in zip(solos, first, again):
        _same(a, s)
        _same(b, s)


def test_sampled_lanes_reproduce_their_seeds(eagle):
    """Lane b of a sampled batch draws from seed + b: it reproduces
    generate(seed=seed + b); another seed gives other tokens."""
    _, tgen, _, _ = eagle
    sp = TSP(temperature=2.0)
    prompts = [_ids(30, 8), _ids(31, 17)]
    batch = tgen.generate_batch(prompts, max_new_tokens=MAX_NEW, seed=5,
                                sp=sp)
    for b, (p, r) in enumerate(zip(prompts, batch)):
        _same(r, tgen.generate(p, max_new_tokens=MAX_NEW, seed=5 + b, sp=sp))
    other = tgen.generate_batch(prompts, max_new_tokens=MAX_NEW, seed=9,
                                sp=sp)
    assert any(not np.array_equal(a.tokens, b.tokens)
               for a, b in zip(batch, other))


def test_inactive_lane_is_left_unchanged(medusa):
    """A step over two lanes, one of them out of the segment (stop_at 0):
    the inactive lane's committed state (ids, lengths, counters, bonus,
    suffix, committed KV rows) is bitwise what it was; the other lane
    steps."""
    _, tgen, _, _ = medusa
    st = tgen._statics(MAX_NEW)
    state = tgen.alloc_lanes(2)
    for b, ids in enumerate((_ids(63, 21), _ids(66, 24))):
        _, padded, img_pos = tgen._prompt(ids)
        SE.prefill(st, tgen.params, SE.lane(state, b), padded, len(ids),
                   None, img_pos)
    SE.decode_step(st, tgen.params, state)    # both lanes, one step
    lane1 = SE.lane(state, 1)
    before = SE.EngineState(*(
        {k: v.clone() for k, v in x.items()} if isinstance(x, dict)
        else x.clone() for x in lane1))
    e = int(lane1.cur_len)
    state.stop_at[1] = 0
    SE.decode_step(st, tgen.params, state)
    for name in ("ids", "cur_len", "bonus", "suffix_tokens", "suffix_hidden",
                 "suffix_len", "last_draft_hidden", "draft_len", "max_new",
                 "new_tokens", "steps", "acc_sum", "alpha_hist", "done",
                 "img_pos", "attn_feat"):
        assert torch.equal(getattr(lane1, name), getattr(before, name)), name
    for key in ("k", "v"):
        assert torch.equal(lane1.target_kv[key][:, :e],
                           before.target_kv[key][:, :e])
        d = int(lane1.draft_len)
        assert torch.equal(lane1.draft_kv[key][:, :d],
                           before.draft_kv[key][:, :d])
    assert int(SE.lane(state, 0).steps) == 2 and int(lane1.steps) == 1
    assert state.live.tolist() == [True, False]


def test_batches_keep_power_of_two_lane_states(medusa):
    """Batches of 1..8 prompts run on states of 1, 2, 4 and 8 lanes (the
    pad lanes out of every step), so only those states are kept; a padded
    batch of 3 commits, lane for lane, the tokens of the unpadded batch of
    4 that holds the same 3 prompts and of their solo runs."""
    _, tgen, _, _ = medusa
    prompts = [_ids(80 + i, 9 + 3 * i) for i in range(8)]
    runs = {B: tgen.generate_batch(prompts[:B], max_new_tokens=8)
            for B in range(1, 9)}
    assert sorted(tgen.lane_states) == [1, 2, 4, 8]
    assert tgen.lane_states[1] is tgen.bstate
    assert tgen.lane_states[4].ids.shape[0] == 4
    for b in range(3):
        _same(runs[3][b], runs[4][b])
        _same(runs[3][b], tgen.generate(prompts[b], max_new_tokens=8))
    for B in (5, 6, 7):
        for b in range(B):
            _same(runs[B][b], runs[8][b])


def test_per_lane_products_keep_solo_tokens(medusa, monkeypatch):
    """The batched verify's per-lane route (``Statics.per_lane``): a
    generator told that every target product rounds otherwise over B
    lanes, as ``llama.lane_variant`` finds some do on the card, computes
    each one lane at a time; its lanes commit, lane for lane, the tokens of
    the batch with every product over all lanes' rows and of their solo
    runs, image and text. On the CPU no product needs the route."""
    from msd_tpu_torch.models import llama as TL

    _, tgen, _, tlp = medusa
    tp = tgen.params["target"]
    rows = tgen.eng.tree.num_nodes
    assert TL.lane_variant(tp, 1, rows) == frozenset()
    assert TL.lane_variant(tp, 4, rows) == frozenset()
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, rows, H)).astype(np.float32))
    assert torch.equal(TL._proj(tp, "lm_head", x),
                       TL._proj(tp, "lm_head", x, frozenset({"lm_head"})))
    every = frozenset(TL._STACKED + ("lm_head",))
    monkeypatch.setattr(TL, "lane_variant", lambda *a: every)
    gen = TGen(tp, tgen.params["draft"], tgen.tcfg, tgen.dcfg, tgen.eng,
               n_img=tgen.n_img, eos_id=2, sp=tgen.sp, device="cpu")
    feats = _feats(tlp)
    prompts = [_ids(90 + i, 10 + 2 * i, image=i % 2 == 0) for i in range(3)]
    fs = [feats if i % 2 == 0 else None for i in range(3)]
    mine = gen.generate_batch(prompts, fs, max_new_tokens=10)
    assert gen._statics(10, lanes=4).per_lane == every
    plain = tgen.generate_batch(prompts, fs, max_new_tokens=10)
    assert tgen._statics(10, lanes=4).per_lane == frozenset()
    for b in range(3):
        _same(mine[b], plain[b])
        _same(mine[b], gen.generate(prompts[b], fs[b], max_new_tokens=10))


def test_micro_batched_requests_keep_their_seeds(served):
    """Two sampled /generate requests with seeds 5 and 9, queued together
    so the micro-batching worker serves them as the lanes of one batch:
    each answer equals the request's solo answer."""
    adapter, _ = served
    payloads = [{"prompt": "count to ten", "max_new_tokens": 12,
                 "temperature": 8.0, "seed": s} for s in (5, 9)]
    worker = TServer.EngineWorker(adapter)
    works = [TServer._Work(p) for p in payloads]
    for w in works:
        worker.q.put(w)
    worker.start()
    try:
        for w in works:
            assert w.done.wait(timeout=120) and w.error is None, w.error
        assert worker.batches == 1
        assert [w.result["batch_size"] for w in works] == [2, 2]
        solo = [worker._handle(p) for p in payloads]
    finally:
        worker.stop()
        worker.join(timeout=60)
    for w, s in zip(works, solo):
        assert w.result["text"] == s["text"]
        assert w.result["tokens_generated"] == s["tokens_generated"]
    assert solo[0]["text"] != solo[1]["text"]


# ---------------------------------------------------------------------------
# continuous batching
# ---------------------------------------------------------------------------

def test_queued_requests_match_single_runs_and_jax(eagle):
    """5 requests through 2 slots (queueing and mid-flight rejoin),
    different prompt lengths and max_new: each equals its solo run and the
    JAX scheduler's tokens for the same schedule."""
    jgen, tgen, _, _ = eagle

    def reqs(cls):
        return [cls(ids=_ids(50 + i, 9 + 7 * i), max_new=16 + 8 * (i % 3),
                    seed=i) for i in range(5)]

    mine, theirs = reqs(Request), reqs(JCont.Request)
    for sched, rs in ((ContinuousScheduler(tgen, n_slots=2, segment=8),
                       mine),
                      (JCont.ContinuousScheduler(jgen, n_slots=2, segment=8),
                       theirs)):
        for r in rs:
            sched.submit(r)
        assert len(sched.run_all()) == 5 and sched.joined == 5
    for r, j in zip(mine, theirs):
        _same_tokens(r, tgen)
        np.testing.assert_array_equal(r.tokens, j.tokens)
        assert (r.accept_steps, r.accept_len_sum, r.segments) == \
            (j.accept_steps, j.accept_len_sum, j.segments)


def test_staggered_join_does_not_perturb_running_slot(medusa):
    _, tgen, _, _ = medusa
    r1 = Request(ids=_ids(70, 11), max_new=40, seed=1)
    sched = ContinuousScheduler(tgen, n_slots=2, segment=6)
    sched.submit(r1)
    fin = sched.step() + sched.step()
    r2 = Request(ids=_ids(62, 20), max_new=18, seed=2)
    sched.submit(r2)            # joins while r1 is mid-generation
    while sched.busy:
        fin += sched.step()
    assert {id(r) for r in fin} == {id(r1), id(r2)}
    for r in (r1, r2):
        _same_tokens(r, tgen)


def test_bad_request_does_not_kill_the_batch(medusa):
    _, tgen, _, _ = medusa
    good1 = Request(ids=_ids(54, 12), max_new=20)
    bad = Request(ids=_ids(71, 300), max_new=20)   # > engine budget
    good2 = Request(ids=_ids(57, 15), max_new=16)
    sched = ContinuousScheduler(tgen, n_slots=2, segment=8)
    for r in (good1, bad, good2):
        sched.submit(r)
    assert len(sched.run_all()) == 3
    assert bad.error is not None and "prompt too long" in bad.error
    for r in (good1, good2):
        assert r.error is None
        _same_tokens(r, tgen)


def test_mixed_image_and_text_slots_stream(medusa):
    """Image and text requests share the slots; each equals its solo run,
    and a streamed slot's chunks concatenate to its tokens."""
    _, tgen, _, tlp = medusa
    feats = _feats(tlp)
    chunks = []
    r_img = Request(ids=_ids(63, 21, image=True), img_feats=feats,
                    max_new=20, on_tokens=lambda t: chunks.append(t))
    r_txt = Request(ids=_ids(87, 11), max_new=28)
    r_img2 = Request(ids=_ids(107, 14, image=True), img_feats=feats,
                     max_new=12)
    sched = ContinuousScheduler(tgen, n_slots=2, segment=5)
    for r in (r_img, r_txt, r_img2):
        sched.submit(r)
    sched.run_all()
    for r in (r_img, r_txt, r_img2):
        _same_tokens(r, tgen)
    assert len(chunks) >= 2
    np.testing.assert_array_equal(np.concatenate(chunks), r_img.tokens)


def test_calibrated_scheduler_equals_calibrated_solo(eagle):
    _, tgen, _, _ = eagle
    tgen.set_calibrator(TCD.CalibTables.from_host(
        _export(np.random.default_rng(0)), np.zeros(V, np.int8), 4.0,
        device="cpu"))
    try:
        rs = [Request(ids=_ids(90 + i, 10 + 5 * i), max_new=20)
              for i in range(3)]
        sched = ContinuousScheduler(tgen, n_slots=2, segment=8,
                                    use_calibration=True)
        for r in rs:
            sched.submit(r)
        sched.run_all()
        for r in rs:
            _same_tokens(r, tgen, use_calibration=True)
    finally:
        del tgen.params["calib"]


def test_sampled_slots_reproduce_their_seeds(eagle):
    _, tgen, _, _ = eagle
    sp = TSP(temperature=2.0)
    rs = [Request(ids=_ids(100 + i, 11), max_new=20, seed=40 + i)
          for i in range(3)]
    sched = ContinuousScheduler(tgen, n_slots=2, segment=4, sp=sp)
    for r in rs:
        sched.submit(r)
    sched.run_all()
    for r in rs:
        _same_tokens(r, tgen, sp=sp)


def test_chat_once_streams_the_reply(medusa):
    _, tgen, _, _ = medusa
    adapter = ServeAdapter(tgen, SimpleTokenizer(V))
    conv, out = vicuna_v1(), io.StringIO()
    reply = cli.chat_once(adapter, conv, "hello there", None, tgen.sp, 16,
                          out=out)
    assert out.getvalue().strip() == reply
    assert conv.messages[-1] == (conv.roles[1], reply)


# ---------------------------------------------------------------------------
# the HTTP front end
# ---------------------------------------------------------------------------

def _png_b64(seed=0, shape=(30, 22)):
    from PIL import Image
    img = np.random.default_rng(seed).integers(0, 256, size=shape + (3,),
                                               dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(port, path, payload, timeout=120):
    rq = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(rq, timeout=timeout) as r:
        if path == "/generate_stream":
            return [json.loads(line) for line in r]
        return json.loads(r.read())


def _serve(adapter, **kw):
    httpd = TServer.serve_forever(adapter, port=0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, httpd.server_address[1]


@pytest.fixture(scope="module")
def served():
    """The server's stack (default sampling parameters, as the JAX
    server's requests carry) and the JAX server's answers to the text and
    image requests."""
    jgen, tgen, jlp, tlp = _stack(MEDUSA, medusa_heads=4)
    jl, tl = _lcfgs()
    enc = jax.jit(lambda px: JV.encode_image(jlp, jl, px))
    jadapter = LlavaMSD(jgen, JTok(V), enc, image_size=28)
    adapter = ServeAdapter.from_llava(tgen, SimpleTokenizer(V), tlp, tl)
    texts = {}
    httpd = JServer.serve_forever(jadapter, port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        for name, payload in REQUESTS.items():
            texts[name] = _post(port, "/generate", payload, 300)["text"]
    finally:
        httpd.shutdown()
        httpd.server_close()
    return adapter, texts


REQUESTS = {
    "text": {"prompt": "count to ten", "max_new_tokens": 12},
    "image": {"prompt": "what is this?", "image_b64": _png_b64(),
              "max_new_tokens": 10},
}


@pytest.mark.parametrize("continuous", [0, 2])
def test_http_server_matches_solo_and_jax(served, continuous):
    """Micro-batch (0) and continuous (2 slots) mode: concurrent /generate
    text requests (batched or sharing slots), an image_b64 request, a
    stream, a use_msd=false request and /health. Every text equals a
    second solo request's, and the text and image answers equal the JAX
    server's for the same weights and tokenizer."""
    adapter, jtexts = served
    httpd, port = _serve(adapter, continuous=continuous, segment=4)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok"
        assert ("n_slots" in health) == bool(continuous)
        outs = [None] * 4
        payloads = [REQUESTS["text"]] * 3 + [REQUESTS["image"]]

        def hit(i):
            outs[i] = _post(port, "/generate", payloads[i])

        threads = [threading.Thread(target=hit, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(o is not None for o in outs)
        for name, out in (("text", outs[0]), ("image", outs[3])):
            solo = _post(port, "/generate", REQUESTS[name])
            assert out["text"] == solo["text"] == jtexts[name], name
            assert out["tokens_generated"] > 0
        assert outs[1]["text"] == outs[2]["text"] == outs[0]["text"]
        lines = _post(port, "/generate_stream",
                      dict(REQUESTS["text"], segment=3))
        assert lines[-1].get("done") is True
        assert "".join(x["text"] for x in lines[:-1]).strip() == \
            jtexts["text"]
        ar = _post(port, "/generate", dict(REQUESTS["image"], use_msd=False))
        assert ar["text"] == jtexts["image"]     # greedy MSD == greedy AR
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/generate", {})
        assert e.value.code == 400
    finally:
        TServer.shutdown(httpd)


def test_http_server_refuses_images_without_an_encoder(served):
    adapter, _ = served
    httpd, port = _serve(dataclasses.replace(adapter, encode_image_fn=None))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, "/generate", REQUESTS["image"])
        assert e.value.code == 500
        assert "no vision encoder" in json.loads(e.value.read())["error"]
        assert _post(port, "/generate", REQUESTS["text"])["text"]
    finally:
        TServer.shutdown(httpd)


SMOKE_CFG = dataclasses.replace(
    TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2, heads=2,
                        intermediate_size=512, max_pos=2048),
    residual_dtype="float32")


@pytest.fixture(scope="module")
def smoke_serve():
    """chip_smoke's main path and [serve] phase on the CPU at a tiny
    width (a tiny CLIP tower whose 56-pixel images give the main path's
    16 rows, with CLIP's 64-dim heads, which a checkpoint's loader
    assumes)."""
    import chip_smoke

    res = chip_smoke.run_main_path(SMOKE_CFG, (4, 3, 2, 2, 1), 384, 24, 16,
                                   20, device="cpu", dtype=torch.float32)
    out = chip_smoke.run_serve(res, vision=TC.ClipVisionConfig.tiny(
        hidden_size=128, layers=2, heads=2, image_size=56, patch_size=14,
        intermediate_size=256), http_new=12)
    return res, out


def test_smoke_serve_phase_at_tiny_size(smoke_serve):
    """chip_smoke.run_serve on the CPU at a tiny width, after its main
    path: a tiny CLIP tower, generate_batch at B = 1, 2, 3, 4, 8 over image
    prompts and at B = 2, 3, 4, 8 over text prompts (each lane == its
    null-draft tokens, graph == eager and == its solo run; B = 3 on 4
    lanes), the continuous schedule (== null-draft and == solo), the
    stream and the HTTP server in continuous mode (each text == its solo
    repeat); the phase raises otherwise."""
    _, out = smoke_serve
    assert sorted(out["batch"]) == [1, 2, 3, 4, 8]
    assert [out["batch"][b]["lanes"] for b in (1, 2, 3, 4, 8)] == \
        [1, 2, 4, 4, 8]
    assert all(all(v["solo"]) for v in out["batch"].values())
    assert all(v["per_lane"] == [] for v in out["batch"].values())
    assert sorted(out["text_batch"]) == [2, 3, 4, 8]
    assert all(all(v) for v in out["text_batch"].values())
    assert out["continuous"]["joins"] == 8 and all(out["continuous"]["solo"])
    assert out["serve_launches"] == 0     # CPU tensors take the plain twin


def test_smoke_weights_and_quant_phases_at_tiny_size(smoke_serve):
    """chip_smoke's [weights], [quant] and [13b] phases on the CPU at a
    tiny width: the checkpoint written, read back bitwise and served by
    server.main's server equal to the weights in memory; int8 and int4
    targets and an int8 draft lossless, graph == eager, the oracle at full
    depth; the 13B phase's path on a tiny int8 target.
    Each phase raises otherwise."""
    import chip_smoke

    res, serve = smoke_serve
    weights = chip_smoke.run_weights(res, serve, http_new=12)
    assert all(weights["same"].values()) and weights["launches"] == 0
    quant = chip_smoke.run_quant(res)
    assert {k for k in quant if k != "seconds"} == {
        "int8 target", "int4 target", "int8 draft"}
    big = chip_smoke.run_13b(max_new=12, device="cpu", prompt_tokens=20,
                             n_img=16, widths=(4, 3, 2, 2, 1), max_seq=384,
                             cfg=SMOKE_CFG)
    assert big["launches"] == 0
