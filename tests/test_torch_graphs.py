"""The port's static engine state and its CUDA-graph steps
(msd_tpu_torch.engine.{spec_engine,graphs,generator}).

On the CPU: the verify step (greedy, calibrated, collecting, sampled) and
the AR token (greedy, sampled) issue no host sync and no host-to-device
copy (what a CUDA-graph capture needs; a breach fails here before it fails
a capture on the card), every buffer of the static state keeps its address
across steps and requests, a request on a used generator equals the same
request on a fresh one, and new calibration tables change the graph key.
On the card (marked ``cuda``, skipped here): graph-replayed tokens equal
eager tokens and the null-draft tokens, K1's launch count holds under
replay, a draft or calibrator swap captures a graph of its own, sampled
requests replay to the eager tokens of their seed, and a step that syncs
fails its capture.

Imports no JAX, so the card's machine runs it with ``--noconftest``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from msd_tpu_torch import configs as TC
from msd_tpu_torch.calib.device import CalibTables
from msd_tpu_torch.engine import graphs as graphs_mod
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import draft as D
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops import decode_attention as K1
from msd_tpu_torch.ops.sampling import SamplingParams

WIDTHS = (4, 3, 2, 2, 1, 1)
N_IMG = 8
MAX_NEW = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One CPU thread for torch in a module's tests (the port's test
    modules import this fixture): the suite runs in several worker
    processes on shared cores, and a full torch thread pool in each
    oversubscribes them, so the small ops of these tests spin instead of
    running."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class HostSync(RuntimeError):
    pass


def _refuse(what):
    def refuse(*args, **kwargs):
        raise HostSync(f"{what} inside a step")
    return refuse


# every way a step could wait for the device or upload host data
GUARDED = [(torch.Tensor, "__bool__"), (torch.Tensor, "item"),
           (torch.Tensor, "tolist"), (torch.Tensor, "numpy"),
           (torch.Tensor, "cpu"), (torch, "from_numpy"),
           (torch, "as_tensor"), (torch, "tensor")]


@contextlib.contextmanager
def no_host_sync():
    """Within the block, reading a tensor on the host and making a tensor
    from host data raise."""
    with pytest.MonkeyPatch.context() as mp:
        for owner, name in GUARDED:
            mp.setattr(owner, name, _refuse(f"{owner.__name__}.{name}"))
        yield


def _bundle(device="cpu", dtype=torch.float32, hidden=64, heads=4,
            cuda_graphs=True):
    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=128, hidden_size=hidden, layers=2,
                            heads=heads, intermediate_size=2 * hidden),
        residual_dtype="float32")
    dcfg = TC.DraftConfig(text=cfg, medusa_heads=len(WIDTHS) - 1)
    gen_t = torch.Generator(device=device).manual_seed(0)
    tp = L.init_llama_params(cfg, gen_t, device, dtype)
    tp["lm_head"].mul_(3.0)

    def draft(seed):
        g = torch.Generator(device=device).manual_seed(seed)
        dp = D.init_draft_params(dcfg, g, device, dtype)
        dp["medusa"] = D.init_medusa_params(dcfg, g, device, dtype)
        dp["embed_tokens"] = tp["embed_tokens"]
        return dp

    drafts = {"msd": draft(1), "null": draft(2)}
    tree = TC.TreeConfig(top_k=WIDTHS[0], max_depth=len(WIDTHS),
                         num_nodes=1 + sum(WIDTHS), medusa_widths=WIDTHS)
    eng = TC.EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                          tree=tree)

    def generator(graphs=cuda_graphs):
        return MSDGenerator(tp, drafts["msd"], cfg, dcfg, eng, n_img=N_IMG,
                            eos_id=-1, sp=SamplingParams(greedy_round_bits=6),
                            device=device, cuda_graphs=graphs)

    return generator, drafts, cfg


def _prompts(cfg, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(0)
    image = rng.integers(3, cfg.vocab_size - 1, size=13).astype(np.int32)
    image[1] = TC.IMAGE_TOKEN_INDEX
    long_text = rng.integers(3, cfg.vocab_size - 1, size=40).astype(np.int32)
    feats = torch.from_numpy(rng.normal(size=(N_IMG, cfg.hidden_size))
                             * 0.1).to(device=device, dtype=dtype)
    return {"image": (image, feats), "long_text": (long_text, None),
            "short_text": (long_text[:7].copy(), None)}


def _same(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.accept_steps, a.accept_len_sum) == \
        (b.accept_steps, b.accept_len_sum)
    if a.alpha_hist is not None or b.alpha_hist is not None:
        np.testing.assert_array_equal(a.alpha_hist, b.alpha_hist)


@pytest.mark.parametrize("owner,name", GUARDED,
                         ids=[f"{o.__name__}.{n}" for o, n in GUARDED])
def test_guard_refuses_each_host_read(owner, name):
    x = torch.zeros(3)
    calls = {"__bool__": lambda: bool(x[0]), "item": lambda: x[0].item(),
             "tolist": lambda: x.tolist(), "numpy": lambda: x.numpy(),
             "cpu": lambda: x.cpu(),
             "from_numpy": lambda: torch.from_numpy(np.zeros(2)),
             "as_tensor": lambda: torch.as_tensor([1, 2]),
             "tensor": lambda: torch.tensor(1)}
    with no_host_sync(), pytest.raises(HostSync):
        calls[name]()
    calls[name]()   # restored on leaving the block


@pytest.mark.parametrize("step", ["decode_step", "ar_step"])
def test_steps_issue_no_host_sync_or_upload(step):
    """Three steps under the guard; first-use uploads (the medusa layout)
    happen in an earlier request, as the warm-up before a capture does
    them."""
    generator, _, cfg = _bundle()
    gen = generator()
    assert gen.graphs is None   # CPU tensors run eagerly
    ids, feats = _prompts(cfg)["image"]
    gen.generate(ids, feats, MAX_NEW)
    st = gen._statics(MAX_NEW)
    _, padded, img_pos = gen._prompt(ids)
    s = gen.state
    if step == "decode_step":
        SE.prefill(st, gen.params, s, padded, len(ids), feats, img_pos)
    else:
        SE.ar_prefill(st, gen.params, s, padded, len(ids), feats, img_pos)
    e0 = int(s.cur_len)
    with no_host_sync():
        for _ in range(3):
            getattr(SE, step)(st, gen.params, s)
    if step == "decode_step":
        assert int(s.steps) == 3 and int(s.cur_len) == e0 + int(s.acc_sum)
    else:
        assert int(s.cur_len) == e0 + 3


def test_state_buffers_keep_their_addresses():
    generator, _, cfg = _bundle()
    gen = generator()
    prompts = _prompts(cfg)
    state = gen.state
    ptrs = [x.data_ptr() for x in SE.state_tensors(state)]
    ids, feats = prompts["image"]
    gen.generate(ids, feats, MAX_NEW)
    st = gen._statics(MAX_NEW)
    for _ in range(2):
        SE.decode_step(st, gen.params, state)
        SE.ar_step(st, gen.params, state)
    gen.naive_generate(ids, feats, MAX_NEW, share_prefill=True)
    gen.naive_generate(*prompts["long_text"], MAX_NEW)
    gen.first_token(*prompts["short_text"])
    gen.generate(*prompts["short_text"], MAX_NEW)
    assert gen.state is state
    assert [x.data_ptr() for x in SE.state_tensors(state)] == ptrs


@pytest.mark.parametrize("first,second", [("long_text", "image"),
                                          ("long_text", "short_text"),
                                          ("image", "short_text")])
def test_request_after_request_equals_fresh_generator(first, second):
    """MSD and both AR baselines on a used generator equal the same
    requests on a fresh one (no stale KV row, id or counter leaks from
    the earlier request), and an earlier result is not changed by a later
    request."""
    generator, _, cfg = _bundle()
    prompts = _prompts(cfg)
    used, fresh = generator(), generator()
    runs = [lambda g, p: g.generate(*p, MAX_NEW),
            lambda g, p: g.naive_generate(*p, MAX_NEW, share_prefill=True),
            lambda g, p: g.naive_generate(*p, MAX_NEW)]
    for run in runs:
        before = run(used, prompts[first])
        kept = before.tokens.copy()
        _same(run(used, prompts[second]), run(fresh, prompts[second]))
        np.testing.assert_array_equal(before.tokens, kept)
    assert used.first_token(*prompts[second]) == \
        fresh.first_token(*prompts[second])


SAMPLED = SamplingParams(temperature=1.0, top_p=0.9, top_k=20,
                         greedy_round_bits=6)
# (step, statics options) of every step program the engine captures
STEP_KINDS = {"decode_step": dict(), "ar_step": dict(),
              "calibrated": dict(use_calibration=True),
              "collecting": dict(collect_calibration=True),
              "calibrated_collecting": dict(use_calibration=True,
                                            collect_calibration=True),
              "sampled": dict(sp=SAMPLED), "sampled_ar_step": dict(sp=SAMPLED)}


def _tables(vocab, device="cpu", base_alpha=4.0, seed=0):
    """Calibration tables with a random monotone table and a random
    token-class table."""
    rng = np.random.default_rng(seed)
    table = np.sort(rng.uniform(1e-3, 1 - 1e-3, (3, 5, 2, 3, 16)), axis=-1)
    export = {"table": table, "attn_quantiles": [0.002, 0.004, 0.006, 0.01],
              "margin_quantiles": [0.001, 0.01], "global_mean": 0.5}
    return CalibTables.from_host(export, rng.integers(0, 3, vocab),
                                 base_alpha, device)


@pytest.mark.parametrize("kind", list(STEP_KINDS)[2:])
def test_calibrated_collecting_and_sampled_steps_issue_no_host_sync(kind):
    """The calibrated, collecting and sampled verify steps and the sampled
    AR token under the guard, three steps each, with the step's draws
    drawn outside it as the decode loop draws them."""
    generator, _, cfg = _bundle()
    gen = generator()
    gen.set_calibrator(_tables(cfg.vocab_size))
    ids, feats = _prompts(cfg)["image"]
    opts = dict(STEP_KINDS[kind])
    ar = kind.endswith("ar_step")
    sp = opts.pop("sp", None)
    if ar:
        gen.naive_generate(ids, feats, MAX_NEW, sp=sp, share_prefill=True)
    else:
        gen.generate(ids, feats, MAX_NEW, sp=sp, **opts)
    st = gen._statics(MAX_NEW, sp, **opts)
    _, padded, img_pos = gen._prompt(ids)
    s = gen.state
    SE.prefill(st, gen.params, s, padded, len(ids), feats, img_pos,
               rng=gen.rng)
    e0 = int(s.cur_len)
    for _ in range(3):
        if sp is not None:
            SE.draw(s, gen.rng)
        with no_host_sync():
            (SE.ar_step if ar else SE.decode_step)(st, gen.params, s)
    if ar:
        assert int(s.cur_len) == e0 + 3
        return
    assert int(s.steps) == 3 and int(s.cur_len) == e0 + int(s.acc_sum)
    if st.collect_calibration:
        log = {k: v[:3].numpy() for k, v in s.calib_log.items()}
        assert (log["valid"].sum(axis=1) == sum(WIDTHS)).all()
        assert (log["depth"][:, 1:] > 0).all() and (log["attn"] > 0).any()
        assert not s.calib_log["valid"][3:].any()


def test_state_keeps_its_addresses_over_calibrated_and_sampled_requests():
    """calib_log, attn_feat, the draws buffer and every other buffer keep
    their data_ptr over collecting, calibrated and sampled requests, MSD
    and AR."""
    generator, _, cfg = _bundle()
    gen = generator()
    gen.set_calibrator(_tables(cfg.vocab_size))
    state = gen.state
    ptrs = [x.data_ptr() for x in SE.state_tensors(state)]
    prompts = _prompts(cfg)
    ids, feats = prompts["image"]
    r = gen.generate(ids, feats, MAX_NEW, use_calibration=True,
                     collect_calibration=True)
    assert r.calib_data["token"].shape == (r.accept_steps, 1 + sum(WIDTHS))
    gen.generate(*prompts["short_text"], MAX_NEW, sp=SAMPLED, seed=3)
    gen.naive_generate(ids, feats, MAX_NEW, sp=SAMPLED, seed=4)
    gen.generate(ids, feats, MAX_NEW, sp=SAMPLED, use_calibration=True)
    assert gen.state is state
    assert [x.data_ptr() for x in SE.state_tensors(state)] == ptrs
    assert r.calib_data["token"].shape == (r.accept_steps, 1 + sum(WIDTHS))


def test_new_calibration_tables_change_the_graph_key():
    """A graph captured over one calibrator's tables is never replayed
    over another's: the key of a reranking step covers the tables'
    tensors; the steps that do not rerank keep their key."""
    generator, _, cfg = _bundle()
    gen = generator()
    cal, plain = gen._statics(MAX_NEW, use_calibration=True), \
        gen._statics(MAX_NEW, collect_calibration=True)

    def key(st):
        return graphs_mod.weights_key(SE.step_params(st, gen.params))

    keys, plain_keys = [key(cal)], [key(plain)]
    for seed in (0, 1):
        gen.set_calibrator(_tables(cfg.vocab_size, seed=seed))
        keys.append(key(cal))
        plain_keys.append(key(plain))
    assert len(set(keys)) == 3 and len(set(plain_keys)) == 1
    calib = gen.params["calib"]
    assert len(keys[2]) == len(keys[0]) + len(calib)
    assert {t.data_ptr() for t in calib} <= {k[0] for k in keys[2]}


class _EagerGraph:
    """Stands in for a captured CUDA graph on the CPU: a replay runs the
    step eagerly over what the capture was given."""

    def __init__(self, fn, st, params, state):
        self.replay = lambda: fn(st, params, state)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """A factory of generators whose StepGraphs run on the CPU: the cache,
    its keys and ``drop`` as on the card, each capture an eager stand-in."""

    def capture(self, fn, st, params, state, key):
        step = graphs_mod.CapturedStep(len(self.steps),
                                       _EagerGraph(fn, st, params, state),
                                       key, graphs_mod.leaves(params), 0)
        self.steps.append(step)
        return step

    monkeypatch.setattr(graphs_mod.StepGraphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)

    def make():
        generator, drafts, cfg = _bundle()
        gen = generator()
        gen.graphs = graphs_mod.StepGraphs.__new__(graphs_mod.StepGraphs)
        gen.graphs.device = torch.device("cpu")
        gen.graphs.steps, gen.graphs._cache = [], {}
        return gen, drafts, cfg

    return make


def test_collecting_step_keys_a_graph_of_its_own(cpu_graphs):
    """A verify step that collects hiddens is keyed, captured and replayed
    apart from the one that does not; each request replays its own graph
    again without a capture, and the tokens agree."""
    gen, _, cfg = cpu_graphs()
    ids, feats = _prompts(cfg)["image"]
    plain = gen.generate(ids, feats, MAX_NEW)
    got = gen.generate(ids, feats, MAX_NEW, collect_hiddens=True)
    assert {plain.graph, got.graph} == {0, 1}
    again = (gen.generate(ids, feats, MAX_NEW),
             gen.generate(ids, feats, MAX_NEW, collect_hiddens=True))
    assert (again[0].graph, again[1].graph) == (plain.graph, got.graph)
    assert len(gen.graphs.steps) == 2
    _same(plain, got)
    _same(again[0], plain)
    assert got.traj_hidden.shape[0] == len(ids) + N_IMG - 1 + \
        got.accept_len_sum


def test_set_draft_releases_every_graph_of_the_old_draft(cpu_graphs):
    """After set_draft no cached graph holds a tensor of the old draft
    (the shared embedding aside), the old captures read nothing any more,
    the next request captures over the new draft, and its tokens equal a
    fresh generator's with that draft."""
    gen, drafts, cfg = cpu_graphs()
    ids, feats = _prompts(cfg)["image"]
    old = gen.params["draft"]
    first = [gen.generate(ids, feats, MAX_NEW),
             gen.naive_generate(ids, feats, MAX_NEW, share_prefill=True)]
    gen.set_draft(drafts["null"])
    only_old = {t.data_ptr() for t in graphs_mod.leaves(old)} - \
        {t.data_ptr() for t in graphs_mod.leaves(gen.params)}
    assert only_old
    assert not any(t.data_ptr() in only_old
                   for step in gen.graphs._cache.values()
                   for t in step.weights)
    assert all(gen.graphs.steps[r.graph] is None for r in first)
    assert not gen.graphs.reads(first[0].graph, gen.params)
    r = gen.generate(ids, feats, MAX_NEW)
    assert r.graph == 2 and gen.graphs.reads(r.graph, gen.params)
    generator, _, _ = _bundle()
    fresh = generator()
    fresh.params["draft"] = drafts["null"]
    _same(r, fresh.generate(ids, feats, MAX_NEW))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("CUDA graphs and the decode-attention kernel need an "
                    "NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_tokens_equal_eager_and_null_draft_on_card(cuda_device):
    """Tiny bf16 model with head_dim 128 (the AR row goes to K1): graph
    MSD == eager MSD == graph null-draft MSD, graph AR == eager AR, K1
    launches = layers x AR tokens decoded under replay, one graph per draft
    and none captured again by a later request."""
    generator, drafts, cfg = _bundle(cuda_device, torch.bfloat16,
                                     hidden=256, heads=2)
    graph, eager = generator(), generator(False)
    assert eager.graphs is None
    ids, feats = _prompts(cfg, cuda_device, torch.bfloat16)["image"]
    out = {}
    for name in ("msd", "null"):
        for mode, gen in (("graph", graph), ("eager", eager)):
            gen.params["draft"] = drafts[name]
            out[mode, name] = gen.generate(ids, feats, MAX_NEW)
        assert graph.graphs.reads(out["graph", name].graph, graph.params)
    assert out["graph", "msd"].graph != out["graph", "null"].graph
    for name in ("msd", "null"):
        _same(out["graph", name], out["eager", name])
        np.testing.assert_array_equal(out["graph", name].tokens,
                                      out["graph", "null"].tokens)
    n_steps = len(graph.graphs.steps)
    n_layers = cfg.num_hidden_layers
    # the first AR request captures its graph: the warm-up steps before
    # the capture launch K1 eagerly, the capture launches nothing, each
    # replay launches the calls the graph holds
    for warmup in (graphs_mod.WARMUP_STEPS, 0):
        K1.decode_attention.launches = 0
        ar = graph.naive_generate(ids, feats, MAX_NEW, share_prefill=True)
        assert K1.decode_attention.launches == \
            n_layers * (len(ar.tokens) - 1 + warmup)
    assert graph.graphs.steps[ar.graph].k1_calls == n_layers
    _same(ar, eager.naive_generate(ids, feats, MAX_NEW, share_prefill=True))
    graph.params["draft"] = drafts["null"]
    again = graph.generate(ids, feats, MAX_NEW)
    _same(again, out["graph", "null"])
    assert len(graph.graphs.steps) == n_steps + 1   # only the AR capture


@pytest.mark.cuda
def test_capture_of_a_syncing_step_raises(cuda_device):
    generator, _, cfg = _bundle(cuda_device, torch.bfloat16, hidden=256,
                                heads=2)
    gen = generator()
    st = gen._statics(MAX_NEW)

    def syncing_step(st, params, state):
        SE.decode_step(st, params, state)
        if bool(state.done):
            state.steps.add_(1)

    with pytest.raises(RuntimeError):
        gen.graphs.get(syncing_step, st, gen.params, gen.state)


@pytest.mark.cuda
def test_sampled_and_calibrated_graphs_on_card(cuda_device):
    """Tiny bf16 model: sampled MSD and sampled AR replayed as graphs give
    the eager tokens of the same seed, the same seed twice under replay
    gives the same tokens and another seed others; calibrated MSD under
    replay equals eager and the null-draft tokens, a second calibrator
    captures a graph of its own that reads its tables, and a step that
    does not rerank replays its graph from before the tables."""
    generator, drafts, cfg = _bundle(cuda_device, torch.bfloat16,
                                     hidden=256, heads=2)
    graph, eager = generator(), generator(False)
    ids, feats = _prompts(cfg, cuda_device, torch.bfloat16)["image"]
    for name, run in (
            ("msd", lambda g, seed: g.generate(ids, feats, MAX_NEW,
                                               seed=seed, sp=SAMPLED)),
            ("ar", lambda g, seed: g.naive_generate(
                ids, feats, MAX_NEW, seed=seed, sp=SAMPLED,
                share_prefill=True))):
        a, b, c = run(graph, 7), run(graph, 7), run(graph, 8)
        assert a.graph is not None and a.graph == b.graph
        _same(a, b)
        _same(a, run(eager, 7))
        assert not np.array_equal(a.tokens, c.tokens), name
    graph.params["draft"] = eager.params["draft"] = drafts["null"]
    null = graph.generate(ids, feats, MAX_NEW)
    graph.params["draft"] = eager.params["draft"] = drafts["msd"]
    plain = graph.generate(ids, feats, MAX_NEW)
    seen = set()
    for seed in (0, 1):
        tables = _tables(cfg.vocab_size, cuda_device, seed=seed)
        graph.set_calibrator(tables)
        eager.set_calibrator(tables)
        cal = graph.generate(ids, feats, MAX_NEW, use_calibration=True)
        assert graph.graphs.reads(cal.graph, graph.params)
        _same(cal, eager.generate(ids, feats, MAX_NEW, use_calibration=True))
        np.testing.assert_array_equal(cal.tokens, null.tokens)
        seen.add(cal.graph)
    assert len(seen) == 2
    # a step that does not rerank keeps its graph over installed tables
    n_steps = len(graph.graphs.steps)
    again = graph.generate(ids, feats, MAX_NEW)
    assert again.graph == plain.graph
    assert len(graph.graphs.steps) == n_steps
    _same(again, plain)


@pytest.mark.cuda
def test_collecting_and_swapped_draft_graphs_on_card(cuda_device):
    """Tiny bf16 model: a collecting request replays a graph of its own and
    equals the eager collecting request (tokens, expanded ids, hiddens);
    after set_draft the old draft's graphs are released and the new
    draft's replayed tokens equal eager ones and the null-draft tokens."""
    generator, drafts, cfg = _bundle(cuda_device, torch.bfloat16,
                                     hidden=256, heads=2)
    graph, eager = generator(), generator(False)
    ids, feats = _prompts(cfg, cuda_device, torch.bfloat16)["image"]
    plain = graph.generate(ids, feats, MAX_NEW)
    got = graph.generate(ids, feats, MAX_NEW, collect_hiddens=True)
    ref = eager.generate(ids, feats, MAX_NEW, collect_hiddens=True)
    assert got.graph != plain.graph
    _same(got, ref)
    _same(got, plain)
    np.testing.assert_array_equal(got.exp_ids, ref.exp_ids)
    np.testing.assert_array_equal(got.traj_hidden, ref.traj_hidden)
    before = [plain.graph, got.graph]
    for gen in (graph, eager):
        gen.set_draft(drafts["null"])
    assert all(graph.graphs.steps[i] is None for i in before)
    swapped = graph.generate(ids, feats, MAX_NEW)
    assert graph.graphs.reads(swapped.graph, graph.params)
    _same(swapped, eager.generate(ids, feats, MAX_NEW))
    np.testing.assert_array_equal(swapped.tokens, plain.tokens)
