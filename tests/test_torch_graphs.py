"""The port's static engine state and its CUDA-graph steps
(msd_tpu_torch.engine.{spec_engine,graphs,generator}).

On the CPU: the verify step and the AR token issue no host sync and no
host-to-device copy (what a CUDA-graph capture needs; a breach fails here
before it fails a capture on the card), every buffer of the static state
keeps its address across steps and requests, and a request on a used
generator equals the same request on a fresh one. On the card (marked
``cuda``, skipped here): graph-replayed tokens equal eager tokens and the
null-draft tokens, K1's launch count holds under replay, a draft swap
captures a graph of its own, and a step that syncs fails its capture.

Imports no JAX, so the card's machine runs it with ``--noconftest``.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from msd_tpu_torch import configs as TC
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
