"""The port's parallel layer (msd_tpu_torch.parallel) against the JAX
package's (msd_tpu.parallel), on tiny fp32 configs on the CPU.

One world of four gloo ranks (``tests/torch_parallel_ranks.py``, spawned
once for the module) runs every multi-rank case on the JAX package's
weights while this process computes the JAX side on the 8-way virtual CPU
mesh of tests/conftest.py:

- TP=4 (dp 1) EAGLE and medusa decodes give the tokens and accept_steps
  of JAX's single-device and JAX's sharded runs (tests/test_parallel.py),
  the AR baseline JAX's AR tokens; int8 and int4 targets shard and decode
  losslessly; the TP prefill hidden lies within 1e-5 of JAX's, and
  skipping the o_proj sum (the planted fault) moves it beyond that;
- the 4-stage pipeline and both 4-shard sequence modes within 1e-5 of
  JAX's ``pipeline_forward`` and ``sequence_parallel_forward``;
- ``shard_params`` slices of bf16, int8 and packed int4 trees concatenate
  back to the full tree bitwise; the spec trees (ZeRO-1's on a (2, 2)
  mesh included) and the mesh shapes equal JAX's; every rank commits the
  same tokens; ``cuda_graphs=True`` over gloo raises.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.ops.attention import causal_prefill_bias as j_bias
from msd_tpu.parallel import sharding as JS
from msd_tpu.parallel.pipeline import (pipeline_forward as j_pipeline,
                                       shard_layers_for_pipeline as j_stage)
from msd_tpu.parallel.sequence import sequence_parallel_forward as j_seq
from msd_tpu_torch import bridge
from msd_tpu_torch.configs import DraftConfig, LlamaConfig
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import draft as D
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.parallel import sharding as S
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TOL = 1e-5
# tests/test_parallel.py's configs
BASE = dict(vocab_size=256, hidden_size=64, layers=2, heads=8,
            intermediate_size=128, max_pos=1024)
TREE = dict(top_k=4, max_depth=4, num_nodes=12)
ENG = dict(max_seq_len=256, prompt_pad_multiple=32)
QUANT = dict(vocab_size=128, hidden_size=64, layers=2, heads=4,
             intermediate_size=128, max_pos=512)
PIPE = dict(vocab_size=128, hidden_size=32, layers=8, heads=4,
            intermediate_size=64, max_pos=256)
SEQ = dict(vocab_size=128, hidden_size=32, layers=3, heads=4, kv_heads=2,
           intermediate_size=64, max_pos=256)
ZERO = dict(vocab_size=128, hidden_size=64, layers=1, heads=8,
            intermediate_size=128, max_pos=256)
SLICES = dict(vocab_size=128, hidden_size=64, layers=2, heads=4,
              intermediate_size=128, max_pos=256)


def host(tree):
    return jax.tree.map(np.asarray, tree)


def _case(cfg_kw, tp, dp, medusa_heads, ids, tree=TREE, eos_id=2):
    return {"cfg": cfg_kw, "tp": host(tp), "dp": host(dp),
            "medusa_heads": medusa_heads, "tree": tree, "eng": ENG,
            "eos_id": eos_id, "ids": ids}


def _jax_inputs():
    """The JAX package's weights and inputs of every case, and the JAX
    objects the reference side runs on."""
    cfg = JC.LlamaConfig.tiny(**BASE)
    dcfg = JC.DraftConfig(text=cfg)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tp, dp = JL.init_llama_params(k1, cfg), JD.init_draft_params(k2, dcfg)
    dcfg_m = dataclasses.replace(dcfg, medusa_heads=3)
    dpm = dict(dp, medusa=JD.init_medusa_params(jax.random.PRNGKey(5),
                                                dcfg_m))
    ids = np.arange(3, 15, dtype=np.int32)
    inp = {"eagle": _case(BASE, tp, dp, 0, ids),
           "medusa": _case(BASE, tp, dpm, 3, ids)}
    ref = {"base": (cfg, dcfg, tp, dp), "medusa": (dcfg_m, dpm)}

    qcfg = JC.LlamaConfig.tiny(**QUANT)
    qd = JC.DraftConfig(text=qcfg)
    q1, q2 = jax.random.split(jax.random.PRNGKey(0))
    qdp = JD.init_draft_params(q2, qd)
    for bits in (8, 4):
        qtp = JL.quantize_llama_params(JL.init_llama_params(q1, qcfg),
                                       bits=bits)
        inp[f"int{bits}"] = _case(QUANT, qtp, qdp, 0,
                                  np.arange(3, 12, dtype=np.int32),
                                  dict(top_k=4, max_depth=3, num_nodes=8),
                                  eos_id=-1)
        ref[f"int{bits}"] = (qcfg, qd, qtp, qdp)

    pcfg = JC.LlamaConfig.tiny(**PIPE)
    pp = JL.init_llama_params(jax.random.PRNGKey(0), pcfg)
    pemb = jax.random.normal(jax.random.PRNGKey(1), (3, 16, 32),
                             jnp.float32) * 0.1
    inp["pipeline"] = {"cfg": PIPE, "params": host(pp),
                       "emb": np.asarray(pemb)}
    ref["pipeline"] = (pcfg, pp, pemb)

    scfg = JC.LlamaConfig.tiny(**SEQ)
    sp = JL.init_llama_params(jax.random.PRNGKey(0), scfg)
    semb = jax.random.normal(jax.random.PRNGKey(1), (32, 32),
                             jnp.float32) * 0.1
    inp["sequence"] = {"cfg": SEQ, "params": host(sp),
                       "emb": np.asarray(semb)}
    ref["sequence"] = (scfg, sp, semb)

    zcfg = JC.LlamaConfig.tiny(**ZERO)
    zdp = JD.init_draft_params(jax.random.PRNGKey(0),
                               JC.DraftConfig(text=zcfg))
    inp["zero"] = {"cfg": ZERO, "dp": host(zdp)}
    ref["zero"] = (JC.DraftConfig(text=zcfg), zdp)
    inp["slices_cfg"] = SLICES
    return inp, ref


def _jax_side(ref) -> dict:
    """JAX's results: single-device and TP=4 sharded decodes, quantized
    single-device decodes, the prefill hidden, the pipeline, sequence
    parallelism and ZeRO-1 specs."""
    out = {}
    cfg, dcfg, tp, dp = ref["base"]
    eng = JC.EngineConfig(tree=JC.TreeConfig(**TREE), **ENG)
    ids = np.arange(3, 15, dtype=np.int32)
    mesh = JS.make_mesh(4, dp=1, tp=4)
    tp_sh = JS.shard_params(tp, JS.llama_param_specs(cfg), mesh)
    dcfg_m, dpm = ref["medusa"]
    for name, dc, d in (("eagle", dcfg, dp), ("medusa", dcfg_m, dpm)):
        single = JGen(tp, d, cfg, dc, eng, eos_id=2)
        sharded = JGen(tp_sh, JS.shard_params(
            d, JS.draft_param_specs(dc, "fc_b" in d), mesh), cfg, dc, eng,
            eos_id=2)
        r0, r1 = single.generate(ids, max_new_tokens=16), \
            sharded.generate(ids, max_new_tokens=16)
        out[name] = {"single": (np.asarray(r0.tokens), r0.accept_steps),
                     "sharded": (np.asarray(r1.tokens), r1.accept_steps)}
        if name == "eagle":
            out[name]["ar"] = np.asarray(
                single.naive_generate(ids, max_new_tokens=16).tokens)
    for bits in (8, 4):
        qcfg, qd, qtp, qdp = ref[f"int{bits}"]
        qeng = JC.EngineConfig(tree=JC.TreeConfig(top_k=4, max_depth=3,
                                                  num_nodes=8), **ENG)
        gen = JGen(qtp, qdp, qcfg, qd, qeng, eos_id=-1)
        out[f"int{bits}"] = np.asarray(gen.generate(
            np.arange(3, 12, dtype=np.int32), max_new_tokens=10).tokens)
    T = len(ids)
    cos, sin = JL.make_rope(cfg, 64)
    out["hidden"] = np.asarray(JL.llama_forward(
        tp, cfg, tp["embed_tokens"][ids], jnp.arange(T, dtype=jnp.int32),
        JL.init_kv_cache(cfg, T), jnp.int32(0), j_bias(T, T), cos, sin)[0])

    pcfg, pp, pemb = ref["pipeline"]
    pmesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("stage",))
    cos, sin = JL.make_rope(pcfg, 64)
    out["pipeline"] = np.asarray(j_pipeline(
        j_stage(pp, pmesh), pcfg, pemb, j_bias(16, 16), cos, sin, pmesh))
    scfg, sp, semb = ref["sequence"]
    smesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("seq",))
    cos, sin = JL.make_rope(scfg, 64)
    out["sequence"] = {mode: np.asarray(j_seq(
        sp, scfg, semb, j_bias(32, 32), cos, sin, smesh, mode=mode))
        for mode in ("gather", "ring")}
    zd, zdp = ref["zero"]
    out["zero"] = JS.zero_opt_specs(JS.draft_param_specs(zd, "fc_b" in zdp),
                                    zdp, JS.make_mesh(4, dp=2, tp=2))
    return out


def spawn_ranks(module: str, world: int, work) -> list:
    """``world`` processes of ``python -m <module> RANK WORLD STORE WORK``,
    their output piped. They meet at a file store in ``work``, a fresh
    directory (``comm.init``); no port is picked for them."""
    store = os.path.join(str(work), "store")
    return [subprocess.Popen(
        [sys.executable, "-m", module, str(r), str(world), store, str(work)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(JAX's results, each rank's results): the four ranks run while
    this process computes the JAX side."""
    work = tmp_path_factory.mktemp("tp_world")
    inp, ref = _jax_inputs()
    with open(work / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    procs = spawn_ranks("tests.torch_parallel_ranks", WORLD, work)
    try:
        jax_out = _jax_side(ref)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]
    return jax_out, ranks


def _jax_spec(p):
    if isinstance(p, dict):
        return {k: _jax_spec(v) for k, v in p.items()}
    return tuple(p)


@pytest.mark.parametrize("name", ["eagle", "medusa"])
def test_tp_decode_matches_jax_single_and_sharded(world, name):
    """TP=4 generate on the JAX package's weights: the tokens and
    accept_steps of JAX's single-device run and of its TP=4 sharded run
    (tests/test_parallel.py), on every rank."""
    jax_out, ranks = world
    for r in ranks:
        got = (np.asarray(r[name]["tokens"]), r[name]["steps"])
        for side in ("single", "sharded"):
            want = jax_out[name][side]
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1], side


def test_tp_ar_decode_matches_jax(world):
    """naive_generate under TP=4 (the AR row through the decode-attention
    path at the local heads) gives JAX's AR tokens."""
    jax_out, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["eagle"]["ar"], jax_out["eagle"]["ar"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tp_decode_is_lossless(world, bits):
    """int8 and int4 (packed columns split over 'model') JAX targets
    carried by bridge.to_torch + shard_params: MSD == AR under TP=4, and
    both equal JAX's single-device MSD tokens."""
    jax_out, ranks = world
    for r in ranks:
        got = r[f"int{bits}"]
        np.testing.assert_array_equal(got["tokens"], got["ar"])
        np.testing.assert_array_equal(got["tokens"], jax_out[f"int{bits}"])


def test_tp_hidden_matches_jax_and_planted_fault_is_caught(world):
    """The TP=4 prefill hidden (local heads, a cache of 8 / 4 = 2 local KV
    heads, row-parallel sums, gathered embedding) lies within 1e-5 of
    JAX's single-device hidden; with the o_proj sum skipped it does not."""
    jax_out, ranks = world
    for r in ranks:
        h = r["hidden"]
        assert h["kv_heads"] == BASE["heads"] // WORLD
        np.testing.assert_allclose(h["good"].numpy(), jax_out["hidden"],
                                   atol=TOL, rtol=TOL)
        assert np.abs(h["fault"].numpy() - jax_out["hidden"]).max() > 100 * TOL


def test_pipeline_matches_jax(world):
    """The 4-stage GPipe pipeline (3 microbatches over 8 layers) equals
    JAX's pipeline_forward within 1e-5, bitwise the same on every rank."""
    jax_out, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"].numpy(),
                                   jax_out["pipeline"], atol=TOL, rtol=TOL)
        assert torch.equal(r["pipeline"], ranks[0]["pipeline"])


@pytest.mark.parametrize("mode", ["gather", "ring"])
def test_sequence_parallel_matches_jax(world, mode):
    """4-shard sequence parallelism over a GQA config equals JAX's
    sequence_parallel_forward within 1e-5, bitwise the same on every
    rank."""
    jax_out, ranks = world
    for r in ranks:
        np.testing.assert_allclose(r["sequence"][mode].numpy(),
                                   jax_out["sequence"][mode], atol=TOL,
                                   rtol=TOL)
        assert torch.equal(r["sequence"][mode], ranks[0]["sequence"][mode])


def test_ranks_commit_the_same_tokens_and_refuse_graphs(world):
    """Every rank commits the same tokens in every decode, and
    cuda_graphs=True over the gloo mesh raises on each."""
    _, ranks = world
    for name in ("eagle", "medusa", "int8", "int4"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[name]["tokens"],
                                          ranks[0][name]["tokens"])
            np.testing.assert_array_equal(r[name]["ar"], ranks[0][name]["ar"])
        assert all(r[name]["graphs_refused"] for r in ranks)


@pytest.mark.parametrize("kind", ["bf16", "int8", "int4"])
def test_shard_params_slices_concatenate_back(world, kind):
    """Each rank's slices of a seeded bf16 target and its int8 and int4
    transforms, concatenated in rank order along each leaf's 'model'
    dimension, give the full tensor bitwise; unsplit leaves are the full
    tensor on every rank."""
    from tests.torch_parallel_ranks import seeded_trees

    _, ranks = world
    cfg = LlamaConfig.tiny(**SLICES)
    full = seeded_trees(cfg)[kind]
    specs = S._prune_specs(S.llama_param_specs(cfg), full)

    def check(full_t, spec, parts, name):
        if "model" in spec:
            dim = spec.index("model")
            got = torch.cat(parts, dim=dim)
            assert parts[0].shape[dim] * WORLD == full_t.shape[dim], name
        else:
            got = parts[0]
            assert all(torch.equal(p, got) for p in parts), name
        assert got.dtype == full_t.dtype and torch.equal(got, full_t), name

    for name, t in full.items():
        parts = [r["slices"][kind][name] for r in ranks]
        if isinstance(t, dict):
            for sub, tt in t.items():
                check(tt, specs[name][sub], [p[sub] for p in parts],
                      f"{name}/{sub}")
        else:
            check(t, specs[name], parts, name)
    assert full["layers"]["q_proj"].dtype == (torch.bfloat16 if kind == "bf16"
                                              else torch.int8)


def test_zero_opt_specs_match_jax(world):
    """ZeRO-1 moment specs of the draft on a (2, 2) mesh equal JAX's."""
    jax_out, ranks = world
    want = _jax_spec(jax_out["zero"])
    for r in ranks:
        assert r["zero"] == want
    assert ranks[0]["zero"]["fc_w"] == ("data", None)
    assert ranks[0]["mesh_shape"] == {"data": 2, "model": 2}


def test_param_specs_match_jax():
    """llama_param_specs (stacked and not), draft_param_specs (with and
    without the fc bias, with medusa heads) and kv_cache_specs equal the
    JAX package's PartitionSpecs entry for entry."""
    jcfg, tcfg = JC.LlamaConfig.tiny(**BASE), LlamaConfig.tiny(**BASE)
    for stacked in (True, False):
        assert S.llama_param_specs(tcfg, stacked) == \
            _jax_spec(JS.llama_param_specs(jcfg, stacked))
    for heads in (0, 3):
        for bias in (True, False):
            assert S.draft_param_specs(
                DraftConfig(text=tcfg, medusa_heads=heads), bias) == \
                _jax_spec(JS.draft_param_specs(
                    JC.DraftConfig(text=jcfg, medusa_heads=heads), bias))
    assert S.kv_cache_specs() == _jax_spec(JS.kv_cache_specs())


def test_mesh_shapes_match_jax():
    """mesh_shape(n) for n = 1..8 is the (data, model) shape of JAX's
    make_mesh(n) on the virtual CPU mesh; make_mesh() without a process
    group is the one-rank mesh, whose collectives are identities."""
    for n in range(1, 9):
        shape = JS.make_mesh(n).shape
        assert S.mesh_shape(n) == (shape["data"], shape["model"]), n
    mesh = S.make_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert mesh.coords == {"data": 0, "model": 0}


def test_one_rank_mesh_decodes_bitwise_like_no_mesh():
    """A tree sharded over the one-rank mesh (every slice the whole
    tensor) decodes bitwise as the tree without a mesh: same tokens,
    steps and AR tokens."""
    cfg = LlamaConfig.tiny(**BASE)
    dcfg = DraftConfig(text=cfg, medusa_heads=3)
    g = torch.Generator().manual_seed(0)
    tp = L.init_llama_params(cfg, g, "cpu", torch.float32)
    dp = D.init_draft_params(dcfg, g, "cpu", torch.float32)
    dp["medusa"] = D.init_medusa_params(dcfg, g, "cpu", torch.float32)
    from msd_tpu_torch.configs import EngineConfig, TreeConfig
    eng = EngineConfig(tree=TreeConfig(top_k=4, max_depth=4, num_nodes=11,
                                       medusa_widths=(4, 3, 2, 1)), **ENG)
    mesh = S.make_mesh(1)
    ids = np.arange(3, 15, dtype=np.int32)
    runs = []
    for t, d in ((tp, dp), (S.shard_params(tp, S.llama_param_specs(cfg),
                                           mesh),
                            S.shard_params(dp, S.draft_param_specs(dcfg),
                                           mesh))):
        gen = MSDGenerator(t, d, cfg, dcfg, eng, eos_id=2, device="cpu")
        r, ar = gen.generate(ids, max_new_tokens=16), \
            gen.naive_generate(ids, max_new_tokens=16)
        runs.append((r.tokens, r.accept_steps, ar.tokens))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])


def test_stacked_layer_helpers_give_the_port_layouts():
    """init_layer_params is one layer of init_layers' draws (unstacked:
    q/k/v [out, in], o/gate/up/down [in, out]); _stack_layers stacks such
    layers into init_layers' [L, ...] layout; init_llama_params_stacked is
    init_llama_params; the shapes are those of the JAX package's
    init_layer_params."""
    cfg = LlamaConfig.tiny(**SEQ)
    one = L.init_layer_params(cfg, torch.Generator().manual_seed(7), "cpu",
                              torch.float32)
    ref = L.init_layers(cfg, 1, torch.Generator().manual_seed(7), "cpu",
                        torch.float32)
    assert all(torch.equal(one[k], ref[k][0]) for k in ref)
    jl = JL.init_layer_params(jax.random.PRNGKey(0),
                              JC.LlamaConfig.tiny(**SEQ))
    assert {k: tuple(v.shape) for k, v in one.items()} == \
        {k: tuple(v.shape) for k, v in jl.items()}
    g = torch.Generator().manual_seed(8)
    layers = [L.init_layer_params(cfg, g, "cpu", torch.float32)
              for _ in range(3)]
    stacked = L._stack_layers(layers)
    want = L.init_layers(cfg, 3, torch.Generator().manual_seed(8), "cpu",
                         torch.float32)
    assert {k: v.shape for k, v in stacked.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(torch.equal(stacked[k][i], layers[i][k])
               for k in stacked for i in range(3))
    assert L.init_llama_params_stacked is L.init_llama_params
    full = L.init_llama_params_stacked(cfg, torch.Generator().manual_seed(9),
                                       "cpu", torch.float32)
    assert full["layers"]["q_proj"].shape == (3, 32, 32)
    assert full["layers"]["k_proj"].shape == (3, 16, 32)
