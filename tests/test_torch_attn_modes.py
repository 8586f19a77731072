"""Where the attention switches send each call, and the entry points that
set them, on the CPU at tiny sizes.

- ``attn_impl`` in each value, with ``canonical_attn`` and
  ``canonical_ar``, sends the stated calls to K1's wrapper
  (``llama.decode_attention``, counted here by a wrapper of the wrapper:
  on the CPU it computes the plain twin and counts no launch) and no
  others: the AR row under "pallas" and "auto" (not on a cache below
  ``pallas_min_s``), the non-canonical verify's tree rows under "pallas"
  only, nothing under "xla" or ``canonical_ar``, nothing from a
  canonical verify. An unknown value raises.
- Every field of the JAX package's config dataclasses exists in the port,
  in its order, with its default, apart from the two named departures
  (``attn_impl`` "auto", ``pallas_min_s`` 0).
- ``LlavaMSD.from_pretrained(..., attn_impl=, pallas_min_s=)`` sets both
  (as tests/test_harness.py holds the JAX adapter to), ``server.main``'s
  parser takes ``--attn-impl`` and passes it on, and
  ``autotune.time_verify_forward`` times the mode's forward.
- A graph captured in one mode is never replayed in another (the step
  graphs' key holds the statics, hence the configs), and the new steps
  issue no host sync (what a capture on the card needs).
"""

import dataclasses

import numpy as np
import pytest
import torch

from msd_tpu import configs as JC
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import autotune as TAT
from msd_tpu_torch.engine import spec_engine as SE
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import draft as D
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.attention import tree_bias
from tests.test_torch_graphs import (cpu_graphs,  # noqa: F401 (fixture)
                                     no_host_sync, one_torch_thread)
from tests.test_torch_package_surface import DEPARTURES

WIDTHS = (4, 3, 2, 2, 1, 1)
N_IMG = 8
NEW = 12
LAYERS = 2


def _weights(heads=4, kv_heads=None):
    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=128, hidden_size=64, layers=LAYERS,
                            heads=heads, kv_heads=kv_heads,
                            intermediate_size=128),
        residual_dtype="float32")
    dcfg = TC.DraftConfig(text=cfg, medusa_heads=len(WIDTHS) - 1)
    g = torch.Generator().manual_seed(0)
    tp = L.init_llama_params(cfg, g, "cpu", torch.float32)
    tp["lm_head"].mul_(3.0)
    dp = D.init_draft_params(dcfg, g, "cpu", torch.float32)
    dp["medusa"] = D.init_medusa_params(dcfg, g, "cpu", torch.float32)
    dp["embed_tokens"] = tp["embed_tokens"]
    return cfg, dcfg, tp, dp


def _gen(impl="auto", min_s=0, heads=4, kv_heads=None, cuda_graphs=False,
         **eng):
    cfg, dcfg, tp, dp = _weights(heads, kv_heads)
    cfg = dataclasses.replace(cfg, attn_impl=impl, pallas_min_s=min_s)
    tree = TC.TreeConfig(top_k=WIDTHS[0], max_depth=len(WIDTHS),
                         num_nodes=1 + sum(WIDTHS), medusa_widths=WIDTHS)
    return MSDGenerator(tp, dp, cfg, dataclasses.replace(dcfg, text=cfg),
                        TC.EngineConfig(max_seq_len=256,
                                        prompt_pad_multiple=32, tree=tree,
                                        **eng),
                        n_img=N_IMG, eos_id=-1, device="cpu",
                        cuda_graphs=cuda_graphs)


def _prompt(cfg):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.vocab_size - 1, size=13).astype(np.int32)
    ids[1] = TC.IMAGE_TOKEN_INDEX
    feats = torch.from_numpy(rng.normal(size=(N_IMG, cfg.hidden_size))
                             * 0.1).float()
    return ids, feats


@pytest.fixture
def k1_calls(monkeypatch):
    """The query-row counts of every call that reaches K1's wrapper."""
    calls, real = [], L.decode_attention

    def counted(q, k, v, bias, kv_len):
        calls.append((q.shape[0], bias))
        return real(q, k, v, bias, kv_len)

    monkeypatch.setattr(L, "decode_attention", counted)
    return calls


# (attn_impl, pallas_min_s, engine flags): K1 calls per AR token and per
# verify step, in layers
ROUTES = [
    ("auto", 0, {}, 1, 0),
    ("pallas", 0, {}, 1, 0),
    ("xla", 0, {}, 0, 0),
    ("auto", 0, {"canonical_attn": False}, 1, 0),
    ("pallas", 0, {"canonical_attn": False}, 1, 1),
    ("xla", 0, {"canonical_attn": False}, 0, 0),
    ("auto", 0, {"canonical_ar": True}, 0, 0),
    ("pallas", 0, {"canonical_ar": True, "canonical_attn": False}, 0, 1),
    ("xla", 0, {"canonical_ar": True}, 0, 0),
    ("auto", 384, {}, 1, 0),     # the cache (384 rows) reaches pallas_min_s
    ("auto", 385, {}, 0, 0),     # it does not
]


@pytest.mark.parametrize("impl,min_s,eng,per_token,per_step", ROUTES)
def test_calls_reach_k1_as_attn_impl_says(k1_calls, impl, min_s, eng,
                                          per_token, per_step):
    """An AR run and an MSD run: K1's wrapper sees LAYERS calls of one row
    per AR token decoded where the AR row takes the kernel, LAYERS calls
    of the tree's rows under their tree bias per verify step where the
    verify does, and nothing else."""
    gen = _gen(impl, min_s, **eng)
    assert gen._statics(0).s_target == 384
    ids, feats = _prompt(gen.tcfg)
    ar = gen.naive_generate(ids, feats, NEW)
    assert len(k1_calls) == LAYERS * (len(ar.tokens) - 1) * per_token
    assert all(t == 1 for t, _ in k1_calls)
    del k1_calls[:]
    msd = gen.generate(ids, feats, NEW)
    assert len(k1_calls) == LAYERS * msd.accept_steps * per_step
    n = gen.eng.tree.num_nodes
    for t, bias in k1_calls:
        # the tree rows' bias masks keys inside the live range
        live = bias[:, :int((bias == 0).any(0).nonzero().max()) + 1] == 0
        assert t == n and not live.all() and live[:, 0].all()
    np.testing.assert_array_equal(msd.tokens, ar.tokens)


def test_gqa_ar_row_takes_the_kernel_at_any_group(k1_calls):
    """"auto" sends the AR row of a GQA group above 4 (8 query heads per
    kv head) to K1, and not the non-canonical verify's rows."""
    gen = _gen("auto", heads=8, kv_heads=1, canonical_attn=False)
    ids, feats = _prompt(gen.tcfg)
    ar = gen.naive_generate(ids, feats, NEW)
    gen.generate(ids, feats, NEW)
    assert len(k1_calls) == LAYERS * (len(ar.tokens) - 1)


def test_kernel_route_rule():
    cfg = TC.LlamaConfig.tiny(heads=8, kv_heads=2, hidden_size=128)
    route = {impl: dataclasses.replace(cfg, attn_impl=impl, pallas_min_s=512)
             for impl in TC.ATTN_IMPLS}
    assert not L.kernel_route(route["xla"], 1, 4096)
    assert L.kernel_route(route["pallas"], 48, 128)
    assert L.kernel_route(route["auto"], 1, 512)       # G * T = 4
    assert not L.kernel_route(route["auto"], 1, 511)   # below pallas_min_s
    assert not L.kernel_route(route["auto"], 2, 4096)  # G * T = 8, T > 1
    assert L.kernel_route(dataclasses.replace(route["auto"],
                                              num_key_value_heads=1), 1, 512)


@pytest.mark.parametrize("value", ["triton", "Pallas", ""])
def test_unknown_attn_impl_raises(value):
    with pytest.raises(ValueError, match="attn_impl"):
        TC.LlamaConfig(attn_impl=value)
    with pytest.raises(ValueError, match="attn_impl"):
        dataclasses.replace(TC.LlamaConfig.tiny(), attn_impl=value)


CONFIGS = ["LlamaConfig", "ClipVisionConfig", "LlavaConfig", "DraftConfig",
           "TreeConfig", "EngineConfig"]


def _undepart(x):
    """A port config's asdict with the two departures set back to JAX's
    defaults, after checking they hold the port's."""
    if isinstance(x, dict):
        out = {}
        for k, v in x.items():
            if k in DEPARTURES:
                assert v == DEPARTURES[k][1], (k, v)
                v = DEPARTURES[k][0]
            out[k] = _undepart(v)
        return out
    return x


@pytest.mark.parametrize("name", CONFIGS)
def test_config_fields_and_defaults_match_jax(name):
    """Every field of the JAX package's dataclass, in its order, with its
    default (the defaults of nested configs included), apart from
    attn_impl and pallas_min_s."""
    j, t = getattr(JC, name), getattr(TC, name)
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert _undepart(dataclasses.asdict(t())) == dataclasses.asdict(j())
    if name == "LlamaConfig":
        for ctor in ("llava_7b", "llava_13b", "tiny"):
            assert _undepart(dataclasses.asdict(getattr(t, ctor)())) == \
                dataclasses.asdict(getattr(j, ctor)())


def test_from_pretrained_attn_impl_override(tmp_path):
    """model_args attn_impl / pallas_min_s (strings from the CLI's
    model_args) reach the target config and the draft's."""
    from msd_tpu_torch.harness.models.llava_msd import LlavaMSD
    from tests.test_weights_roundtrip import (make_draft_checkpoint,
                                              make_llava_checkpoint)

    rng = np.random.default_rng(0)
    make_llava_checkpoint(str(tmp_path / "llava"), rng)
    make_draft_checkpoint(str(tmp_path / "draft"), rng)
    adapter = LlavaMSD.from_pretrained(str(tmp_path / "llava"),
                                       str(tmp_path / "draft"),
                                       device="cpu", attn_impl="auto",
                                       pallas_min_s="512")
    assert adapter.gen.tcfg.attn_impl == "auto"
    assert adapter.gen.tcfg.pallas_min_s == 512
    assert adapter.gen.dcfg.text.attn_impl == "auto"
    plain = LlavaMSD.from_pretrained(str(tmp_path / "llava"),
                                     str(tmp_path / "draft"), device="cpu",
                                     attn_impl="xla")
    assert (plain.gen.tcfg.attn_impl, plain.gen.tcfg.pallas_min_s) == \
        ("xla", 0)
    ids = np.arange(3, 14, dtype=np.int32)
    np.testing.assert_array_equal(
        plain.gen.naive_generate(ids, max_new_tokens=8).tokens,
        adapter.gen.naive_generate(ids, max_new_tokens=8).tokens)


def test_server_parser_takes_attn_impl(monkeypatch):
    """server.main's parser takes --attn-impl (xla, pallas, auto; default
    None: the config's own) and server_from_args passes it to the
    adapter."""
    from msd_tpu_torch.harness.models import llava_msd
    from msd_tpu_torch.serve import server

    base = ["--pretrained", "p", "--msd_model_path", "d", "--device", "cpu"]
    assert server.parse_args(base).attn_impl is None
    for impl in TC.ATTN_IMPLS:
        assert server.parse_args(base + ["--attn-impl", impl]).attn_impl \
            == impl
    with pytest.raises(SystemExit):
        server.parse_args(base + ["--attn-impl", "triton"])
    seen = {}

    def from_pretrained(pretrained, draft, **kw):
        seen.update(kw)
        return "adapter"

    monkeypatch.setattr(llava_msd.LlavaMSD, "from_pretrained",
                        staticmethod(from_pretrained))
    monkeypatch.setattr(server, "serve_forever", lambda a, p, **kw: a)
    assert server.server_from_args(server.parse_args(
        base + ["--attn-impl", "pallas"])) == "adapter"
    assert seen["attn_impl"] == "pallas"
    seen.clear()
    server.server_from_args(server.parse_args(base))
    assert "attn_impl" not in seen


@pytest.mark.parametrize("canonical", [True, False])
def test_time_verify_forward_builds_the_modes_bias(monkeypatch, canonical):
    """autotune.time_verify_forward times the verify forward of the mode:
    window slots and a bias below each window, or no window and the
    tree's tree_bias at the prefix; autotune_total_token passes the
    engine's canonical_attn."""
    cfg, _, tp, _ = _weights()
    seen, real = [], L.llama_forward

    def recording(params, cfg, emb, pos, kv, write_pos, bias, *a, **kw):
        seen.append((bias.clone(), kw.get("win"), int(write_pos)))
        return real(params, cfg, emb, pos, kv, write_pos, bias, *a, **kw)

    monkeypatch.setattr(L, "llama_forward", recording)
    tree = TC.TreeConfig(top_k=4, max_depth=4, num_nodes=16)
    TAT.time_verify_forward(tp, cfg, tree, 12, 256, prefix_len=100,
                            repeats=1, device="cpu", canonical=canonical)
    tr = TAT._timing_tree(tree, 12, "cpu")
    for bias, win, write_pos in seen:
        assert write_pos == 100
        if canonical:
            assert win is not None
            cols = torch.arange(256)
            torch.testing.assert_close(bias, torch.where(
                cols < win[2][:, None], 0.0, -1e30).float())
        else:
            assert win is None
            torch.testing.assert_close(bias, tree_bias(tr.mask, 100, 256))
    flags = []
    monkeypatch.setattr(TAT, "time_verify_forward",
                        lambda *a, **kw: flags.append(kw["canonical"]) or 1.0)
    TAT.autotune_total_token(None, None, TC.EngineConfig(
        tree=tree, canonical_attn=canonical), candidates=(8, 16),
        device="cpu")
    assert flags == [canonical, canonical]


def test_a_graph_of_one_mode_is_not_replayed_in_another(cpu_graphs):
    """The step graphs key on the statics, which hold the configs: a
    request after attn_impl changes captures anew, and one back in the
    first mode replays its graph; a new engine mode drops every graph
    (the state is allocated anew) and its requests equal an eager
    generator's in that mode."""
    gen, _, cfg = cpu_graphs()
    ids, feats = _prompt(cfg)
    first = gen.naive_generate(ids, feats, NEW)
    gen.tcfg = dataclasses.replace(gen.tcfg, attn_impl="xla")
    xla = gen.naive_generate(ids, feats, NEW)
    gen.tcfg = dataclasses.replace(gen.tcfg, attn_impl="auto")
    again = gen.naive_generate(ids, feats, NEW)
    assert (first.graph, xla.graph, again.graph) == (0, 1, 0)
    for eng in ({"canonical_attn": False}, {"canonical_ar": True}):
        gen.eng = dataclasses.replace(gen.eng, **eng)
        assert not gen.graphs._cache
        runs = (gen.generate(ids, feats, NEW),
                gen.naive_generate(ids, feats, NEW))
        eager = MSDGenerator(gen.params["target"], gen.params["draft"],
                             gen.tcfg, gen.dcfg, gen.eng, n_img=N_IMG,
                             eos_id=-1, sp=gen.sp, device="cpu",
                             cuda_graphs=False)
        for got, want in zip(runs, (eager.generate(ids, feats, NEW),
                                    eager.naive_generate(ids, feats, NEW))):
            np.testing.assert_array_equal(got.tokens, want.tokens)
        gen.eng = dataclasses.replace(gen.eng, canonical_attn=True,
                                      canonical_ar=False)


@pytest.mark.parametrize("step,impl,eng", [
    ("decode_step", "pallas", {"canonical_attn": False}),
    ("decode_step", "auto", {"canonical_attn": False}),
    ("ar_step", "auto", {"canonical_ar": True}),
    ("ar_step", "xla", {})])
def test_mode_steps_issue_no_host_sync_or_upload(step, impl, eng):
    """Three steps of the non-canonical verify and of the canonical or
    "xla" AR token under the guard of tests/test_torch_graphs.py."""
    gen = _gen(impl, **eng)
    ids, feats = _prompt(gen.tcfg)
    gen.generate(ids, feats, NEW)
    st = gen._statics(NEW)
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
    assert int(s.cur_len) > e0 + 2


@pytest.fixture(scope="module")
def tiny_main():
    """chip_smoke's main path at a tiny width (head_dim 128, as K1 takes
    it on the card) on the CPU."""
    import chip_smoke

    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=2, intermediate_size=512, max_pos=2048),
        residual_dtype="float32")
    return chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                    device="cpu", dtype=torch.float32)


def test_smoke_modes_phase_at_tiny_size(tiny_main):
    """chip_smoke.run_modes on the CPU: every mode's graph and eager
    generators commit the same tokens, (a)'s and (b)'s AR is [main]'s,
    the oracle tree is accepted deep under tree_bias, and no run splits
    from its reference (no tie is allowed off the card)."""
    import chip_smoke

    out = chip_smoke.run_modes(tiny_main)
    assert set(out["splits"]) and not any(out["splits"].values())
    assert out["n_split", "c"] == out["main_splits"] == 0
    assert [len(t) for t in out["tokens"]["a", "graph", "msd"]] == \
        [chip_smoke.MODES_NEW]


def test_smoke_modes_phase_rejects_a_tree_bias_fault(tiny_main,
                                                     monkeypatch):
    """A planted fault in the non-canonical verify (each tree row sees the
    committed prefix and itself, not its ancestors) makes (a)'s MSD depart
    from AR, and the phase raises."""
    import chip_smoke

    def no_ancestors(mask, prefix_len, cache_len):
        eye = torch.eye(mask.shape[-1], dtype=torch.bool).expand(mask.shape)
        return tree_bias(eye, prefix_len, cache_len)

    monkeypatch.setattr(SE, "tree_bias", no_ancestors)
    with pytest.raises(AssertionError, match=r"\(a\) MSD vs its AR"):
        chip_smoke.run_modes(tiny_main)
