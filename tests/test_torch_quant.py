"""Weight-only int8/int4 quantization of the PyTorch port against the JAX
package, on tiny fp32 configs on the CPU, inputs made from seeds with
numpy.

- ``ops/quant``: integers, scales, nibble packing and dequantized weights
  bitwise equal to ``msd_tpu.ops.quant``.
- ``llama_forward`` over a quantized target: hiddens and logits within
  2e-4 (absolute and relative) of JAX's, the tolerance of the fp32 parity
  tests (``tests/test_torch_llama.py``); the dequantized weights are
  bitwise equal, the products fp32 on both sides.
- Greedy MSD on int8 and int4 targets commits the null-draft tokens and
  JAX's tokens; a quantized draft is lossless.
- The draft expansions read a quantized target's ``lm_head`` dequantized,
  where the JAX expansions multiply by its raw integers (a departure,
  ROADMAP section 3): the port's medusa and EAGLE trees equal JAX's trees
  over a target whose head is quantized and dequantized in advance
  (``quant_lm_head=False``, ``lm_head := dequantize(q, s)``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu.ops import quant as JQ
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine import spec_engine as TSE
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.models import draft as TD
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.ops import quant as TQ
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from tests import test_torch_drafting as TDR
from tests import test_torch_llama as TLL
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

MEDUSA = dict(top_k=4, max_depth=4, num_nodes=12,
              medusa_widths=(4, 3, 2, 2))


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    return bridge.to_torch(_host(tree), "cpu")


def _deq(bits):
    return JQ.dequantize if bits == 8 else JQ.dequantize_int4


# ---------------------------------------------------------------------------
# ops/quant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,axis", [((3, 16, 8), -1), ((3, 8, 16), -2),
                                        ((64, 100), -2)])
def test_quantize_and_dequantize_match_jax(bits, shape, axis):
    """Integers (packed for int4), scales and dequantized weights equal
    JAX's bitwise; a channel of zeros takes scale 1; ties round half to
    even on both sides."""
    rng = np.random.default_rng(sum(shape) + bits)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., 0, :] = 0.0
    w[..., 1, 0] = w[..., 1, 1:].max(axis=-1) * 0.5     # ties
    jq, js = JQ.quantize_tensor(jnp.asarray(w), axis, bits)
    tq, ts = TQ.quantize_tensor(torch.from_numpy(w), axis, bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jw = _deq(bits)(jq, js)
    tw = (TQ.dequantize if bits == 8 else TQ.dequantize_int4)(tq, ts)
    assert tw.dtype == torch.bfloat16
    np.testing.assert_array_equal(bridge.to_numpy(tw),
                                  np.asarray(jw).view(np.uint16))


def test_int4_packing_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.integers(-7, 8, size=(5, 12)).astype(np.int8)
    packed = TQ.pack_int4(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(JQ.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(TQ.unpack_int4(packed).numpy(), q)
    raw = rng.integers(-128, 128, size=(4, 6)).astype(np.int8)
    np.testing.assert_array_equal(
        TQ.unpack_int4(torch.from_numpy(raw)).numpy(),
        np.asarray(JQ.unpack_int4(jnp.asarray(raw))))


# ---------------------------------------------------------------------------
# the quantized forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("quant_lm_head", [True, False])
def test_quantized_forward_matches_jax(bits, quant_lm_head):
    """quantize_llama_params equals JAX's bitwise; a prefill over the
    quantized target gives JAX's hiddens, logits and KV within 2e-4."""
    jcfg, tcfg = TLL._cfgs("float32")
    jp, tp = TLL._params(jcfg)
    jq = JL.quantize_llama_params(jp, quant_lm_head, bits)
    tq = TL.quantize_llama_params(tp, quant_lm_head, bits)
    mine, theirs = TDR._host(bridge.to_numpy(tq)), _host(jq)
    flat_m, flat_t = bridge.flatten(mine), bridge.flatten(theirs)
    assert sorted(flat_m) == sorted(flat_t)
    for k in flat_m:
        np.testing.assert_array_equal(flat_m[k], flat_t[k], err_msg=k)
    (jh, jkv, *_), (th, tkv, *_) = TLL._prefill(jcfg, tcfg, jq, tq)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TLL.TOL)
    np.testing.assert_allclose(TL.lm_head(tq, th).numpy(),
                               np.asarray(JL.lm_head(jq, jh)), **TLL.TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tkv[name].numpy(), np.asarray(jkv[name]),
                                   **TLL.TOL)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_layers_from_a_per_layer_callable(bits):
    """quantize_layers over layers made one at a time (as the 13B init from
    seeds makes them) equals quantize_llama_params over the stack, which
    the test above holds to JAX's bitwise."""
    jcfg, tcfg = TLL._cfgs("float32")
    _, tp = TLL._params(jcfg)
    layers = tp["layers"]
    n = layers["q_proj"].shape[0]
    made = TL.quantize_layers(
        lambda i: {k: w[i].clone() for k, w in layers.items()}, n, bits)
    want = TL.quantize_llama_params(tp, True, bits)["layers"]
    assert sorted(made) == sorted(want)
    for k in want:
        assert made[k].dtype == want[k].dtype and torch.equal(made[k],
                                                              want[k]), k


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

def _gens(bits, tree, medusa_heads):
    """JAX and port generators over the same target quantized with
    ``bits`` (lm_head included) and the echo draft (accepted deep where
    the target repeats); the port's drafts by name."""
    jcfg, tcfg = TDR._cfgs()
    jtp, drafts = TDR._weights(jcfg, medusa_heads)
    jq = JL.quantize_llama_params(jtp, True, bits)
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    jgen = JGen(jq, drafts["echo"], jcfg,
                JC.DraftConfig(text=jcfg, medusa_heads=medusa_heads),
                JC.EngineConfig(tree=JC.TreeConfig(**tree), **eng),
                n_img=TDR.N_IMG, eos_id=-1, sp=JSP(greedy_round_bits=6))
    tgen = TGen(_port(jq), _port(drafts["echo"]), tcfg,
                TC.DraftConfig(text=tcfg, medusa_heads=medusa_heads),
                TC.EngineConfig(tree=TC.TreeConfig(**tree), **eng),
                n_img=TDR.N_IMG, eos_id=-1, sp=TSP(greedy_round_bits=6),
                device="cpu")
    return jgen, tgen, {n: _port(d) for n, d in drafts.items()}


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["medusa", "eagle"])
def test_quantized_target_msd_is_lossless_and_matches_jax(bits, mode):
    """Greedy MSD over an int8/int4 target commits its null-draft tokens
    and JAX's tokens for the same weights, image and text prompts; the
    echo draft is accepted beyond one token at some steps."""
    tree, heads = (MEDUSA, 3) if mode == "medusa" else (TDR.EAGLE, 0)
    jgen, tgen, tdrafts = _gens(bits, tree, heads)
    prompts, feats = TDR._prompts(2)
    alphas = []
    for i, ids in enumerate(prompts):
        f = feats if i == 0 else None
        if f is None:
            ids = np.where(ids == JC.IMAGE_TOKEN_INDEX, 5, ids)
        tgen.params["draft"] = tdrafts["echo"]
        msd = tgen.generate(ids, None if f is None else torch.from_numpy(f),
                            TDR.MAX_NEW)
        tgen.params["draft"] = tdrafts["null"]
        null = tgen.generate(ids, None if f is None
                             else torch.from_numpy(f), TDR.MAX_NEW)
        theirs = jgen.generate(ids, None if f is None else jnp.asarray(f),
                               max_new_tokens=TDR.MAX_NEW,
                               split_programs=True)
        np.testing.assert_array_equal(msd.tokens, null.tokens)
        np.testing.assert_array_equal(msd.tokens, theirs.tokens)
        assert len(msd.tokens) == TDR.MAX_NEW
        alphas.append(msd.avg_accept_len)
    assert max(alphas) > 1.0


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_draft_is_lossless(bits):
    """An int8/int4 draft (layer, fc, medusa heads) over the fp32 target
    commits the tokens of the unquantized draft and of the null draft;
    quantize_draft_params equals JAX's."""
    jcfg, tcfg = TDR._cfgs()
    jtp, drafts = TDR._weights(jcfg, 3)
    jdq = JD.quantize_draft_params(drafts["echo"], bits)
    tdq = TD.quantize_draft_params(_port(drafts["echo"]), bits)
    mine = bridge.flatten(bridge.to_numpy(tdq))
    theirs = bridge.flatten(_host(jdq))
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    eng = TC.EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                          tree=TC.TreeConfig(**MEDUSA))
    gen = TGen(_port(jtp), tdq, tcfg, TC.DraftConfig(text=tcfg,
                                                     medusa_heads=3),
               eng, n_img=TDR.N_IMG, eos_id=-1,
               sp=TSP(greedy_round_bits=6), device="cpu")
    prompts, feats = TDR._prompts(2)
    for ids in prompts:
        f = torch.from_numpy(feats)
        quant = gen.generate(ids, f, TDR.MAX_NEW)
        for name in ("echo", "null"):
            gen.params["draft"] = _port(drafts[name])
            np.testing.assert_array_equal(
                quant.tokens, gen.generate(ids, f, TDR.MAX_NEW).tokens)
        gen.params["draft"] = tdq


def _expand_pair(jst, tst, jtp, ttp, dp, seed):
    """One expansion on each side from the same draft cache, last hidden,
    root token and attention feature, the JAX side over ``jtp``, the port
    over ``ttp``. Returns (JAX tree, port tree of lane 0)."""
    rng = np.random.default_rng(seed)
    E = int(rng.integers(20, 60))
    kv = {n: (rng.normal(size=(1, tst.s_draft, 4, 16)) * 0.5)
          .astype(np.float32) for n in ("k", "v")}
    hid = (rng.normal(size=(TDR.H,)) * (0.5, 2.0, 6.0)[seed % 3]) \
        .astype(np.float32)
    af = rng.uniform(0, 0.05, tst.tree.top_k).astype(np.float32)
    cos, sin = JL.make_rope(jst.tcfg, 512)
    jtr, _ = TDR._J_EXPAND(jst, {"target": jtp, "draft": dp},
                           {n: jnp.asarray(a) for n, a in kv.items()},
                           jnp.int32(E), jnp.asarray(hid), jnp.int32(5),
                           cos, sin, jnp.asarray(af))
    tparams = {"target": ttp, "draft": _port(dp),
               "cos_t": TDR._t(np.asarray(cos)),
               "sin_t": TDR._t(np.asarray(sin))}
    ttr = TSE._draft_expand(tst, tparams, TDR._t(hid)[None],
                            torch.tensor([5], dtype=torch.int32),
                            TDR._t(af)[None], None,
                            {n: TDR._t(a)[None] for n, a in kv.items()},
                            torch.tensor([E], dtype=torch.int32))
    return jtr, TDR._lane0(ttr)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["medusa", "eagle"])
def test_quantized_head_trees_match_jax_with_dequantized_head(bits, mode):
    """The departure, pinned: over a target quantized with its lm_head,
    the port's draft trees equal JAX's trees over the same target whose
    head was quantized and dequantized beforehand (JAX reads a quantized
    head raw, and an int4 head [H, V/2] would rank half the vocabulary),
    for the random and echo drafts."""
    tree, heads = (MEDUSA, 3) if mode == "medusa" else (TDR.EAGLE, 0)
    jcfg, tcfg = TDR._cfgs()
    jtp, drafts = TDR._weights(jcfg, heads)
    jq = JL.quantize_llama_params(jtp, True, bits)
    ttp = _port(jq)
    jref = JL.quantize_llama_params(jtp, False, bits)
    jref["lm_head"] = _deq(bits)(*JQ.quantize_tensor(jtp["lm_head"], -2,
                                                     bits))
    jst, tst = TDR._statics_pair(jcfg, tcfg, tree, medusa_heads=heads)
    for trial in range(4):
        jtr, ttr = _expand_pair(jst, tst, jref, ttp,
                                drafts[("msd", "echo")[trial % 2]], trial)
        TDR._tree_fields(ttr, jtr)
