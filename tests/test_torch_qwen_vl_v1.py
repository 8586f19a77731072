"""The port's Qwen-VL (v1) path against the JAX package's, on tiny fp32
configs on the CPU, inputs made from seeds with numpy: the tower
(``models/qwen_vl_v1``: the ViT and its resampler), the public checkpoint
maps and ``load_qwen_vl_v1``, the generator's ``inline_pad_ids``, a tiny
v1 engine (1-D rope, q/k/v biases, the inline span found by its
``<imgpad>`` id), the ``qwen_vl_eagle`` adapter and its CLI, and
``chip_smoke.py``'s ``[qwen_v1]`` phase.

sincos tables EQUAL; the bicubic matrix and resize within 1e-6; the tower
within 1e-5 of JAX's (under ``jax.jit``); the maps and the loader bitwise;
image positions, tokens and adapter outputs EQUAL.
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.harness.instance import Instance as JInstance
from msd_tpu.harness.models import qwen2_vl_msd as JQA
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import draft as JD
from msd_tpu.models import qwen_vl_v1 as J
from msd_tpu.ops.sampling import SamplingParams as JSP
from msd_tpu.utils import weights as JW
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.harness import __main__ as TMain
from msd_tpu_torch.harness import registry as TR
from msd_tpu_torch.harness.instance import Instance
from msd_tpu_torch.harness.models import qwen2_vl_msd as TQA
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
from msd_tpu_torch.models import qwen_vl_v1 as T
from msd_tpu_torch.ops.sampling import SamplingParams as TSP
from msd_tpu_torch.utils import weights as TW
from msd_tpu_torch.utils.safetensors_io import save_file
from tests.test_torch_anyres_multi import jax_native
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_qwen_model import _host

V = 512
# the public Qwen/Qwen-VL span ids: <img>, <imgpad>, </img>
V1_START, V1_PAD, V1_END = 151857, 151859, 151858
QWEN2_PADS = (151655, 151656)
LM_KW = dict(vocab=V, hidden=48, layers=2, heads=4, inter=96)
VIS_KW = dict(width=32, layers=2, heads=4, out=48, queries=4,
              image_size=56)
TREE = dict(top_k=4, max_depth=4, num_nodes=12)
MAX_NEW = 10


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


@functools.lru_cache(maxsize=None)
def _jit_encode(cfg):
    return jax.jit(lambda p, px: J.qwen_vl_vision_encode(p, cfg, px))


def jax_vision_params(cfg, seed=0):
    """JAX tower params with non-trivial norms and biases (its init makes
    them ones and zeros)."""
    p = J.init_qwen_vl_vision_params(jax.random.PRNGKey(seed), cfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 64))

    def jitter(x):
        return x + 0.05 * jax.random.normal(next(keys), x.shape)

    p["blocks"] = {k: jitter(v) if k.endswith("_b") or k.startswith("ln")
                   else v for k, v in p["blocks"].items()}
    r = p["resampler"]
    for k in ("ln_q_w", "ln_q_b", "ln_kv_w", "ln_kv_b"):
        r[k] = jitter(r[k])
    r["attn"]["in_proj_b"] = jitter(r["attn"]["in_proj_b"])
    for k in ("ln_pre_w", "ln_pre_b", "ln_post_w", "ln_post_b"):
        p[k] = jitter(p[k])
    return p


def hf_state(vcfg, lcfg, seed=0, pos_grid=None):
    """A numpy state dict in the public Qwen/Qwen-VL names: the tower
    under ``transformer.visual.`` (its ViT table ``pos_grid`` wide) and
    the Qwen-1 LM (fused ``c_attn`` with a bias, w1/w2 halves)."""
    rng = np.random.default_rng(seed)
    w, m, o, h = vcfg.width, vcfg.mlp_size, vcfg.output_dim, \
        lcfg.hidden_size
    inter, v, p = lcfg.intermediate_size, lcfg.vocab_size, vcfg.patch_size
    g = pos_grid or vcfg.grid

    def n(*shape):
        return (rng.normal(size=shape) * shape[-1] ** -0.5).astype(
            np.float32)

    vis = {"conv1.weight": n(w, 3, p, p),
           "positional_embedding": n(g * g, w) * 0.1,
           "ln_pre.weight": 1 + n(w), "ln_pre.bias": n(w),
           "attn_pool.pos_embed": J.sincos_2d(
               o, int(round(vcfg.n_queries ** 0.5))),
           "attn_pool.query": n(vcfg.n_queries, o),
           "attn_pool.kv_proj.weight": n(o, w),
           "attn_pool.ln_q.weight": 1 + n(o), "attn_pool.ln_q.bias": n(o),
           "attn_pool.ln_kv.weight": 1 + n(o), "attn_pool.ln_kv.bias": n(o),
           "attn_pool.attn.in_proj_weight": n(3 * o, o),
           "attn_pool.attn.in_proj_bias": n(3 * o),
           "attn_pool.attn.out_proj.weight": n(o, o),
           "attn_pool.attn.out_proj.bias": n(o),
           "ln_post.weight": 1 + n(o), "ln_post.bias": n(o),
           "proj": n(o, o)}
    for i in range(vcfg.layers):
        pre = f"transformer.resblocks.{i}."
        vis.update({pre + "ln_1.weight": 1 + n(w), pre + "ln_1.bias": n(w),
                    pre + "ln_2.weight": 1 + n(w), pre + "ln_2.bias": n(w),
                    pre + "attn.in_proj_weight": n(3 * w, w),
                    pre + "attn.in_proj_bias": n(3 * w),
                    pre + "attn.out_proj.weight": n(w, w),
                    pre + "attn.out_proj.bias": n(w),
                    pre + "mlp.c_fc.weight": n(m, w),
                    pre + "mlp.c_fc.bias": n(m),
                    pre + "mlp.c_proj.weight": n(w, m),
                    pre + "mlp.c_proj.bias": n(w)})
    st = {"transformer.visual." + k: x for k, x in vis.items()}
    st.update({"transformer.wte.weight": n(v, h),
               "transformer.ln_f.weight": 1 + n(h),
               "lm_head.weight": n(v, h) * 3.0})
    for i in range(lcfg.num_hidden_layers):
        pre = f"transformer.h.{i}."
        st.update({pre + "attn.c_attn.weight": n(3 * h, h),
                   pre + "attn.c_attn.bias": n(3 * h) * 0.3,
                   pre + "attn.c_proj.weight": n(h, h),
                   pre + "ln_1.weight": 1 + n(h),
                   pre + "ln_2.weight": 1 + n(h),
                   pre + "mlp.w1.weight": n(inter, h),
                   pre + "mlp.w2.weight": n(inter, h),
                   pre + "mlp.c_proj.weight": n(h, inter)})
    return st


def _cfgs():
    return (J.QwenVLV1TextConfig.tiny(**LM_KW),
            J.QwenVLVisionConfig.tiny(**VIS_KW),
            T.QwenVLV1TextConfig.tiny(**LM_KW),
            T.QwenVLVisionConfig.tiny(**VIS_KW))


def _bitwise(mine, theirs):
    a, b = bridge.flatten(mine), bridge.flatten(_host(theirs))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == _t(b[k]).dtype, k
        assert torch.equal(a[k], _t(b[k])), k


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim,grid", [(48, 2), (64, 4), (4096, 16)])
def test_sincos_2d_matches_jax(dim, grid):
    """The resampler's table (MAE's [w-half, h-half] layout) is bitwise
    JAX's."""
    np.testing.assert_array_equal(T.sincos_2d(dim, grid),
                                  J.sincos_2d(dim, grid))


@pytest.mark.parametrize("src,tgt", [(16, 32), (4, 8), (8, 4), (4, 4)])
def test_bicubic_resize_matches_jax(src, tgt):
    """torch's bicubic (A = -0.75, half-pixel, clamped taps) as a matrix,
    and ``interp_abs_pos`` through it, within 1e-6 of JAX's; the identity
    when the grids agree."""
    np.testing.assert_allclose(T._torch_bicubic_matrix(src, tgt),
                               J._torch_bicubic_matrix(src, tgt), atol=1e-6)
    pos = np.random.default_rng(src * tgt).normal(
        size=(src * src, 24)).astype(np.float32)
    got = T.interp_abs_pos(torch.from_numpy(pos), tgt * tgt)
    want = np.asarray(J.interp_abs_pos(jnp.asarray(pos), tgt * tgt))
    assert got.shape == (tgt * tgt, 24)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    if src == tgt:
        assert torch.equal(got, torch.from_numpy(pos))


@pytest.mark.parametrize("image_size", [56, 112])
def test_vision_encode_matches_jax(image_size):
    """``qwen_vl_vision_encode`` within 1e-5 of JAX's with the weights
    carried across: at the checkpoint grid (4 x 4) and at 8 x 8, where the
    ViT's table and the resampler's key positions are resized."""
    jcfg, tcfg = (J.QwenVLVisionConfig.tiny(**VIS_KW),
                  T.QwenVLVisionConfig.tiny(**VIS_KW))
    jp = jax_vision_params(jcfg, seed=image_size)
    px = np.random.default_rng(image_size).normal(
        size=(3, image_size, image_size)).astype(np.float32)
    want = np.asarray(_jit_encode(jcfg)(jp, jnp.asarray(px)))
    got = T.qwen_vl_vision_encode(bridge.to_torch(_host(jp), "cpu"), tcfg,
                                  torch.from_numpy(px))
    assert got.shape == (4, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_init_params_have_jax_layout():
    """The seeded init has JAX's keys and shapes, the sincos table, ones
    and zeros where JAX has them, and is reproducible from its seed."""
    jcfg, tcfg = (J.QwenVLVisionConfig.tiny(**VIS_KW),
                  T.QwenVLVisionConfig.tiny(**VIS_KW))
    shapes = jax.tree.map(lambda x: x.shape, J.init_qwen_vl_vision_params(
        jax.random.PRNGKey(0), jcfg))
    a, b = (bridge.flatten(T.init_qwen_vl_vision_params(
        tcfg, torch.Generator().manual_seed(3), "cpu", torch.float32))
        for _ in range(2))
    assert {k: tuple(v.shape) for k, v in a.items()} == \
        {k: tuple(v) for k, v in bridge.flatten(shapes).items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["blocks/ln1_w"] == 1) and torch.all(a["proj"] != 0)
    assert torch.equal(a["resampler/pos_embed"],
                       torch.from_numpy(J.sincos_2d(48, 2)))


# ---------------------------------------------------------------------------
# the checkpoint maps and the loader
# ---------------------------------------------------------------------------

def test_hf_maps_match_jax():
    """One numpy state dict through both packages' maps: the port's trees
    are bitwise JAX's after the bridge (the fused c_attn split into q/k/v
    and their biases, w2 the gated half, the tower's blocks stacked)."""
    jl, jv, tl, tv = _cfgs()
    st = hf_state(jv, jl, seed=1)
    tst = {k: torch.from_numpy(x) for k, x in st.items()}
    _bitwise(T.params_from_hf_qwen_v1(tst, tl, device="cpu"),
             J.params_from_hf_qwen_v1(st, jl))
    _bitwise(T.params_from_hf_qwen_vl_vision(tst, tv, device="cpu"),
             J.params_from_hf_qwen_vl_vision(st, jv))


def _write_checkpoint(path, st, jl, jv, visual_keys, eps=1e-6,
                      base=10000.0):
    os.makedirs(path, exist_ok=True)
    save_file({k: torch.from_numpy(x) for k, x in st.items()},
              os.path.join(path, "model.safetensors"))
    full = {"image_size": jv.image_size, "patch_size": jv.patch_size,
            "width": jv.width, "layers": jv.layers, "heads": jv.heads,
            "mlp_size": jv.mlp_size, "output_dim": jv.output_dim,
            "n_queries": jv.n_queries, "image_start_id": V1_START}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"vocab_size": jl.vocab_size,
                   "hidden_size": jl.hidden_size,
                   "intermediate_size": 2 * jl.intermediate_size,
                   "num_hidden_layers": jl.num_hidden_layers,
                   "num_attention_heads": jl.num_attention_heads,
                   "max_position_embeddings": jl.max_position_embeddings,
                   "layer_norm_epsilon": eps, "rotary_emb_base": base,
                   "visual": {k: full[k] for k in visual_keys}}, f)


@pytest.mark.parametrize("without", [(), ("output_dim",)])
def test_load_qwen_vl_v1_matches_jax(tmp_path, without):
    """``load_qwen_vl_v1`` of a tiny checkpoint directory (safetensors and
    a config.json with a ``visual`` block; ``output_dim`` defaulting to
    the LM's hidden size when the block lacks it) is bitwise JAX's, with
    equal configs (``intermediate_size // 2``, ``layer_norm_epsilon``,
    ``rotary_emb_base``)."""
    jl, jv, _, _ = _cfgs()
    st = hf_state(jv, jl, seed=2)
    keys = [k for k in ("image_size", "patch_size", "width", "layers",
                        "heads", "mlp_size", "output_dim", "n_queries",
                        "image_start_id") if k not in without]
    _write_checkpoint(str(tmp_path), st, jl, jv, keys, eps=1e-5,
                      base=5000.0)
    lm, vis, tcfg, vcfg = TW.load_qwen_vl_v1(str(tmp_path), torch.float32,
                                             "cpu")
    jlm, jvis, jtcfg, jvcfg = JW.load_qwen_vl_v1(str(tmp_path), jnp.float32)
    _bitwise(lm, jlm)
    _bitwise(vis, jvis)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jtcfg)
    assert dataclasses.asdict(vcfg) == dataclasses.asdict(jvcfg)
    assert (tcfg.intermediate_size, tcfg.rms_norm_eps, tcfg.rope_theta) \
        == (jl.intermediate_size, 1e-5, 5000.0)


# ---------------------------------------------------------------------------
# the generator's inline_pad_ids
# ---------------------------------------------------------------------------

def _tiny_gens(inline_pad_ids, tp=None, dp=None, sp=None):
    """(port, JAX) inline generators over the same tiny v1 weights."""
    jl = J.QwenVLV1TextConfig.tiny(**LM_KW).as_llama()
    tl = T.QwenVLV1TextConfig.tiny(**LM_KW).as_llama()
    if tp is None:
        tp = J.params_from_hf_qwen_v1(hf_state(
            J.QwenVLVisionConfig.tiny(**VIS_KW), J.QwenVLV1TextConfig.tiny(
                **LM_KW), seed=4), J.QwenVLV1TextConfig.tiny(**LM_KW))
        dp = JD.init_draft_params(jax.random.PRNGKey(7),
                                  JC.DraftConfig(text=jl))
        dp["embed_tokens"] = tp["embed_tokens"]
    eng = dict(max_seq_len=256, prompt_pad_multiple=32)
    common = dict(n_img=4, eos_id=-1, image_mode="inline",
                  mrope_section=None, inline_pad_ids=inline_pad_ids)
    jgen = JGen(tp, dp, jl, JC.DraftConfig(text=jl), JC.EngineConfig(
        tree=JC.TreeConfig(**TREE), **eng), sp=JSP(greedy_round_bits=6),
        **common)
    tgen = TGen(bridge.to_torch(_host(tp), "cpu"),
                bridge.to_torch(_host(dp), "cpu"), tl,
                TC.DraftConfig(text=tl), TC.EngineConfig(
                    tree=TC.TreeConfig(**TREE), **eng),
                sp=TSP(greedy_round_bits=6), device="cpu", **common)
    return tgen, jgen


def _prompt(seed, pad=V1_PAD, start=V1_START, end=V1_END, n=4,
            text=20):
    ids = np.random.default_rng(seed).integers(3, V - 1, size=text)
    if pad is None:
        return ids.astype(np.int32)
    return np.concatenate([ids[:3], [start], np.full(n, pad), [end],
                           ids[3:]]).astype(np.int32)


@pytest.mark.parametrize("pad_ids", [(V1_PAD,), None])
@pytest.mark.parametrize("prompt", ["v1", "image", "video", "text"])
def test_img_pos_matches_jax(pad_ids, prompt):
    """``_img_pos`` of an inline generator with and without
    ``inline_pad_ids`` equals JAX's on prompts holding v1's pad, Qwen2-VL's
    image or video pad, or none (then len(ids))."""
    pads = {"v1": V1_PAD, "image": QWEN2_PADS[0], "video": QWEN2_PADS[1],
            "text": None}
    ids = _prompt(0, pad=pads[prompt])
    tgen, jgen = _tiny_gens(pad_ids)
    assert tgen.inline_pad_ids == jgen.inline_pad_ids
    got, want = tgen._img_pos(ids), jgen._img_pos(ids)
    assert got == want
    found = prompt == "v1" if pad_ids else prompt in ("image", "video")
    assert got == (4 if found else len(ids))


def test_video_gen_keeps_the_pad_ids():
    """The adapter's second generator (``video_gen``) takes the first
    one's ``inline_pad_ids``, as JAX's does."""
    tgen, jgen = _tiny_gens((V1_PAD,))
    tad = TQA.Qwen2VLMSD(tgen, SimpleTokenizer(V), None, img_grid=(4, 4),
                         max_num_frames=4)
    jad = JQA.Qwen2VLMSD(jgen, JTok(V), None, img_grid=(4, 4),
                         max_num_frames=4)
    assert tad.video_gen.inline_pad_ids == (V1_PAD,) \
        == jad.video_gen.inline_pad_ids
    assert tad.video_gen.params["target"] is tgen.params["target"]


# ---------------------------------------------------------------------------
# the slice: a tiny v1 engine and the qwen_vl_eagle adapter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    """Tiny v1 weights in both packages (the LM through the public maps:
    q/k/v biases; an EAGLE draft; a tower), (port, JAX) generators whose
    span is found by v1's <imgpad>, and the image rows of each package's
    tower on one seeded image."""
    jl, jv, _, tv = _cfgs()
    st = hf_state(jv, jl, seed=5)
    tp = J.params_from_hf_qwen_v1(st, jl)
    jvis = J.params_from_hf_qwen_vl_vision(st, jv)
    dp = JD.init_draft_params(jax.random.PRNGKey(8),
                              JC.DraftConfig(text=jl.as_llama()))
    dp["embed_tokens"] = tp["embed_tokens"]
    tgen, jgen = _tiny_gens((V1_PAD,), tp, dp)
    tvis = bridge.to_torch(_host(jvis), "cpu")
    px = np.random.default_rng(5).normal(size=(3, 56, 56)).astype(
        np.float32)
    jfeats = _jit_encode(jv)(jvis, jnp.asarray(px))
    tfeats = T.qwen_vl_vision_encode(tvis, tv, torch.from_numpy(px))
    np.testing.assert_allclose(tfeats.numpy(), np.asarray(jfeats),
                               atol=1e-5, rtol=1e-5)
    return {"tgen": tgen, "jgen": jgen, "tvis": tvis, "jvis": jvis,
            "jfeats": jfeats, "tfeats": tfeats, "tp": tp, "dp": dp}


def _default_pads(stack):
    """The stack with (port, JAX) generators over its weights that find
    Qwen2-VL's pads (no ``inline_pad_ids``)."""
    tgen, jgen = _tiny_gens(None, stack["tp"], stack["dp"])
    return dict(stack, tgen=tgen, jgen=jgen)


@pytest.fixture(scope="module")
def engine_runs(stack):
    """AR and MSD tokens of both packages on a v1 image prompt and a text
    prompt."""
    out = {}
    for kind, ids in (("image", _prompt(1)), ("text", _prompt(2, None))):
        tf = stack["tfeats"] if kind == "image" else None
        jf = stack["jfeats"] if kind == "image" else None
        for mode in ("ar", "msd"):
            tfn = stack["tgen"].naive_generate if mode == "ar" \
                else stack["tgen"].generate
            jfn = stack["jgen"].naive_generate if mode == "ar" \
                else stack["jgen"].generate
            out[kind, mode] = (tfn(ids, img_feats=tf, max_new_tokens=MAX_NEW),
                               jfn(ids, img_feats=jf,
                                   max_new_tokens=MAX_NEW))
    return out


@pytest.mark.parametrize("kind", ["image", "text"])
@pytest.mark.parametrize("mode", ["ar", "msd"])
def test_tiny_v1_engine_matches_jax(engine_runs, kind, mode):
    """The tiny v1 engine's greedy AR and MSD tokens (and MSD's accepted
    counts) equal JAX's, and MSD equals the port's AR."""
    mine, theirs = engine_runs[kind, mode]
    np.testing.assert_array_equal(mine.tokens, np.asarray(theirs.tokens))
    assert len(mine.tokens) == MAX_NEW
    assert (mine.accept_steps, mine.accept_len_sum) == \
        (theirs.accept_steps, theirs.accept_len_sum)
    np.testing.assert_array_equal(mine.tokens,
                                  engine_runs[kind, "ar"][0].tokens)


def test_the_image_rows_are_fused(stack, engine_runs):
    """Without ``inline_pad_ids`` the v1 span is not found, and the image
    prompt's tokens change (the planted fault of ``[qwen_v1]``)."""
    tgen = _default_pads(stack)["tgen"]
    r = tgen.generate(_prompt(1), img_feats=stack["tfeats"],
                      max_new_tokens=MAX_NEW)
    assert not np.array_equal(r.tokens, engine_runs["image", "msd"][0].tokens)


def _adapters(stack, use_msd=None):
    """(port, JAX) ``QwenVLEagle`` over the same weights through each
    package's constructor (the JAX ``from_tiny`` keeps its tower in a
    closure): images at 56px through each package's tower."""
    tv, jv = T.QwenVLVisionConfig.tiny(**VIS_KW), \
        J.QwenVLVisionConfig.tiny(**VIS_KW)
    jenc = _jit_encode(jv)
    kw = {} if use_msd is None else {"use_msd": use_msd}

    def tenc(px):
        return T.qwen_vl_vision_encode(stack["tvis"], tv,
                                       torch.from_numpy(px))

    return (TQA.QwenVLEagle(stack["tgen"], SimpleTokenizer(V), tenc,
                            img_grid=(tv.grid, tv.grid), **kw),
            JQA.QwenVLEagle(stack["jgen"], JTok(V),
                            lambda px: jenc(stack["jvis"], px),
                            img_grid=(jv.grid, jv.grid), **kw))


def _v1_ids(adapter):
    adapter.vision_start_id, adapter.image_pad_id, adapter.vision_end_id = \
        V1_START, V1_PAD, V1_END
    return adapter


def _image(seed):
    from PIL import Image

    return Image.fromarray(np.random.default_rng(seed).integers(
        0, 255, size=(64, 48, 3), dtype=np.uint8))


@pytest.mark.parametrize("use_msd", [None, True])
def test_qwen_vl_eagle_generates_as_jax(stack, use_msd):
    """``_generate_plain`` of the adapter (AR by default, MSD with
    ``use_msd``) gives JAX's text and acceptance counts, with an image (the
    adapter's span at v1's ids) and without."""
    jax_native()
    mine, theirs = (_v1_ids(a) for a in _adapters(stack, use_msd))
    assert mine.use_msd is theirs.use_msd is bool(use_msd)
    kw = {"max_new_tokens": MAX_NEW}
    for visuals in ([_image(0)], []):
        got = mine._generate_plain("What is shown?", visuals, dict(kw))
        want = theirs._generate_plain("What is shown?", visuals, dict(kw))
        assert got == want
    assert (mine.total_accept_steps, mine.total_accept_len) == \
        (theirs.total_accept_steps, theirs.total_accept_len)
    assert (mine.total_accept_steps > 0) == bool(use_msd)


def _ll_request(icls, visual):
    img = _image(1)
    return icls(request_type="loglikelihood", doc={"image": img},
                arguments=("Describe.", "a blue square",
                           (lambda d: [d["image"]]) if visual else None,
                           0, "t", "test"), idx=0, task_name="t", doc_id=0)


@pytest.mark.parametrize("visual", [True, False])
def test_qwen_vl_eagle_loglikelihood_matches_jax(stack, visual):
    """``loglikelihood`` at the adapters' default span ids (Qwen2-VL's,
    which both packages' loglikelihood build) equals JAX's, bitwise
    repeatable."""
    jax_native()
    mine, theirs = _adapters(_default_pads(stack))
    got = mine.loglikelihood([_ll_request(Instance, visual)])[0]
    want = theirs.loglikelihood([_ll_request(JInstance, visual)])[0]
    assert got[0] == pytest.approx(want[0], rel=1e-5)
    assert got[1] == want[1]
    assert mine.loglikelihood([_ll_request(Instance, visual)])[0] == got


def test_loglikelihood_builds_the_adapters_span(stack):
    """The port's loglikelihood builds its span from the adapter's own ids
    (a departure from JAX's, which always builds Qwen2-VL's): an adapter
    at v1's ids over a generator that finds v1's pad scores as one at
    Qwen2-VL's ids over a generator that finds those (the tiny vocabulary
    clamps both span ends to one row), and the image rows count."""
    jax_native()
    v1 = _v1_ids(_adapters(stack)[0])
    qwen2 = _adapters(_default_pads(stack))[0]
    got = v1.loglikelihood([_ll_request(Instance, True)])[0]
    want = qwen2.loglikelihood([_ll_request(Instance, True)])[0]
    assert got == want
    assert got != v1.loglikelihood([_ll_request(Instance, False)])[0]


def test_from_pretrained_serves_the_checkpoint(tmp_path, stack):
    """``QwenVLEagle.from_pretrained`` of a checkpoint in the public names
    (and an EAGLE draft by ``save_draft``): fp32 on the CPU, the byte
    tokenizer's fallback span ids (Qwen2-VL's) as ``inline_pad_ids``, EOS
    2, the tower's grid, AR by default; its text equals an adapter built
    over the same weights in memory."""
    jax_native()
    jl, jv, _, _ = _cfgs()
    st = hf_state(jv, jl, seed=5)
    _write_checkpoint(str(tmp_path / "ckpt"), st, jl, jv,
                      ("image_size", "patch_size", "width", "layers",
                       "heads", "mlp_size", "output_dim", "n_queries"))
    TW.save_draft(stack["tgen"].params["draft"], str(tmp_path / "d"))
    lm = TQA.QwenVLEagle.from_pretrained(
        str(tmp_path / "ckpt"), str(tmp_path / "d"), device="cpu",
        eng=stack["tgen"].eng)
    g = lm.gen
    assert (g.n_img, g.eos_id, g.mrope_section, g.inline_pad_ids) == \
        (4, 2, None, (QWEN2_PADS[0],))
    assert g.params["target"]["lm_head"].dtype == torch.float32
    assert lm.img_grid == (4, 4) and lm.use_msd is False
    assert (lm.vision_start_id, lm.image_pad_id) == (151652, QWEN2_PADS[0])
    # the loader reads no resampler head count (JAX's neither): the
    # public model's 32
    vcfg = dataclasses.replace(T.QwenVLVisionConfig.tiny(**VIS_KW),
                               resampler_heads=32)
    ref = TQA.QwenVLEagle.from_v1(_default_pads(stack)["tgen"],
                                  SimpleTokenizer(V), stack["tvis"], vcfg)
    kw = {"max_new_tokens": MAX_NEW}
    assert lm._generate_plain("What?", [_image(2)], dict(kw)) == \
        ref._generate_plain("What?", [_image(2)], dict(kw))


def test_cli_runs_the_tiny_qwen_vl_v1_stack(capsys):
    """``python -m msd_tpu_torch.harness --model qwen_vl_eagle
    --model_args tiny=true --device cpu``: the default (AR) and
    ``--use_msd`` give the same responses; the tiny stack's tower is a
    real v1 tower over a 1-D-rope engine."""
    argv = ["--model", "qwen_vl_eagle", "--model_args", "tiny=true",
            "--device", "cpu", "--tasks", "synthetic_vqa,ai2d_ppl",
            "--limit", "2", "--gen_kwargs", "max_new_tokens=8",
            "--log_samples"]
    msd = TMain.main(argv + ["--use_msd"])
    ar = TMain.main(argv)
    for task in ("synthetic_vqa", "ai2d_ppl"):
        assert [s["response"] for s in msd["details"][task]["samples"]] == \
            [s["response"] for s in ar["details"][task]["samples"]]
    assert msd["msd_stats"]["accept_steps"] > 0
    assert ar["msd_stats"]["accept_steps"] == 0
    tiny = TR.get_model("qwen_vl_eagle").from_tiny(device="cpu")
    assert isinstance(tiny, TQA.QwenVLEagle) and not tiny.use_msd
    assert (tiny.gen.n_img, tiny.gen.mrope_section) == (4, None)
    assert tiny.encode_image_fn(np.zeros((3, 56, 56), np.float32)).shape \
        == (4, 48)
    capsys.readouterr()


def test_smoke_qwen_v1_phase_at_tiny_size(tmp_path):
    """chip_smoke's [qwen_v1] phase on the CPU at a tiny width: MSD ==
    eager MSD == the null draft on two v1 image prompts and a text prompt,
    every committed token the v1 recompute's argmax, AR == MSD; the tower
    against its fp32 evaluation and against the remote code's replica;
    both planted faults rejected on measured quantities; the checkpoint in
    the public names loaded back bitwise; the harness CLI's qwen_vl_eagle,
    B (AR, its default) and A (MSD), with
    bitwise equal scores within 1e-4 of their recompute. The phase raises
    otherwise."""
    import chip_smoke

    q = T.QwenVLV1TextConfig.tiny(vocab=V, hidden=64, layers=2, heads=4,
                                  inter=128)
    # the loader reads no resampler head count (JAX's neither): the public
    # model's 32, which the checkpoint must round-trip
    vcfg = dataclasses.replace(T.QwenVLVisionConfig.tiny(out=64),
                               resampler_heads=32)
    out = chip_smoke.run_qwen_v1(
        str(tmp_path), device="cpu", qcfg=q, vcfg=vcfg,
        widths=(4, 3, 2, 2, 1), max_seq=512, max_new=12, prompt_tokens=20,
        limit=2, harness_new=8)
    assert out["launches"] == out["harness_launches"] == 0   # CPU: twin
    assert out["recompute_worst"] == 0.0 and out["harness_splits"] == []
    assert out["recompute_noise"] < 0.01
    assert out["tower_rel"] <= 1e-5 and out["replica_rel"] <= 1e-4 \
        < out["fault_b_rel"]
    for noise, gap_a, gap_b in out["faults"]["rows"]:
        assert noise < 0.01 < gap_a and noise < 0.01 < gap_b
    assert out["worst_score_rel"] <= 1e-4
    assert out["A"]["payload"]["msd_stats"]["accept_steps"] > 0
    assert out["B"]["payload"]["msd_stats"]["accept_steps"] == 0
