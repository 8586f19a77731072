"""The port's Qwen2-VL vision tower (``models/qwen2vl_vision``) and its
checkpoint I/O (``utils/weights.load_qwen2_vl`` / ``save_qwen2_vl``)
against the JAX package's and HF's, on tiny fp32 configs on the CPU.

Tower outputs within 1e-5 of JAX's (the same weights carried across) and
within the JAX package's golden tolerance of HF's
``Qwen2VisionTransformerPretrainedModel`` (atol 2e-4, rtol 2e-3; nothing
downloaded); patch rows, rotary tables and loaded parameters EQUAL.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu.models import qwen2vl as JQ
from msd_tpu.models import qwen2vl_vision as JV
from msd_tpu.utils import weights as JW
from msd_tpu_torch import bridge
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.models import qwen2vl_vision as TV
from msd_tpu_torch.utils import weights as TW
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_qwen_model import QKW, _host, jax_qwen_params

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(np.asarray(a), copy=True))


def jax_vision_params(cfg, seed=0):
    """JAX tower params with non-trivial norms and biases (its init makes
    them ones and zeros)."""
    p = JV.init_qwen_vision_params(jax.random.PRNGKey(seed), cfg)
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 32))

    def jitter(x, scale):
        return x + scale * jax.random.normal(next(keys), x.shape)

    p["blocks"] = {k: jitter(v, 0.05) if not k.endswith("_w") or
                   k.startswith("norm") else v
                   for k, v in p["blocks"].items()}
    for k in ("ln_q_w", "ln_q_b", "merge_fc1_b", "merge_fc2_b"):
        p[k] = jitter(p[k], 0.05)
    return p


def _hf_vision(cfg, seed=0):
    from transformers.models.qwen2_vl.configuration_qwen2_vl import \
        Qwen2VLVisionConfig
    from transformers.models.qwen2_vl.modeling_qwen2_vl import \
        Qwen2VisionTransformerPretrainedModel

    torch.manual_seed(seed)
    hf_cfg = Qwen2VLVisionConfig(
        embed_dim=cfg.embed_dim, depth=cfg.depth, num_heads=cfg.num_heads,
        mlp_ratio=cfg.mlp_ratio, in_channels=cfg.in_channels,
        hidden_size=cfg.hidden_size, patch_size=cfg.patch_size,
        spatial_merge_size=cfg.spatial_merge_size,
        temporal_patch_size=cfg.temporal_patch_size)
    hf_cfg._attn_implementation = "eager"
    return Qwen2VisionTransformerPretrainedModel(hf_cfg).eval()


def test_vision_config_matches_jax():
    for jc, tc in ((JV.Qwen2VisionConfig(), TV.Qwen2VisionConfig()),
                   (JV.Qwen2VisionConfig.tiny(), TV.Qwen2VisionConfig.tiny())):
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert (jc.head_dim, jc.mlp_hidden) == (tc.head_dim, tc.mlp_hidden)
    c = TV.Qwen2VisionConfig()
    assert (c.embed_dim, c.depth, c.num_heads, c.patch_size,
            c.temporal_patch_size, c.spatial_merge_size) == \
        (1280, 32, 16, 14, 2, 2)


@pytest.mark.parametrize("grid", [(4, 4), (2, 6), (6, 4)])
def test_window_major_patches_match_jax(grid):
    """[3, H, W] -> 2x2-window-major patch rows, the frame repeated over
    the temporal axis: equal to JAX's."""
    cfg = TV.Qwen2VisionConfig.tiny()
    px = np.random.default_rng(sum(grid)).normal(
        size=(3, grid[0] * 14, grid[1] * 14)).astype(np.float32)
    np.testing.assert_array_equal(
        TV.window_major_patches(_t(px), cfg).numpy(),
        np.asarray(JV.window_major_patches(jnp.asarray(px), cfg)))


def test_patch_order_matches_hf_processor():
    """The patch rows equal ``Qwen2VLImageProcessor``'s (no resize, no
    normalisation), the JAX package's tests/test_qwen_vision.py check."""
    from transformers.models.qwen2_vl.image_processing_qwen2_vl import \
        Qwen2VLImageProcessor

    cfg = TV.Qwen2VisionConfig()
    img = np.random.default_rng(1).integers(0, 255, size=(56, 56, 3),
                                            dtype=np.uint8)
    out = Qwen2VLImageProcessor(do_resize=False, do_rescale=True,
                                do_normalize=False)(images=[img],
                                                    return_tensors="np")
    assert list(out["image_grid_thw"][0]) == [1, 4, 4]
    pixels = (img.astype(np.float32) / 255.0).transpose(2, 0, 1)
    np.testing.assert_allclose(
        TV.window_major_patches(_t(pixels), cfg).numpy(),
        out["pixel_values"], atol=1e-6)


@pytest.mark.parametrize("grid", [(4, 4), (2, 6)])
def test_vision_rotary_matches_jax(grid):
    cfg = TV.Qwen2VisionConfig.tiny()
    tc, ts = TV.vision_rotary(cfg, *grid, device="cpu")
    jc, js = JV.vision_rotary(JV.Qwen2VisionConfig.tiny(), *grid)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("grid", [(4, 4), (2, 6), (6, 4)])
def test_vision_encode_matches_jax(grid):
    """``qwen_vision_encode`` over the JAX tower's weights carried across:
    the merged rows [gh*gw/4, hidden] within 1e-5 of JAX's."""
    jcfg = JV.Qwen2VisionConfig.tiny(embed=32, depth=2, heads=4, hidden=48)
    tcfg = TV.Qwen2VisionConfig.tiny(embed=32, depth=2, heads=4, hidden=48)
    jp = jax_vision_params(jcfg)
    px = np.random.default_rng(3).normal(
        size=(3, grid[0] * 14, grid[1] * 14)).astype(np.float32)
    want = np.asarray(JV.qwen_vision_encode(jp, jcfg, jnp.asarray(px)))
    got = TV.qwen_vision_encode(bridge.to_torch(_host(jp), "cpu"), tcfg,
                                _t(px))
    assert got.shape == (grid[0] * grid[1] // 4, 48)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)


def test_vision_encode_matches_hf():
    """The tower from a HF ``Qwen2VisionTransformerPretrainedModel`` state
    (``params_from_hf_qwen_vision``) gives HF's merged rows; the imported
    params equal JAX's importer's."""
    cfg = TV.Qwen2VisionConfig.tiny(embed=32, depth=2, heads=4, hidden=48)
    hf = _hf_vision(cfg)
    state = {k: v.detach().float() for k, v in hf.state_dict().items()}
    params = TV.params_from_hf_qwen_vision(state, cfg, prefix="",
                                           device="cpu")
    jparams = JV.params_from_hf_qwen_vision(
        {k: v.numpy() for k, v in state.items()},
        JV.Qwen2VisionConfig.tiny(embed=32, depth=2, heads=4, hidden=48),
        prefix="")
    flat_t, flat_j = bridge.flatten(bridge.to_numpy(params)), \
        bridge.flatten(_host(jparams))
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_j.items():
        np.testing.assert_array_equal(flat_t[k], v, err_msg=k)
    px = np.random.default_rng(0).normal(size=(3, 56, 56)).astype(np.float32)
    patches = TV.window_major_patches(_t(px), cfg)
    with torch.no_grad():
        ref = hf(patches, grid_thw=torch.tensor([[1, 4, 4]])).numpy()
    got = TV.qwen_vision_encode(params, cfg, _t(px)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


def test_vision_init_is_seeded_and_shaped():
    """``init_qwen_vision_params``: the JAX layout's shapes, the same
    weights from the same seed, ones and zeros where JAX puts them."""
    cfg = TV.Qwen2VisionConfig.tiny()
    jshapes = jax.tree.map(lambda x: x.shape, JV.init_qwen_vision_params(
        jax.random.PRNGKey(0), JV.Qwen2VisionConfig.tiny()))
    a, b = (TV.init_qwen_vision_params(
        cfg, torch.Generator().manual_seed(1), "cpu", torch.float32)
        for _ in range(2))
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    assert {k: tuple(v.shape) for k, v in fa.items()} == \
        {k: tuple(v) for k, v in bridge.flatten(jshapes).items()}
    assert all(torch.equal(fa[k], fb[k]) for k in fa)
    assert torch.all(fa["blocks/norm1_w"] == 1) and \
        torch.all(fa["merge_fc2_b"] == 0)


def test_qwen_vl_v1_still_raises_naming_m15b():
    """Qwen-VL v1 (``qwen_vl_eagle``) is not ported: each of its entry
    points raises, naming M15b (videos are ported:
    tests/test_torch_qwen_video.py)."""
    from msd_tpu_torch.harness.models import qwen2_vl_msd as TQA
    from msd_tpu_torch.harness.registry import get_model

    cls = get_model("qwen_vl_eagle")
    assert cls is TQA.QwenVLEagle
    for call in (lambda: cls(None, None), lambda: cls.from_tiny(),
                 lambda: cls.from_pretrained("a", "b")):
        with pytest.raises(NotImplementedError, match="M15b"):
            call()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def write_tiny_qwen2_vl(path, seed=0):
    """A tiny fp32 Qwen2-VL checkpoint written by ``save_qwen2_vl`` from
    JAX weights carried across (so both packages can read it: the JAX
    loader's safetensors.numpy holds no bf16). Returns (JAX LM params,
    JAX tower params, the port's text and vision configs)."""
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    tv = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    jlm = jax_qwen_params(JQ.Qwen2VLTextConfig.tiny(**QKW), seed)
    jvis = jax_vision_params(JV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size),
                             seed)
    TW.save_qwen2_vl(bridge.to_torch(_host(jlm), "cpu"),
                     bridge.to_torch(_host(jvis), "cpu"), tq, tv, path,
                     torch.float32)
    return jlm, jvis, tq, tv


def test_load_qwen2_vl_matches_jax_bitwise(tmp_path):
    """A checkpoint written by ``save_qwen2_vl`` (HF layout: ``model.*``
    with q/k/v biases, ``lm_head.weight``, ``visual.*``, config.json with
    ``rope_scaling.mrope_section`` and ``vision_config``): the port's
    ``load_qwen2_vl`` and JAX's give the same configs and bitwise the same
    parameters, which are the weights written."""
    jlm, jvis, tq, tv = write_tiny_qwen2_vl(str(tmp_path))
    with open(tmp_path / "config.json") as f:
        cfg = json.load(f)
    assert cfg["rope_scaling"]["mrope_section"] == list(tq.mrope_section)
    assert cfg["vision_config"]["embed_dim"] == tv.embed_dim
    lm, vis, tq2, tv2 = TW.load_qwen2_vl(str(tmp_path), torch.float32, "cpu")
    jlm2, jvis2, jq2, jv2 = JW.load_qwen2_vl(str(tmp_path), jnp.float32)
    assert (tq2, tv2) == (tq, tv)
    assert dataclasses.asdict(jq2) == dataclasses.asdict(tq2)
    assert dataclasses.asdict(jv2) == dataclasses.asdict(tv2)
    for mine, theirs, written in ((lm, jlm2, jlm), (vis, jvis2, jvis)):
        ft = bridge.flatten(bridge.to_numpy(mine))
        fj = bridge.flatten(_host(theirs))
        fw = bridge.flatten(_host(written))
        assert ft.keys() == fj.keys() == fw.keys()
        for k in fj:
            np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
            np.testing.assert_array_equal(ft[k], fw[k], err_msg=k)


def test_save_qwen2_vl_shards_and_bf16(tmp_path, monkeypatch):
    """bf16 shards of at most SHARD_BYTES with an index that names every
    tensor once; read back, every tensor is the bf16 cast of the one
    written."""
    monkeypatch.setattr(TW, "SHARD_BYTES", 60_000)
    g = torch.Generator().manual_seed(0)
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    tv = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    lm = TQ.init_qwen2_params(tq, g, "cpu", torch.float32)
    for name in ("q_bias", "k_bias", "v_bias"):
        lm["layers"][name].normal_(0.0, 0.1, generator=g)
    vis = TV.init_qwen_vision_params(tv, g, "cpu", torch.float32)
    TW.save_qwen2_vl(lm, vis, tq, tv, str(tmp_path), torch.bfloat16)
    shards = [f for f in os.listdir(tmp_path) if f.endswith(".safetensors")]
    assert len(shards) > 1
    with open(tmp_path / "model.safetensors.index.json") as f:
        index = json.load(f)
    assert set(index["weight_map"].values()) == set(shards)
    lm2, vis2, _, _ = TW.load_qwen2_vl(str(tmp_path), torch.bfloat16, "cpu")
    for mine, ref in ((lm2, lm), (vis2, vis)):
        fm, fr = bridge.flatten(mine), bridge.flatten(ref)
        assert fm.keys() == fr.keys()
        assert all(torch.equal(fm[k], fr[k].to(torch.bfloat16)) for k in fr)


def test_load_draft_at_qwen_width(tmp_path):
    """``load_draft(..., base_embed=...)`` of a GQA draft with medusa heads
    at a Qwen config: the target's embedding shared, the layers and heads
    as saved."""
    from msd_tpu_torch.configs import DraftConfig
    from msd_tpu_torch.models import draft as D

    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    lc = tq.as_llama()
    g = torch.Generator().manual_seed(0)
    dcfg = DraftConfig(text=lc, medusa_heads=3)
    dp = D.init_draft_params(dcfg, g, "cpu", torch.float32)
    dp["medusa"] = D.init_medusa_params(dcfg, g, "cpu", torch.float32)
    TW.save_draft(dp, str(tmp_path))
    embed = torch.randn(lc.vocab_size, lc.hidden_size, generator=g)
    got, dcfg2 = TW.load_draft(str(tmp_path), lc, base_embed=embed,
                               dtype=torch.float32, device="cpu")
    assert dcfg2 == dcfg and got["embed_tokens"] is embed
    assert got["layers"]["k_proj"].shape == (1, 2 * 16, 64)
    for k in ("fc_w", "fc_b"):
        assert torch.equal(got[k], dp[k])
    assert torch.equal(got["medusa"]["mw"], dp["medusa"]["mw"])
