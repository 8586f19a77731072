"""The port's Qwen2-VL video path against the JAX package's, on tiny fp32
configs on the CPU: the tower (``models/qwen2vl_vision``:
``window_major_patches_video``, ``vision_rotary`` over ``grid_t``,
``qwen_vision_encode_video``, attention per temporal block) and the
adapter (``harness/models/qwen2_vl_msd``: ``sample_frames``,
``_decode_video_file``, ``load_video_frames``, ``video_gen``,
``_encode_video`` and the <|video_pad|> routing).

Patch rows, rotary tables and frame indices EQUAL; the tower's rows within
1e-5 of JAX's (JAX at ``highest`` matmul precision) and within the JAX
package's golden tolerance of HF's; the adapter's video tokens EQUAL to
JAX's adapter's on weights carried across.
"""

import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.engine.generator import MSDGenerator as JGen
from msd_tpu.harness.models import qwen2_vl_msd as JQA
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import draft as JD
from msd_tpu.models import qwen2vl as JQ
from msd_tpu.models import qwen2vl_vision as JV
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.engine.generator import MSDGenerator as TGen
from msd_tpu_torch.harness.models import qwen2_vl_msd as TQA
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer
from msd_tpu_torch.models import qwen2vl as TQ
from msd_tpu_torch.models import qwen2vl_vision as TV
from tests.test_torch_anyres_multi import jax_native
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_qwen_model import _host, jax_qwen_params
from tests.test_torch_qwen_vision import _hf_vision, jax_vision_params

ATOL = 1e-5
VCFG = dict(embed=32, depth=2, heads=4, hidden=48)


def _frames(t, h=56, w=28, seed=0):
    return np.random.default_rng(seed + t).normal(
        size=(t, 3, h, w)).astype(np.float32)


def _video(t, h=56, w=56, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(t, h, w, 3),
                                                dtype=np.uint8)


@pytest.fixture(scope="module")
def tower():
    jcfg = JV.Qwen2VisionConfig.tiny(**VCFG)
    jp = jax_vision_params(jcfg)
    return (jcfg, jp, TV.Qwen2VisionConfig.tiny(**VCFG),
            bridge.to_torch(_host(jp), "cpu"))


# ---------------------------------------------------------------------------
# the tower
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 2, 4, 5])
@pytest.mark.parametrize("hw", [(56, 28), (28, 56)])
def test_window_major_patches_video_match_jax(t, hw):
    """[T, 3, H, W] -> temporal blocks of 2 frames, an odd tail repeating
    the last frame, each block's rows window-major: EQUAL to JAX's."""
    cfg = TV.Qwen2VisionConfig.tiny()
    fr = _frames(t, *hw)
    got = TV.window_major_patches_video(torch.from_numpy(fr), cfg)
    ref = np.asarray(JV.window_major_patches_video(jnp.asarray(fr), cfg))
    assert got.shape == (-(-t // 2) * hw[0] * hw[1] // 196, 3 * 2 * 196)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_one_frame_video_rows_are_the_image_rows():
    """A one-frame video repeats its frame over the temporal axis: the
    image's patch rows."""
    cfg = TV.Qwen2VisionConfig.tiny()
    fr = torch.from_numpy(_frames(1))
    np.testing.assert_array_equal(
        TV.window_major_patches_video(fr, cfg).numpy(),
        TV.window_major_patches(fr[0], cfg).numpy())


@pytest.mark.parametrize("grid_t", [1, 2, 3])
@pytest.mark.parametrize("grid", [(4, 4), (2, 6)])
def test_vision_rotary_over_grid_t_matches_jax(grid_t, grid):
    cfg = TV.Qwen2VisionConfig.tiny()
    tc, ts = TV.vision_rotary(cfg, *grid, grid_t=grid_t, device="cpu")
    jc, js = JV.vision_rotary(JV.Qwen2VisionConfig.tiny(), *grid,
                              grid_t=grid_t)
    assert tc.shape == (grid_t * grid[0] * grid[1], cfg.head_dim)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("t", [4, 5])
def test_video_encode_matches_jax(tower, t):
    """``qwen_vision_encode_video`` at 4 and 5 frames (grid_t 2 and 3):
    the merged rows within 1e-5 of JAX's dense block-diagonal version."""
    jcfg, jp, tcfg, tp = tower
    fr = _frames(t)
    ref = np.asarray(JV.qwen_vision_encode_video(jp, jcfg, jnp.asarray(fr)))
    got = TV.qwen_vision_encode_video(tp, tcfg, torch.from_numpy(fr))
    assert got.shape == (-(-t // 2) * 4 * 2 // 4, 48)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)


def test_video_attention_stays_within_temporal_blocks(tower):
    """The video's rows equal each temporal block encoded alone (the
    block-per-block plain version) and differ from a full-attention pass
    over all blocks."""
    _, _, tcfg, tp = tower
    fr = torch.from_numpy(_frames(6))
    got = TV.qwen_vision_encode_video(tp, tcfg, fr)
    x = TV.window_major_patches_video(fr, tcfg) @ tp["patch_embed"]
    m = 4 * 2
    plain = torch.cat([TV._encode_core(tp, tcfg, x[i * m:(i + 1) * m], 1,
                                       4, 2) for i in range(3)])
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                               rtol=1e-6)
    cos, sin = TV.vision_rotary(tcfg, 4, 2, grid_t=3, device="cpu")
    full = x
    for i in range(tcfg.depth):
        full = TV._block({k: w[i] for k, w in tp["blocks"].items()}, tcfg,
                         full, cos[:, None], sin[:, None], 1)
    full = TV.merge(tp, tcfg, full)
    assert np.abs(full.numpy() - got.numpy()).max() > 1e-3


def test_video_encode_matches_hf():
    """The port's video rows equal HF's ``Qwen2VisionTransformer``
    (grid_thw [[3, 4, 4]], cu_seqlens attention per temporal block) within
    the JAX package's golden tolerance."""
    cfg = TV.Qwen2VisionConfig.tiny(embed=32, depth=2, heads=4, hidden=48)
    hf = _hf_vision(cfg, seed=3)
    state = {k: v.detach().float() for k, v in hf.state_dict().items()}
    params = TV.params_from_hf_qwen_vision(state, cfg, prefix="",
                                           device="cpu")
    fr = torch.from_numpy(_frames(5, 56, 56))
    patches = TV.window_major_patches_video(fr, cfg)
    with torch.no_grad():
        ref = hf(patches, grid_thw=torch.tensor([[3, 4, 4]])).numpy()
    got = TV.qwen_vision_encode_video(params, cfg, fr).numpy()
    assert got.shape == ref.shape == (12, 48)
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("total,n", [(100, 32), (32, 32), (10, 32), (1, 8),
                                     (0, 4), (7, 4), (33, 2)])
def test_sample_frames_matches_jax(total, n):
    got = TQA.sample_frames(total, n)
    np.testing.assert_array_equal(got, JQA.sample_frames(total, n))
    assert len(got) == n


def test_load_video_frames_matches_jax():
    """An array, a ``{"video": ...}`` dict, a list of PIL frames and a
    list of arrays: the same sampled frames as JAX's loader."""
    vid = _video(11, 20, 24)
    inputs = [vid, {"video": vid}, [Image.fromarray(f) for f in vid],
              list(vid), {"video": [Image.fromarray(f) for f in vid[:3]]}]
    for visual in inputs:
        for n in (4, 8):
            got = TQA.load_video_frames(visual, n)
            np.testing.assert_array_equal(got,
                                          JQA.load_video_frames(visual, n))
            assert got.shape[0] == n and got.dtype == np.uint8


def test_decode_video_file_matches_jax(tmp_path, monkeypatch):
    """A video file decodes to JAX's frames (through OpenCV here, decord
    being absent); with no decoder both raise the same error."""
    cv2 = pytest.importorskip("cv2")
    path = str(tmp_path / "clip.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (32, 24))
    for f in _video(5, 24, 32, seed=3):
        writer.write(f)
    writer.release()
    monkeypatch.setitem(sys.modules, "decord", None)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    got = TQA._decode_video_file(path)
    assert got.shape == (5, 24, 32, 3)
    np.testing.assert_array_equal(got, JQA._decode_video_file(path))
    np.testing.assert_array_equal(TQA.load_video_frames(path, 3),
                                  JQA.load_video_frames(path, 3))
    monkeypatch.setitem(sys.modules, "cv2", None)
    for mod in (TQA, JQA):
        with pytest.raises(RuntimeError, match="no video decoder"):
            mod._decode_video_file(path)


# ---------------------------------------------------------------------------
# the adapter
# ---------------------------------------------------------------------------

V = 512
QKW = dict(vocab=V, hidden=64, layers=2, heads=4, kv_heads=2, inter=128)
GRID = (4, 4)
FRAMES = 4
TREE = dict(top_k=4, max_depth=4, num_nodes=12)


@pytest.fixture(scope="module")
def adapters():
    """make(use_msd) -> (port adapter, JAX adapter) over one set of tiny
    weights, each with its package's tower for images and videos."""
    jax_native()
    jq = JQ.Qwen2VLTextConfig.tiny(**QKW)
    tq = TQ.Qwen2VLTextConfig.tiny(**QKW)
    jtp = jax_qwen_params(jq, seed=2)
    dp = JD.init_draft_params(jax.random.PRNGKey(9),
                              JC.DraftConfig(text=jq.as_llama()))
    dp["embed_tokens"] = jtp["embed_tokens"]
    jvcfg = JV.Qwen2VisionConfig.tiny(hidden=jq.hidden_size)
    tvcfg = TV.Qwen2VisionConfig.tiny(hidden=tq.hidden_size)
    jvis = jax_vision_params(jvcfg, seed=4)
    eng = dict(max_seq_len=384, prompt_pad_multiple=64)
    n_img = (GRID[0] // 2) * (GRID[1] // 2)
    common = dict(n_img=n_img, eos_id=2, image_mode="inline",
                  mrope_section=jq.mrope_section)
    jgen = JGen(jtp, dp, jq.as_llama(), JC.DraftConfig(text=jq.as_llama()),
                JC.EngineConfig(tree=JC.TreeConfig(**TREE), **eng), **common)
    tgen = TGen(bridge.to_torch(_host(jtp), "cpu"),
                bridge.to_torch(_host(dp), "cpu"), tq.as_llama(),
                TC.DraftConfig(text=tq.as_llama()),
                TC.EngineConfig(tree=TC.TreeConfig(**TREE), **eng),
                device="cpu", **common)
    tvis = bridge.to_torch(_host(jvis), "cpu")
    jenc = jax.jit(lambda px: JV.qwen_vision_encode(jvis, jvcfg, px))
    jencv = jax.jit(lambda px: JV.qwen_vision_encode_video(jvis, jvcfg, px))

    def make(use_msd=True):
        mine = TQA.Qwen2VLMSD.from_qwen(tgen, SimpleTokenizer(V), tvis,
                                        tvcfg, img_grid=GRID,
                                        max_num_frames=FRAMES,
                                        use_msd=use_msd)
        theirs = JQA.Qwen2VLMSD(jgen, JTok(V), jenc, img_grid=GRID,
                                encode_video_fn=jencv,
                                max_num_frames=FRAMES, use_msd=use_msd)
        return mine, theirs
    return make


def test_video_gen_matches_jax_and_shares_the_weights(adapters):
    """``video_gen``: JAX's n_img (grid_t x merged grid) and max_seq_len
    (rounded up to 128 from n_vid + 512 + nodes + path), over the image
    generator's own target and draft tensors, made once."""
    mine, theirs = adapters()
    vg, jvg = mine.video_gen, theirs.video_gen
    assert vg.n_img == jvg.n_img == (FRAMES // 2) * 4
    assert vg.eng.max_seq_len == jvg.eng.max_seq_len == 640
    assert vg.eng.tree == mine.gen.eng.tree
    assert vg.image_mode == "inline" and vg.mrope_section == \
        mine.gen.mrope_section
    assert vg.params["target"] is mine.gen.params["target"]
    assert vg.params["draft"] is mine.gen.params["draft"]
    assert mine.video_gen is vg
    big = TQA.Qwen2VLMSD(vg, SimpleTokenizer(V), img_grid=GRID,
                         max_num_frames=2)
    assert big.video_gen.eng.max_seq_len == vg.eng.max_seq_len


@pytest.mark.parametrize("use_msd", [True, False])
def test_video_tokens_match_jax(adapters, use_msd):
    """A 7-frame video (sampled to 4) through both adapters: the same
    <|video_pad|> prompt and grid, video rows within 1e-5, and EQUAL
    tokens and responses; MSD == AR on the port."""
    mine, theirs = adapters(use_msd)
    vid = _video(7)
    gen, ids, feats, grid = mine._prep_request("what happens?", [vid])
    jgen, jids, jfeats, jgrid = theirs._prep_request("what happens?", [vid])
    assert gen is mine.video_gen and grid == jgrid == (2, 2, 2)
    np.testing.assert_array_equal(ids, jids)
    assert int((ids == TQ.VIDEO_PAD_ID).sum()) == gen.n_img == 8
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=ATOL,
                               rtol=ATOL)
    fn = gen.generate if use_msd else gen.naive_generate
    jfn = jgen.generate if use_msd else jgen.naive_generate
    out = fn(ids, img_feats=feats, max_new_tokens=12, img_grid=grid)
    ref = jfn(ids, img_feats=jnp.asarray(np.asarray(feats)),
              max_new_tokens=12, img_grid=grid)
    np.testing.assert_array_equal(out.tokens, ref.tokens)
    if use_msd:
        ar = gen.naive_generate(ids, img_feats=feats, max_new_tokens=12,
                                img_grid=grid)
        np.testing.assert_array_equal(out.tokens, ar.tokens)
    kw = {"max_new_tokens": 12}
    assert mine._generate_plain("what happens?", [{"video": vid}], kw) == \
        theirs._generate_plain("what happens?", [{"video": vid}], kw)


def test_images_still_take_the_image_generator(adapters):
    """An image visual keeps the image generator and <|image_pad|> span;
    scoring a video visual is refused."""
    mine, _ = adapters()
    img = _video(1)[0]
    gen, ids, feats, grid = mine._prep_request("what?", [img])
    assert gen is mine.gen and grid == (2, 2)
    assert int((ids == TQ.IMAGE_PAD_ID).sum()) == 4
    with pytest.raises(ValueError, match="video"):
        mine._encode_visual([_video(4)])


def test_tiny_adapter_runs_a_video():
    """``from_tiny``: 8 frames by default, the tower's video path, 16
    video rows on its video generator."""
    a = TQA.Qwen2VLMSD.from_tiny(device="cpu")
    assert a.max_num_frames == 8 and a.video_gen.n_img == 16
    out = a._generate_plain("describe", [_video(9)], {"max_new_tokens": 6})
    assert isinstance(out, str)
