"""The port's multi-visual LLaVA paths against the JAX package's, on the
CPU: the native image prep (``utils/native.py``), anyres tiling
(``utils/mm_utils``) and merging (``models/llava``), multi-image fusion,
and the prefused prefills through ``generate`` and ``naive_generate``.

Host functions and layouts must be EQUAL; the native prep bitwise (both
packages build the same C++ source with g++ here). Generation runs on tiny
fp32 weights carried across (``tests/test_torch_engine._bundle``): tokens
and acceptance statistics EQUAL to JAX's, the port's MSD equal to its AR
baseline, and one image through the prefused path equal to the standard
path.
"""

import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.models import llava as JL
from msd_tpu.utils import mm_utils as JMM
from msd_tpu_torch.models import llava as TL
from msd_tpu_torch.utils import mm_utils as TMM
from msd_tpu_torch.utils import native as TN
from tests.test_torch_engine import N_IMG, _bundle, _prompts
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

MAX_NEW = 48


def jax_native():
    """The JAX package's native image prep, loaded. It builds its library
    in place (``csrc/libmsdnative.so``) at first use, where another test
    process may be writing it at the same moment, and then falls back to
    PIL for the rest of the process. The test processes that call this
    build it one at a time (a file lock), and the load is retried until
    the library is whole, so the JAX side of a comparison runs its
    default path."""
    import fcntl
    import tempfile

    from msd_tpu.utils import native as JN

    lock = os.path.join(tempfile.gettempdir(), "msd_tpu_native_build.lock")
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            for _ in range(60):
                if JN._load() is not None:
                    return JN
                JN._tried = False
                time.sleep(1.0)
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
    raise AssertionError("the JAX package's native image prep did not load")


def _image(rng, h, w):
    return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)


# ---------------------------------------------------------------------------
# the native image prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(28, 28), (20, 36), (41, 17), (9, 9),
                                   (336, 224)])
@pytest.mark.parametrize("pad_square", [True, False])
def test_process_image_default_is_jax_native_bitwise(shape, pad_square):
    """``process_image``'s default (native) prep equals the JAX package's
    default, bitwise, from arrays, grey arrays and PIL images."""
    jax_native()
    img = _image(np.random.default_rng(sum(shape)), *shape)
    for size in (28, 14, 336):
        got = TMM.process_image(img, size, pad_square=pad_square)
        ref = JMM.process_image(img, size, pad_square=pad_square)
        assert got.dtype == np.float32 and got.shape == (3, size, size)
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        TMM.process_image(img[..., 1], 28, pad_square),
        JMM.process_image(img[..., 1], 28, pad_square))
    np.testing.assert_array_equal(
        TMM.process_image(Image.fromarray(img), 28, pad_square),
        JMM.process_image(Image.fromarray(img), 28, pad_square))


def test_native_prep_departs_from_pil():
    """The native prep is not the PIL path: it pads with the unrounded
    mean colour and rounds some resampled pixels otherwise, so the default
    cannot be the PIL path in disguise; the two stay close on average."""
    img = _image(np.random.default_rng(5), 97, 61)
    native = TMM.process_image(img, 336)
    pil = TMM.process_image(img, 336, use_native=False)
    assert native.shape == pil.shape and not np.array_equal(native, pil)
    assert np.abs(native - pil).mean() < 0.02


def test_native_prep_raises_instead_of_falling_back(tmp_path, monkeypatch):
    """A library that does not build (a broken source, then no g++)
    raises from the default ``process_image``; nothing falls back to PIL.
    ``use_native=False`` still runs the PIL path."""
    img = _image(np.random.default_rng(2), 30, 40)
    bad = tmp_path / "image_prep.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(TN, "SOURCE", bad)
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path / "_build")
    TN._library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="did not build"):
            TMM.process_image(img, 28)
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            TMM.process_image(img, 28)
        np.testing.assert_array_equal(
            TMM.process_image(img, 28, use_native=False),
            JMM.process_image(img, 28, use_native=False))
    finally:
        TN._library.cache_clear()


def test_native_library_builds_once_into_build_dir():
    """The library is built under ``msd_tpu_torch/_build/`` with a name
    that carries the source's hash, and a second call finds it."""
    lib = TN.build_library()
    assert lib.parent == TN.BUILD_DIR and lib.exists()
    assert lib.name.startswith("libimage_prep_")
    assert TN.build_library() == lib
    from msd_tpu.utils import native as JN

    with open(os.path.join(JN._CSRC, "image_prep.cpp"), "rb") as f:
        assert f.read() == TN.SOURCE.read_bytes()


# ---------------------------------------------------------------------------
# anyres tiling and merge
# ---------------------------------------------------------------------------

SIZES = [(1008, 672), (672, 1008), (336, 336), (500, 300), (300, 500),
         (1000, 1000), (100, 900), (1200, 400), (13, 7)]


@pytest.mark.parametrize("size", SIZES)
def test_select_best_resolution_and_grid_match_jax(size):
    pins = JMM.DEFAULT_GRID_PINPOINTS
    assert TMM.DEFAULT_GRID_PINPOINTS == pins
    assert TMM.select_best_resolution(size, pins) == \
        JMM.select_best_resolution(size, pins)
    for patch in (336, 224):
        assert TMM.get_anyres_image_grid_shape(size, pins, patch) == \
            JMM.get_anyres_image_grid_shape(size, pins, patch)
    odd = ((28, 56), (56, 28), (56, 56), (84, 28))
    assert TMM.select_best_resolution(size, odd) == \
        JMM.select_best_resolution(size, odd)


@pytest.mark.parametrize("hw", [(56, 84), (84, 56), (28, 28), (33, 70)])
def test_divide_to_patches_matches_jax(hw):
    img = _image(np.random.default_rng(hw[0]), *hw)
    for p in (28, 14):
        got, ref = TMM.divide_to_patches(img, p), JMM.divide_to_patches(img, p)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw,target", [((30, 50), (56, 28)),
                                       ((50, 30), (56, 28)),
                                       ((40, 40), (84, 28)),
                                       ((672, 1008), (1008, 672)),
                                       ((17, 90), (56, 56))])
def test_resize_and_pad_image_matches_jax(hw, target):
    img = _image(np.random.default_rng(hw[1]), *hw)
    got = TMM.resize_and_pad_image(img, target)
    assert got.dtype == np.uint8 and got.shape == (target[1], target[0], 3)
    np.testing.assert_array_equal(got, JMM.resize_and_pad_image(img, target))


@pytest.mark.parametrize("hw", [(40, 70), (70, 40), (56, 56), (30, 90)])
def test_process_anyres_image_matches_jax_native_bitwise(hw):
    """The base view, then the best grid's tiles, each through the native
    prep on both sides: EQUAL."""
    jax_native()
    img = _image(np.random.default_rng(sum(hw)), *hw)
    pins = ((28, 56), (56, 28), (56, 56), (84, 28), (28, 84))
    got = TMM.process_anyres_image(img, 28, pins)
    ref = JMM.process_anyres_image(img, 28, pins)
    w, h = TMM.select_best_resolution((hw[1], hw[0]), pins)
    assert got.shape == (1 + (w // 28) * (h // 28), 3, 28, 28)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        TMM.process_anyres_image(Image.fromarray(img), 28, pins), ref)


@pytest.mark.parametrize("grid,size", [((6, 4), (30, 20)), ((4, 6), (20, 30)),
                                       ((4, 4), (50, 50)), ((6, 6), (37, 11)),
                                       ((5, 8), (8, 5)), ((4, 6), (21, 20))])
def test_unpad_feature_grid_matches_jax(grid, size):
    g = np.random.default_rng(0).normal(size=grid + (3,)).astype(np.float32)
    got = TL.unpad_feature_grid(torch.from_numpy(g), size)
    np.testing.assert_array_equal(got.numpy(),
                                  JL.unpad_feature_grid(g, size))


@pytest.mark.parametrize("mode", ["spatial", "spatial_unpad", "flat"])
@pytest.mark.parametrize("newline", [False, True])
@pytest.mark.parametrize("case", [((2, 2), (100, 60)), ((2, 1), (90, 40)),
                                  ((1, 3), (30, 100)), ((1, 1), (50, 50)),
                                  (None, (40, 40))])
def test_merge_anyres_features_matches_jax(mode, newline, case):
    """Every merge mode, with and without the newline separator, over
    grids of 1-4 tiles and the base view alone: EQUAL rows."""
    grid, size = case
    s, H = 2, 6
    n_tiles = 0 if grid is None else grid[0] * grid[1]
    rng = np.random.default_rng(n_tiles + len(mode))
    feats = rng.normal(size=(1 + n_tiles, s * s, H)).astype(np.float32)
    nl = rng.normal(size=(H,)).astype(np.float32) if newline else None
    ref = JL.merge_anyres_features(feats, grid or (1, 1), size, s,
                                   image_newline=nl, mode=mode)
    got = TL.merge_anyres_features(
        torch.from_numpy(feats), grid or (1, 1), size, s,
        image_newline=None if nl is None else torch.from_numpy(nl),
        mode=mode)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_merge_anyres_refuses_a_wrong_grid():
    feats = torch.zeros(4, 4, 3)
    with pytest.raises(ValueError, match="tiles"):
        TL.merge_anyres_features(feats, (2, 2), (10, 10), 2)


# ---------------------------------------------------------------------------
# multi-image fusion
# ---------------------------------------------------------------------------

def _multi_ids(rng, vocab, n, spots):
    ids = rng.integers(3, vocab - 1, size=n).astype(np.int32)
    ids[list(spots)] = JC.IMAGE_TOKEN_INDEX
    return ids


@pytest.mark.parametrize("spots,sizes", [((), ()), ((1,), (8,)),
                                         ((1, 6), (8, 5)),
                                         ((0, 1, 12), (3, 0, 4)),
                                         ((12,), (6,)), ((2, 3), (1, 7))])
def test_fuse_embeddings_multi_layout_matches_jax(spots, sizes):
    """The fused rows, expanded ids (0 at image rows) and image-row mask
    of 0-3 images anywhere (first, adjacent, last; an empty block): EQUAL
    to JAX's host fusion, the features cast to the table's dtype."""
    rng = np.random.default_rng(len(spots))
    table = rng.normal(size=(40, 6)).astype(np.float32)
    ids = _multi_ids(rng, 40, 13, spots)
    ids[ids == 7] = -3                        # a negative text id clamps
    feats = [rng.normal(size=(n, 6)).astype(np.float64) for n in sizes]
    ref = JL.fuse_embeddings_multi(table, ids, feats)
    params = {"embed_tokens": torch.from_numpy(table)}
    got = TL.fuse_embeddings_multi(params, ids,
                                   [torch.from_numpy(f) for f in feats])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="feature blocks"):
        TL.fuse_embeddings_multi(params, ids,
                                 [torch.zeros(2, 6)] * (len(spots) + 1))


@pytest.fixture(scope="module")
def mha():
    return _bundle()


def _blocks(rng, sizes, h=64):
    return [rng.normal(size=(n, h)).astype(np.float32) * 0.1 for n in sizes]


def _anyres_block(rng, h=64):
    """An anyres image's merged rows: a 2x2 grid of 2x2-patch tiles plus
    the base view, unpadded for a 100x60 image, with a newline column."""
    s = 2
    tiles = rng.normal(size=(5, s * s, h)).astype(np.float32) * 0.1
    nl = rng.normal(size=(h,)).astype(np.float32) * 0.1
    return JL.merge_anyres_features(tiles, (2, 2), (100, 60), s,
                                    image_newline=nl, mode="spatial_unpad")


CASES = {"two images": ((1, 9), (N_IMG, 5)), "three images": ((0, 4, 12),
                                                               (3, 6, 4)),
         "anyres": ((2,), None), "no image": ((), ())}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("draft", ["msd", "echo"])
def test_multi_image_generate_matches_jax_and_ar(mha, case, draft):
    """``generate`` and ``naive_generate`` with a list of feature blocks
    (the prefused prefills): tokens and acceptance statistics EQUAL to
    JAX's; the port's MSD equal to its AR baseline and its null draft."""
    jgen, tgen, drafts, tdrafts, jcfg = mha
    spots, sizes = CASES[case]
    rng = np.random.default_rng(len(case))
    ids = _multi_ids(rng, jcfg.vocab_size, 15, spots)
    blocks = [_anyres_block(rng)] if sizes is None else _blocks(rng, sizes)
    jgen.params = dict(jgen.params, draft=drafts[draft])
    tgen.params["draft"] = tdrafts[draft]
    jm = jgen.generate(ids, img_feats=[jnp.asarray(b) for b in blocks],
                       max_new_tokens=MAX_NEW)
    tfeats = [torch.from_numpy(b) for b in blocks]
    tm = tgen.generate(ids, img_feats=tfeats, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    assert (tm.accept_steps, tm.accept_len_sum) == \
        (jm.accept_steps, jm.accept_len_sum)
    np.testing.assert_array_equal(tm.alpha_hist, jm.alpha_hist)
    ja = jgen.naive_generate(ids, img_feats=[jnp.asarray(b) for b in blocks],
                             max_new_tokens=MAX_NEW)
    ta = tgen.naive_generate(ids, img_feats=tuple(tfeats),
                             max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(ta.tokens, ja.tokens)
    np.testing.assert_array_equal(tm.tokens, ta.tokens)
    tgen.params["draft"] = tdrafts["null"]
    tn = tgen.generate(ids, img_feats=tfeats, max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(tn.tokens, tm.tokens)
    assert len(tm.tokens) == MAX_NEW
    if draft == "echo":
        assert tm.alpha_hist[2:].sum() > 0, tm.alpha_hist


def test_collected_hiddens_of_a_multi_image_prompt_match_jax(mha):
    """A collecting multi-image run: the expanded ids (the fused layout)
    and the trajectory's hiddens as JAX's."""
    jgen, tgen, drafts, tdrafts, jcfg = mha
    rng = np.random.default_rng(11)
    ids = _multi_ids(rng, jcfg.vocab_size, 14, (3, 8))
    blocks = _blocks(rng, (N_IMG, 4))
    jgen.params = dict(jgen.params, draft=drafts["echo"])
    tgen.params["draft"] = tdrafts["echo"]
    jm = jgen.generate(ids, img_feats=[jnp.asarray(b) for b in blocks],
                       max_new_tokens=MAX_NEW, collect_hiddens=True)
    tm = tgen.generate(ids, img_feats=[torch.from_numpy(b) for b in blocks],
                       max_new_tokens=MAX_NEW, collect_hiddens=True)
    np.testing.assert_array_equal(tm.tokens, jm.tokens)
    np.testing.assert_array_equal(tm.exp_ids, jm.exp_ids)
    assert tm.traj_hidden.shape == jm.traj_hidden.shape == \
        (14 - 2 + N_IMG + 4 + tm.accept_len_sum, 64)
    np.testing.assert_allclose(tm.traj_hidden, jm.traj_hidden, atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("draft", ["msd", "echo"])
def test_one_image_prefused_equals_standard_path(mha, draft):
    """One image as a one-element list (fused beforehand, padded from e0)
    commits the tokens of the standard single-image path (padded before
    the expansion), MSD and AR alike."""
    jgen, tgen, drafts, tdrafts, jcfg = mha
    prompts, feats = _prompts(jcfg.vocab_size)
    tgen.params["draft"] = tdrafts[draft]
    f = torch.from_numpy(feats)
    for ids in prompts[:2]:
        std = tgen.generate(ids, img_feats=f, max_new_tokens=MAX_NEW)
        pre = tgen.generate(ids, img_feats=[f], max_new_tokens=MAX_NEW)
        np.testing.assert_array_equal(pre.tokens, std.tokens)
        assert (pre.accept_steps, pre.accept_len_sum) == \
            (std.accept_steps, std.accept_len_sum)
        np.testing.assert_array_equal(
            tgen.naive_generate(ids, img_feats=[f],
                                max_new_tokens=MAX_NEW).tokens,
            tgen.naive_generate(ids, img_feats=f,
                                max_new_tokens=MAX_NEW).tokens)


def test_multi_image_budget_and_refusals(mha):
    """The fused length must stay below max_seq_len - nodes - path - 2
    (JAX's error); a pinned first token and share_prefill are refused
    for a list of images, as in JAX."""
    jgen, tgen, drafts, tdrafts, jcfg = mha
    st = tgen._statics(0)
    limit = st.step_limit
    rng = np.random.default_rng(3)
    ids = _multi_ids(rng, jcfg.vocab_size, 10, (1, 5))
    fits = _blocks(rng, (limit - 9, 0))
    over = _blocks(rng, (limit - 8, 0))
    with pytest.raises(ValueError, match="multi-image prompt too long"):
        tgen.generate(ids, img_feats=[torch.from_numpy(b) for b in over],
                      max_new_tokens=4)
    with pytest.raises(ValueError, match="multi-image prompt too long"):
        jgen.generate(ids, img_feats=[jnp.asarray(b) for b in over],
                      max_new_tokens=4)
    fused, exp_ids, rows, e0, img_pos = tgen._fuse_multi(
        ids, [torch.from_numpy(b) for b in fits])
    m = tgen.eng.prompt_pad_multiple
    assert e0 == limit - 1 and fused.shape[0] == -(-e0 // m) * m
    assert img_pos == 1 and int(rows.sum()) == limit - 9
    assert exp_ids.shape == rows.shape == (fused.shape[0],)
    _, _, rows, e0, img_pos = tgen._fuse_multi(
        ids, [torch.zeros(0, 64), torch.zeros(2, 64)])
    assert (e0, img_pos) == (10, 4) and int(rows.sum()) == 2
    one = [torch.from_numpy(b) for b in _blocks(rng, (3, 2))]
    with pytest.raises(ValueError, match="first_token"):
        tgen.generate(ids, img_feats=one, first_token=5)
    with pytest.raises(ValueError, match="share_prefill"):
        tgen.naive_generate(ids, img_feats=one, share_prefill=True)


def test_smoke_multi_phase_at_tiny_size():
    """chip_smoke's [multi] phase on the CPU at a tiny width, over the
    tiny main path and a 56px CLIP tower: two images, anyres ('spatial_
    unpad' with a newline, 70 rows), S2 at (56, 112, 168) and one image
    prefused and standard; MSD == eager == null draft == AR (fp32: no
    split), every committed token the recompute's argmax, and the planted
    first image's block at both placeholders rejected. The phase raises
    otherwise."""
    import dataclasses

    import chip_smoke
    from msd_tpu_torch import configs as TC
    from msd_tpu_torch.models import clip_vit as CV

    cfg = dataclasses.replace(
        TC.LlamaConfig.tiny(vocab_size=512, hidden_size=256, layers=2,
                            heads=2, intermediate_size=512, max_pos=2048),
        residual_dtype="float32")
    res = chip_smoke.run_main_path(cfg, (4, 3, 2, 2, 1), 384, 24, 16, 20,
                                   device="cpu", dtype=torch.float32)
    vcfg = TC.ClipVisionConfig.tiny(image_size=56)
    lcfg = TC.LlavaConfig(text=cfg, vision=vcfg)
    g = torch.Generator().manual_seed(7)
    serve = {"llava": {"vision": CV.init_clip_params(vcfg, g, "cpu",
                                                     torch.float32),
                       "projector": TL.init_projector_params(
                           lcfg, g, "cpu", torch.float32)},
             "lcfg": lcfg}
    out = chip_smoke.run_multi(res, serve, max_seq=384, max_new=12)
    assert out["launches"] == 0 and out["ar_decoded"] == 4 * 11
    assert out["fault"]["by_a"] > 0 and out["fault"]["by_b"] > 0
    assert set(out["prefill_ms"]) == {"a", "b", "c", "d", "d standard"}
