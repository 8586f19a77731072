"""The port's S2 multi-scale CLIP tower (``models/clip_vit.clip_encode_s2``,
``resize_linear``; ``LlavaConfig.s2_scales``; the S2 branch of
``models/llava.encode_image``) against the JAX package's, on tiny fp32
configs on the CPU: features within 1e-5 (JAX at ``highest`` matmul
precision, as conftest sets it), the resize within 1e-5 of
``jax.image.resize(..., "linear")`` and its weights within 1e-7 (an ulp
of XLA's fused division) of JAX's ``scale_and_translate`` weights.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image import scale as jax_scale

from msd_tpu import configs as JC
from msd_tpu.models import clip_vit as JV
from msd_tpu.models import llava as JL
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.models import clip_vit as TV
from msd_tpu_torch.models import llava as TL
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _host(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tower():
    jc = JC.ClipVisionConfig.tiny()
    jp = JV.init_clip_params(jax.random.PRNGKey(3), jc)
    # non-trivial norms and biases (the init makes them ones and zeros)
    keys = iter(jax.random.split(jax.random.PRNGKey(4), 32))
    jp["layers"] = {k: v + 0.05 * jax.random.normal(next(keys), v.shape)
                    if k.endswith(("_b", "_bias", "_w")) else v
                    for k, v in jp["layers"].items()}
    return jc, jp, TC.ClipVisionConfig.tiny(), bridge.to_torch(_host(jp),
                                                               "cpu")


def test_s2_config_matches_jax():
    for scales in (None, (28, 56), (28, 56, 84), (336, 672, 1008)):
        j = JC.LlavaConfig(s2_scales=scales)
        t = TC.LlavaConfig(s2_scales=scales)
        assert t.mm_hidden_size == j.mm_hidden_size
        assert t.num_image_tokens == j.num_image_tokens
    assert TC.LlavaConfig(s2_scales=(336, 672, 1008)).mm_hidden_size == 3072


@pytest.mark.parametrize("n_in,n_out", [(84, 28), (84, 56), (56, 28),
                                        (1008, 336), (1008, 672), (28, 28),
                                        (60, 100), (97, 13)])
def test_resize_weights_equal_jax_scale_and_translate(n_in, n_out):
    ref = jax_scale.compute_weight_mat(
        n_in, n_out, jnp.float32(n_out / n_in), jnp.float32(0.0),
        jax_scale._fill_triangle_kernel, True)
    np.testing.assert_allclose(TV.resize_weights(n_in, n_out, "cpu").numpy(),
                               np.asarray(ref), atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("hw,size", [((84, 84), 28), ((84, 84), 56),
                                     ((56, 56), 28), ((84, 84), 84),
                                     ((42, 70), 28)])
def test_resize_linear_matches_jax(hw, size):
    """The antialiased linear downsample of ``jax.image.resize``; the
    identity at the image's own size."""
    x = np.random.default_rng(sum(hw)).normal(
        size=(3,) + hw).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (3, size, size),
                                      "linear"))
    got = TV.resize_linear(torch.from_numpy(x), size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
    if hw == (size, size):
        np.testing.assert_array_equal(got.numpy(), x)


def test_clip_encode_batches_as_single_images(tower):
    """A batch of images through ``clip_encode`` equals each image alone
    (the JAX package's vmap)."""
    _, _, tc, tp = tower
    px = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 3, 28, 28)).astype(np.float32))
    batch = TV.clip_encode(tp, tc, px)
    assert batch.shape == (3, tc.num_patches, tc.hidden_size)
    for i in range(3):
        np.testing.assert_allclose(batch[i].numpy(),
                                   TV.clip_encode(tp, tc, px[i]).numpy(),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("scales", [(28, 56), (28, 56, 84), (56, 28)])
def test_clip_encode_s2_matches_jax(tower, scales):
    """S2 features [num_patches, hidden * len(scales)] within 1e-5 of
    JAX's, the scales sorted smallest first on both sides."""
    jc, jp, tc, tp = tower
    s = max(scales)
    px = np.random.default_rng(s).normal(size=(3, s, s)).astype(np.float32)
    ref = np.asarray(JV.clip_encode_s2(jp, jc, jnp.asarray(px), scales))
    got = TV.clip_encode_s2(tp, tc, torch.from_numpy(px), scales)
    assert got.shape == (tc.num_patches, tc.hidden_size * len(scales))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(
        got[:, :tc.hidden_size].numpy(),
        TV.clip_encode(tp, tc, TV.resize_linear(torch.from_numpy(px),
                                                28)).numpy(),
        atol=1e-6, rtol=1e-6)


def test_clip_encode_s2_refuses_a_scale_off_the_base(tower):
    _, _, tc, tp = tower
    with pytest.raises(ValueError, match="multiple of base"):
        TV.clip_encode_s2(tp, tc, torch.zeros(3, 42, 42), (28, 42))


@pytest.mark.parametrize("scales", [(28, 56), (28, 56, 84)])
def test_encode_image_s2_matches_jax(tower, scales):
    """``encode_image`` with ``s2_scales``: the S2 features through a
    projector of input width hidden * len(scales), within 1e-5 of
    JAX's."""
    jc, jp, tc, tp = tower
    jl = JC.LlavaConfig(text=JC.LlamaConfig.tiny(), vision=jc,
                        s2_scales=scales)
    tl = TC.LlavaConfig(text=TC.LlamaConfig.tiny(), vision=tc,
                        s2_scales=scales)
    proj = JL.init_projector_params(jax.random.PRNGKey(8), jl)
    assert proj["fc1"].shape == (32 * len(scales), 64)
    proj["fc1_b"] = proj["fc1_b"] + 0.1
    jparams = {"vision": jp, "projector": proj}
    tparams = {"vision": tp,
               "projector": bridge.to_torch(_host(proj), "cpu")}
    s = max(scales)
    px = np.random.default_rng(7).normal(size=(3, s, s)).astype(np.float32)
    ref = np.asarray(JL.encode_image(jparams, jl, jnp.asarray(px)))
    got = TL.encode_image(tparams, tl, torch.from_numpy(px))
    assert got.shape == (tc.num_patches, 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=ATOL)
    init = TL.init_projector_params(tl, torch.Generator().manual_seed(0),
                                    "cpu", torch.float32)
    assert tuple(init["fc1"].shape) == (32 * len(scales), 64)
