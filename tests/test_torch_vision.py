"""The port's vision path and prompt building against the JAX package and
HF: the CLIP tower (``clip_encode``), the projector (``encode_image``),
image prep (``process_image``), the multimodal tokenizer, the vicuna_v1
prompt, and HF goldens for the tower and for the LLaMA forward.

Same inputs on both sides, made from numpy seeds; parameters carried from
the JAX package (or HF) by ``msd_tpu_torch.bridge``. Tolerances: the tower
and projector as the JAX package's own HF golden (atol 5e-4, rtol 2e-3,
tests/test_vision.py); image prep, tokens and prompt text exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu import configs as JC
from msd_tpu.harness.models.llava_msd import SimpleTokenizer as JTok
from msd_tpu.models import clip_vit as JCV
from msd_tpu.models import llama as JL
from msd_tpu.models import llava as JV
from msd_tpu.utils import conversation as JConv
from msd_tpu.utils import mm_utils as JMM
from msd_tpu_torch import bridge
from msd_tpu_torch import configs as TC
from msd_tpu_torch.models import clip_vit as TCV
from msd_tpu_torch.models import llama as TL
from msd_tpu_torch.models import llava as TV
from msd_tpu_torch.ops.attention import causal_prefill_bias
from msd_tpu_torch.harness.models.llava_msd import SimpleTokenizer as TTok
from msd_tpu_torch.utils import conversation as TConv
from msd_tpu_torch.utils import mm_utils as TMM
from tests.hf_ref import (hf_state_numpy, rand_ids, tiny_hf_clip,
                          tiny_hf_llama)
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

TOWER_TOL = dict(atol=5e-4, rtol=2e-3)
VISION = dict(hidden_size=32, layers=3, heads=4, image_size=28,
              patch_size=14, intermediate_size=64)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def _pixels(seed, size=28):
    return np.random.default_rng(seed).normal(
        size=(3, size, size)).astype(np.float32)


@pytest.fixture(scope="module")
def llava():
    jcfg = JC.LlavaConfig(text=JC.LlamaConfig.tiny(hidden_size=48),
                          vision=JC.ClipVisionConfig.tiny(**VISION))
    tcfg = TC.LlavaConfig(text=TC.LlamaConfig.tiny(hidden_size=48),
                          vision=TC.ClipVisionConfig.tiny(**VISION))
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jp = {"vision": JCV.init_clip_params(k1, jcfg.vision),
          "projector": JV.init_projector_params(k2, jcfg)}
    # non-zero biases and norms, so every term of the tower is exercised
    rng = np.random.default_rng(5)
    jp = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape)
                      .astype(np.float32), _host(jp))
    return jcfg, tcfg, jp, bridge.to_torch(jp, "cpu")


def test_configs_match_jax():
    for j, t in ((JC.ClipVisionConfig(), TC.ClipVisionConfig()),
                 (JC.ClipVisionConfig.tiny(), TC.ClipVisionConfig.tiny())):
        for name in ("hidden_size", "intermediate_size", "num_hidden_layers",
                     "num_attention_heads", "image_size", "patch_size",
                     "layer_norm_eps", "select_layer", "select_feature",
                     "num_patches"):
            assert getattr(j, name) == getattr(t, name), name
    j, t = JC.LlavaConfig(), TC.LlavaConfig()
    assert (j.mm_hidden_size, j.num_image_tokens) == \
        (t.mm_hidden_size, t.num_image_tokens) == (1024, 576)


def test_init_params_have_jax_layouts():
    jcfg = JC.LlavaConfig(vision=JC.ClipVisionConfig.tiny(**VISION),
                          text=JC.LlamaConfig.tiny())
    tcfg = TC.LlavaConfig(vision=TC.ClipVisionConfig.tiny(**VISION),
                          text=TC.LlamaConfig.tiny())
    g = torch.Generator().manual_seed(0)
    k = jax.random.PRNGKey(0)
    pairs = ((JCV.init_clip_params(k, jcfg.vision),
              TCV.init_clip_params(tcfg.vision, g, "cpu", torch.float32)),
             (JV.init_projector_params(k, jcfg),
              TV.init_projector_params(tcfg, g, "cpu", torch.float32)))
    for jtree, ttree in pairs:
        jflat, tflat = bridge.flatten(_host(jtree)), bridge.flatten(ttree)
        assert sorted(jflat) == sorted(tflat)
        for key, a in jflat.items():
            assert tuple(tflat[key].shape) == a.shape, key


@pytest.mark.parametrize("seed", [0, 1])
def test_clip_encode_matches_jax(llava, seed):
    jcfg, tcfg, jp, tp = llava
    px = _pixels(seed)
    ref = np.asarray(JCV.clip_encode(jp["vision"], jcfg.vision,
                                     jnp.asarray(px)))
    got = TCV.clip_encode(tp["vision"], tcfg.vision, torch.from_numpy(px))
    assert got.shape == (tcfg.vision.num_patches, 32)
    np.testing.assert_allclose(got.numpy(), ref, **TOWER_TOL)


def test_encode_image_matches_jax(llava):
    jcfg, tcfg, jp, tp = llava
    px = _pixels(7)
    ref = np.asarray(JV.encode_image(jp, jcfg, jnp.asarray(px)))
    got = TV.encode_image(tp, tcfg, torch.from_numpy(px))
    assert got.shape == (4, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOWER_TOL)


@pytest.mark.parametrize("layers,select", [(3, -2), (2, -1)])
def test_clip_encode_matches_hf(layers, select):
    """The HF golden of tests/test_vision.py for the port's tower: a tiny
    HF CLIPVisionModel built from a config (nothing downloaded), its
    weights in the JAX package's layout, features after block
    num_layers + 1 + select_layer, CLS dropped."""
    jcfg = JC.ClipVisionConfig.tiny(**dict(VISION, layers=layers))
    tcfg = dataclasses.replace(TC.ClipVisionConfig.tiny(
        **dict(VISION, layers=layers)), select_layer=select)
    hf = tiny_hf_clip(jcfg, seed=layers)
    state = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    params = bridge.to_torch(_host(JCV.params_from_hf_clip(state, jcfg)),
                             "cpu")
    img = _pixels(11)
    with torch.no_grad():
        out = hf(torch.tensor(img[None]), output_hidden_states=True)
    ref = out.hidden_states[select][0, 1:].numpy()
    got = TCV.clip_encode(params, tcfg, torch.from_numpy(img))
    np.testing.assert_allclose(got.numpy(), ref, **TOWER_TOL)


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_llama_forward_matches_hf(kv_heads):
    """The port's LLaMA forward against a tiny HF LlamaForCausalLM built
    from a config (tests/hf_ref.py; nothing downloaded): prefill logits,
    MHA and GQA, at the tolerance of the JAX package's own HF golden."""
    cfg = JC.LlamaConfig.tiny(vocab_size=96, hidden_size=32, layers=2,
                              heads=4, kv_heads=kv_heads,
                              intermediate_size=64)
    tcfg = TC.LlamaConfig.tiny(vocab_size=96, hidden_size=32, layers=2,
                               heads=4, kv_heads=kv_heads,
                               intermediate_size=64)
    hf = tiny_hf_llama(cfg, seed=kv_heads)
    params = bridge.to_torch(_host(JL.params_from_hf(hf_state_numpy(hf),
                                                     cfg)), "cpu")
    ids = rand_ids(cfg.vocab_size, 13, seed=kv_heads)
    with torch.no_grad():
        ref = hf(torch.tensor(ids[None].astype(np.int64))).logits[0].numpy()
    s = 32
    cos_t, sin_t = TL.make_rope(tcfg, s, "cpu")
    kv = TL.init_kv_cache(tcfg, s, torch.float32, "cpu")
    hidden, _ = TL.llama_forward(
        params, tcfg, TL.embed_tokens(params, torch.from_numpy(ids)),
        torch.arange(len(ids)), kv, 0,
        causal_prefill_bias(len(ids), s, device="cpu"), cos_t, sin_t)
    np.testing.assert_allclose(TL.lm_head(params, hidden).numpy(), ref,
                               atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("shape", [(28, 28), (20, 36), (41, 17), (9, 9)])
def test_process_image_equals_jax(shape):
    """The explicit PIL path of the image prep (pad to square with the
    mean color, PIL bicubic, CLIP normalization) equal to the JAX
    package's PIL path, exactly."""
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, size=shape + (3,), dtype=np.uint8)
    for size in (28, 14):
        ref = JMM.process_image(img, image_size=size, use_native=False)
        got = TMM.process_image(img, image_size=size, use_native=False)
        assert got.dtype == np.float32 and got.shape == (3, size, size)
        np.testing.assert_array_equal(got, ref)
    gray = img[..., 0]
    np.testing.assert_array_equal(
        TMM.process_image(gray, 28, use_native=False),
        JMM.process_image(gray, 28, use_native=False))
    np.testing.assert_array_equal(TMM.expand2square(img),
                                  JMM.expand2square(img))


@pytest.mark.parametrize("with_image", [True, False])
def test_prompt_and_tokens_equal_jax(with_image):
    question = "What is in the picture?\nAnswer briefly."
    prompt = TConv.build_msd_prompt(question, with_image=with_image)
    assert prompt == JConv.build_msd_prompt(question, with_image=with_image)
    for vocab in (512, 32000):
        ttok, jtok = TTok(vocab), JTok(vocab)
        got = TMM.tokenizer_image_token(prompt, ttok)
        np.testing.assert_array_equal(
            got, JMM.tokenizer_image_token(prompt, jtok))
        assert (got == TC.IMAGE_TOKEN_INDEX).sum() == int(with_image)
        assert got[0] == ttok.bos_token_id
        assert ttok.decode(list(got[got >= 0])) == \
            jtok.decode(list(got[got >= 0]))


def test_multi_turn_conversation_equals_jax():
    convs = (TConv.vicuna_v1(), JConv.vicuna_v1())
    for conv in convs:
        conv.append_message(conv.roles[0], "<image>\nhello")
        conv.append_message(conv.roles[1], "hi there")
        conv.append_message(conv.roles[0], "and now?")
        conv.append_message(conv.roles[1], None)
    assert convs[0].get_prompt() == convs[1].get_prompt()
    assert convs[0].copy().get_prompt() == convs[0].get_prompt()
    assert TConv.Conversation().get_prompt() == \
        JConv.Conversation().get_prompt()


def test_bridge_carries_the_llava_trees_bitwise():
    """The tower's and projector's plain dicts cross ``bridge`` as they
    are, bf16 included: to the port and back, bit for bit."""
    jcfg = JC.LlavaConfig(text=JC.LlamaConfig.tiny(),
                          vision=JC.ClipVisionConfig.tiny(**VISION))
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    tree = _host({"vision": JCV.init_clip_params(k1, jcfg.vision,
                                                jnp.bfloat16),
                  "projector": JV.init_projector_params(k2, jcfg,
                                                        jnp.bfloat16)})
    back = bridge.to_numpy(bridge.to_torch(tree, "cpu"))
    flat, flat_back = bridge.flatten(tree), bridge.flatten(back)
    assert sorted(flat) == sorted(flat_back)
    for key, a in flat.items():
        np.testing.assert_array_equal(flat_back[key], a.view(np.uint16),
                                      err_msg=key)
