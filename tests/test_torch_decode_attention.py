"""Decode attention K1: the JAX Pallas kernel (run in interpret mode, as
tests/test_pallas.py runs it off the TPU) against the port's plain twin
``decode_attention_reference`` and its CPU dispatch; and, on a card, the
CUDA kernel against the plain twin.

CPU tolerance: both sides compute in fp32 with different summation orders
(streaming softmax over 128-key blocks vs one softmax): 2e-5 absolute, as
tests/test_pallas.py holds the Pallas kernel to masked_attention.
Card tolerance, elementwise |out - ref| <= atol + rtol |ref|: bf16 inputs,
fp32 scores, probabilities and accumulation on both sides and the output
rounded once to bf16, so the two may differ by one bf16 ulp (at most 2^-7
of |ref|): rtol 2^-7, and atol 2^-10 for the summation-order noise of
outputs near zero; fp32 inputs: atol = rtol = 1e-5. The bf16 twin is held
to the Pallas kernel on the CPU at the same tolerance.
"""

import numpy as np
import pytest
import torch

from msd_tpu_torch.ops import decode_attention as K1
from msd_tpu_torch.ops.attention import NEG_INF

CPU_TOL = dict(atol=2e-5, rtol=2e-5)
GPU_TOL = {torch.bfloat16: dict(atol=2 ** -10, rtol=2 ** -7),
           torch.float32: dict(atol=1e-5, rtol=1e-5)}


def _pallas(q, k, v, bias, kv_len):
    """The JAX Pallas kernel in interpret mode. JAX is imported here, not
    at module level, so the card-only tests below also collect on a
    machine without JAX."""
    import jax.numpy as jnp

    from msd_tpu.ops.pallas.decode_attention import decode_attention
    out = decode_attention(*(jnp.asarray(a) for a in (q, k, v, bias)),
                           jnp.int32(kv_len), block_s=128, interpret=True)
    return np.asarray(out)


def _inputs(t, hq, hkv, s, kv_len, seed=0, d=128, nan_tail=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(t, hq, d)).astype(np.float32)
    k = rng.normal(size=(s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(s, hkv, d)).astype(np.float32)
    keep = np.zeros((t, s), bool)
    keep[:, :kv_len] = rng.uniform(size=(t, kv_len)) < 0.8
    keep[:, 0] = True
    if nan_tail:
        k[kv_len:] = np.nan
        v[kv_len:] = np.nan
    bias = np.where(keep, 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias


CASES = [
    (8, 4, 4, 256, 100),    # MHA, partial cache
    (8, 4, 4, 256, 256),    # full cache
    (6, 8, 2, 384, 300),    # GQA, T > 4
    (1, 4, 4, 256, 37),     # AR decode shape
    (1, 8, 2, 256, 130),    # GQA AR (G*T = 4: the kernel route)
    # the edges of the kernel's split grid (7 or 8 splits on an H100):
    (1, 4, 4, 256, 1),      # one live key: every other split empty
    (1, 4, 4, 256, 7),      # one key per split at the AR shape
    (1, 4, 4, 256, 9),      # a split boundary past one key per split
    (1, 4, 4, 256, 256),    # kv_len = S
    (1, 8, 2, 256, 256),    # GQA AR, G*T = 4 in one block, kv_len = S
    (2, 4, 2, 128, 1),      # G*T = 4 from T = 2, one live key
]


@pytest.mark.parametrize("t,hq,hkv,s,kv_len", CASES)
def test_reference_matches_pallas_interpret(t, hq, hkv, s, kv_len):
    q, k, v, bias = _inputs(t, hq, hkv, s, kv_len)
    ref = _pallas(q, k, v, bias, kv_len)
    out = K1.decode_attention_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v, bias)), kv_len)
    np.testing.assert_allclose(out.numpy(), ref, **CPU_TOL)


@pytest.mark.parametrize("t,hq,hkv,s,kv_len", [
    (1, 4, 4, 256, 7),      # few keys: each probability is large
    (1, 8, 2, 256, 9),      # GQA, G*T = 4
    (2, 4, 2, 128, 5),      # G*T = 4 from T = 2
    (1, 4, 4, 256, 200),
])
def test_bf16_reference_keeps_fp32_probabilities_like_pallas(t, hq, hkv, s,
                                                             kv_len):
    """At bf16 and G*T <= 4 the Pallas kernel (its VPU regime) keeps the
    probabilities fp32 through P.V, and so do the CUDA kernel and its
    twin. Rounding them to bf16 first, as masked_attention does, departs
    from the Pallas kernel by more than the card tolerance at small
    kv_len (max |err| - 2^-7 |ref| = 1.9e-3 at kv_len 7)."""
    import jax.numpy as jnp

    from msd_tpu.ops.pallas.decode_attention import decode_attention
    q, k, v, bias = _inputs(t, hq, hkv, s, kv_len)
    ref = decode_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        jnp.asarray(bias), jnp.int32(kv_len), block_s=128, interpret=True)
    ref = torch.from_numpy(np.asarray(ref.astype(jnp.float32)))
    out = K1.decode_attention_reference(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        torch.from_numpy(bias), kv_len)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref,
                               **GPU_TOL[torch.bfloat16])


def test_nan_keys_past_kv_len_stay_invisible():
    """NaN in keys the Pallas kernel skips (whole dead blocks) matches it;
    NaN right from kv_len, inside a live block, leaves the port's twin
    unchanged (it never reads past kv_len)."""
    q, k, v, bias = _inputs(4, 4, 4, 256, 100)
    k[128:], v[128:] = np.nan, np.nan
    ref = _pallas(q, k, v, bias, 100)
    out = K1.decode_attention_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v, bias)), 100)
    assert np.isfinite(out.numpy()).all()
    np.testing.assert_allclose(out.numpy(), ref, **CPU_TOL)
    clean = [torch.from_numpy(a) for a in _inputs(4, 4, 4, 256, 130)]
    dirty = [torch.from_numpy(a)
             for a in _inputs(4, 4, 4, 256, 130, nan_tail=True)]
    assert torch.equal(K1.decode_attention_reference(*dirty, 130),
                       K1.decode_attention_reference(*clean, 130))


def test_cpu_wrapper_uses_plain_twin_and_counts_no_launch():
    q, k, v, bias = (torch.from_numpy(a) for a in _inputs(1, 4, 4, 256, 90))
    before = K1.decode_attention.launches
    out = K1.decode_attention(q, k, v, bias,
                              torch.tensor(90, dtype=torch.int32))
    assert torch.equal(out, K1.decode_attention_reference(q, k, v, bias, 90))
    assert K1.decode_attention.launches == before
    zero = K1.decode_attention(q, k, v, bias, 0)
    assert torch.equal(zero, torch.zeros_like(q))


@pytest.mark.parametrize("t,hq,hkv,want", [
    (1, 32, 32, (1, 1, 7)),    # AR row at 7B width: 224 blocks
    (1, 32, 8, (4, 1, 8)),     # GQA AR: one block holds G*T = 4 rows
    (48, 32, 32, (4, 12, 1)),  # verify-shaped: 384 row groups, no split
    (5, 32, 32, (4, 2, 4)),
])
def test_launch_shape_fills_the_card_and_ignores_s(t, hq, hkv, want):
    """The grid (splits, Hkv * row groups) puts about BLOCKS_PER_SM blocks
    on each of an H100's 132 SMs, at most 8 splits (the portable cluster
    size), and takes no S or kv_len: a call's grid is the same at every
    length, so one captured launch serves every kv_len."""
    rows, n_rg, n_split = K1.launch_shape(t, hq, hkv, 132)
    assert (rows, n_rg, n_split) == want
    groups = hkv * n_rg
    assert n_split in (1, K1.MAX_SPLITS) \
        or abs(n_split * groups - K1.BLOCKS_PER_SM * 132) <= groups / 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel has no CPU mode: needs an NVIDIA card "
                    "and nvcc")
    return torch.device("cuda")


GPU_CASES = [
    (1, 32, 32, 1280, 640, torch.bfloat16),   # AR decode at 7B width
    (1, 32, 32, 1280, 895, torch.bfloat16),
    (48, 32, 32, 1280, 750, torch.bfloat16),  # verify-shaped call
    (1, 32, 8, 1280, 700, torch.bfloat16),    # GQA
    (5, 8, 2, 1152, 1000, torch.float32),
]


# the split grid's edges: ("split", o) is kv_len = the call's split count
# + o (one key per split, and either side of it)
EDGE_CASES = [(1, 32, 32, 1280, n, torch.bfloat16)
              for n in (1, ("split", -1), ("split", 0), ("split", 1), 1279,
                        1280)] + [
    (1, 32, 8, 1280, ("split", 1), torch.bfloat16),  # GQA, G*T = 4
    (1, 32, 8, 1280, 1280, torch.bfloat16),
    (1, 8, 8, 1280, ("split", -1), torch.float32),
    (1, 8, 8, 1280, 1280, torch.float32),
    (4, 8, 8, 1280, 1, torch.float32),        # T = 4 rows in one block
]


def _card_inputs(device, t, hq, hkv, s, kv_len, dtype, seed=0):
    q, k, v, bias = (torch.from_numpy(a).to(device)
                     for a in _inputs(t, hq, hkv, s, kv_len, seed=seed,
                                      nan_tail=True))
    n = torch.tensor(kv_len, dtype=torch.int32, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, n


def _assert_matches_twin(out, q, k, v, bias, kv_len):
    ref = K1.decode_attention_reference(q, k, v, bias, kv_len)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), **GPU_TOL[q.dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("t,hq,hkv,s,kv_len,dtype", GPU_CASES + EDGE_CASES)
def test_kernel_matches_plain_twin_on_card(cuda_device, t, hq, hkv, s,
                                           kv_len, dtype):
    if isinstance(kv_len, tuple):
        kv_len = K1.launch_shape(t, hq, hkv,
                                 K1.sm_count(cuda_device.index or 0))[2] \
            + kv_len[1]
    q, k, v, bias, n = _card_inputs(cuda_device, t, hq, hkv, s, kv_len,
                                    dtype)
    before = K1.decode_attention.launches
    out = K1.decode_attention(q, k, v, bias, n)
    torch.cuda.synchronize()
    assert K1.decode_attention.launches == before + 1
    _assert_matches_twin(out, q, k, v, bias, kv_len)


@pytest.mark.cuda
def test_kernel_is_bitwise_deterministic_eager_and_in_a_graph(cuda_device):
    """Two eager calls and two replays of a captured call give bitwise
    the same output at the AR shape (the splits merge in split order,
    whatever order the blocks finish in); the captured launch, replayed
    after kv_len changes on the device, computes the new length."""
    q, k, v, bias, n = _card_inputs(cuda_device, 1, 32, 32, 1280, 672,
                                    torch.bfloat16)
    eager = [K1.decode_attention(q, k, v, bias, n) for _ in range(2)]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = K1.decode_attention(q, k, v, bias, n)
    replays = []
    for _ in range(2):
        graph.replay()
        replays.append(captured.clone())
    torch.cuda.synchronize()
    for x in eager[1:] + replays:
        assert torch.equal(x, eager[0])
    _assert_matches_twin(eager[0], q, k, v, bias, 672)
    n.fill_(5)
    graph.replay()
    torch.cuda.synchronize()
    _assert_matches_twin(captured, q, k, v, bias, 5)


@pytest.mark.cuda
def test_back_to_back_calls_at_two_lengths(cuda_device):
    """A long call, then a short one on the same caches: both match the
    twin, so nothing of the first call's state reaches the second."""
    q, k, v, bias, _ = _card_inputs(cuda_device, 1, 32, 32, 1280, 1280,
                                    torch.bfloat16)
    lens = (640, 5)
    ns = [torch.tensor(x, dtype=torch.int32, device=cuda_device)
          for x in lens]
    outs = [K1.decode_attention(q, k, v, bias, n) for n in ns]
    torch.cuda.synchronize()
    for out, kv_len in zip(outs, lens):
        _assert_matches_twin(out, q, k, v, bias, kv_len)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 4, 64, device=cuda_device)
    k = torch.zeros(16, 4, 64, device=cuda_device)
    bias = torch.zeros(1, 16, device=cuda_device)
    n = torch.tensor(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        K1.decode_attention(q, k, k, bias, n)
    q = torch.zeros(1, 4, 128, device=cuda_device, dtype=torch.float16)
    k = torch.zeros(16, 4, 128, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError):
        K1.decode_attention(q, k, k, bias, n)
