"""Decode attention K1: the JAX Pallas kernel (run in interpret mode, as
tests/test_pallas.py runs it off the TPU) against the port's plain twin
``decode_attention_reference`` and its CPU dispatch; and, on a card, the
CUDA kernel against the plain twin.

CPU tolerance: both sides compute in fp32 with different summation orders
(streaming softmax over 128-key blocks vs one softmax): 2e-5 absolute, as
tests/test_pallas.py holds the Pallas kernel to masked_attention.
Card tolerance, elementwise |out - ref| <= atol + rtol |ref|: bf16 inputs,
fp32 accumulation on both sides and the output rounded once to bf16, so
the two may differ by one bf16 ulp (at most 2^-7 of |ref|): rtol 2^-7, and
atol 2^-10 for the summation-order and probability-rounding noise of
outputs near zero; fp32 inputs: atol = rtol = 1e-5.
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
]


@pytest.mark.parametrize("t,hq,hkv,s,kv_len", CASES)
def test_reference_matches_pallas_interpret(t, hq, hkv, s, kv_len):
    q, k, v, bias = _inputs(t, hq, hkv, s, kv_len)
    ref = _pallas(q, k, v, bias, kv_len)
    out = K1.decode_attention_reference(*(torch.from_numpy(a)
                                          for a in (q, k, v, bias)), kv_len)
    np.testing.assert_allclose(out.numpy(), ref, **CPU_TOL)


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


@pytest.mark.cuda
@pytest.mark.parametrize("t,hq,hkv,s,kv_len,dtype", GPU_CASES)
def test_kernel_matches_plain_twin_on_card(cuda_device, t, hq, hkv, s,
                                           kv_len, dtype):
    q, k, v, bias = (torch.from_numpy(a).to(cuda_device)
                     for a in _inputs(t, hq, hkv, s, kv_len, nan_tail=True))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    n = torch.tensor(kv_len, dtype=torch.int32, device=cuda_device)
    before = K1.decode_attention.launches
    out = K1.decode_attention(q, k, v, bias, n)
    torch.cuda.synchronize()
    assert K1.decode_attention.launches == before + 1
    ref = K1.decode_attention_reference(q, k, v, bias, kv_len)
    tol = GPU_TOL[dtype]
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out.float(), ref.float(), **tol)


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
