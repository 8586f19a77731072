"""Decode attention over the seq-major KV cache: the CUDA kernel K1, its
plain PyTorch twin and the wrapper that picks between them.

The kernel (``csrc/decode_attention.cu``) replaces the JAX package's Pallas
kernel ``msd_tpu/ops/pallas/decode_attention.py``: the same function
(softmax attention of q [T, Hq, D] over keys [0, kv_len) of k, v [S, Hkv, D]
with an additive bias [T, S]), reading only the live keys, in one launch
per call: a grid of key-range splits sized to the card, each streaming its
keys through a cp.async pipeline, merged inside the launch. It is built
with ``nvcc`` for sm_90a into a plain C shared library at first use and
called through ``ctypes``.

Dispatch: ``decode_attention`` launches the kernel for CUDA tensors and
raises on anything the kernel does not take; it computes the plain version
only for tensors on the CPU. There is no fallback from the kernel to the
plain version on the card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

HEAD_DIM = 128
# at or below this many grouped query rows (G * T) models/llama._attend
# sends a call to the kernel under attn_impl="auto" (the JAX package's
# VPU_MAX_GT); "pallas" sends it every call that carries kv_len, such as
# the non-canonical verify's tree rows under their tree bias
KERNEL_MAX_GT = 4

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "decode_attention.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               kv_len) -> torch.Tensor:
    """Plain version: attention over the first kv_len keys only, so
    whatever lies past kv_len (stale rows, NaN) never reaches the output.
    kv_len <= 0 gives zeros, as the kernel does. Scores, softmax and the
    probabilities stay fp32 through the P.V product, as in the kernel and
    the Pallas kernel's VPU regime (``masked_attention`` rounds the
    probabilities to v's dtype first; at fp32 the two are the same ops)."""
    n = min(int(kv_len), k.shape[0])
    if n <= 0:
        return torch.zeros_like(q)
    t, hq, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(t, hkv, hq // hkv, d)
    scores = torch.einsum("thgd,shd->hgts", qg.float(), k[:n].float()) \
        * (1.0 / (d ** 0.5)) + bias[:, :n].float()[None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("hgts,shd->thgd", probs, v[:n].float())
    return out.reshape(t, hq, d).to(q.dtype)

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the decode-attention kernel is built "
                       "on a machine with the CUDA toolkit")


def build_library():
    """Compile the kernel into ``_build/`` unless this source's library is
    already there. Returns (library path, seconds spent, compiler output
    with ptxas's register and spill report); seconds 0 and no output when
    the library was already built.

    The library name carries a hash of the source, so an edited source
    builds anew; the build writes a temporary file and renames it, so two
    processes building at once do not see a half-written library."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libdecode_attention_{tag}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCE)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib, secs, res.stdout + res.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [vp] * 6 + [ci] * 7 + [
        ctypes.c_float, vp]
    lib.decode_attention_launch.restype = ci
    lib.decode_attention_smem_bytes.argtypes = [ci, ci]
    lib.decode_attention_smem_bytes.restype = ci
    lib.decode_attention_head_dim.argtypes = []
    lib.decode_attention_head_dim.restype = ci
    if lib.decode_attention_head_dim() != HEAD_DIM:
        raise RuntimeError("decode-attention library head dim mismatch")
    return lib


def smem_bytes(dtype: torch.dtype, rows: int) -> int:
    """Dynamic shared memory of one kernel block (its stage ring)."""
    return _library().decode_attention_smem_bytes(_DTYPE_CODE[dtype], rows)


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
# at most this many splits per (kv head, row group): the portable
# thread-block-cluster size, which the kernel's merge uses
MAX_SPLITS = 8
# blocks per SM the split count aims at: 7 splits at the AR shape on 132
# SMs, the fastest of 6, 7 and 8 on the H100 (PERF.md)
BLOCKS_PER_SM = 1.7


def launch_shape(t: int, hq: int, hkv: int, n_sm: int):
    """(rows per block, row groups per kv head, splits) of the kernel's
    grid (splits, Hkv * row groups): 1 row for the AR row, else groups of
    4 grouped query rows; as many splits as put about BLOCKS_PER_SM blocks
    on each of the card's n_sm SMs, at most MAX_SPLITS. Depends on neither
    S nor kv_len."""
    gt = (hq // hkv) * t
    rows = 1 if gt == 1 else 4
    n_rg = -(-gt // rows)
    n_split = round(BLOCKS_PER_SM * n_sm / (hkv * n_rg))
    return rows, n_rg, max(1, min(MAX_SPLITS, n_split))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, k, v, bias, kv_len):
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"decode_attention wants q [T, Hq, D] and k, v "
                         f"[S, Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    t, hq, d = q.shape
    s, hkv, dk = k.shape
    if d != HEAD_DIM or dk != HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes D = {HEAD_DIM}, "
                         f"got {d}")
    if hq % hkv:
        raise ValueError(f"Hq = {hq} is not a multiple of Hkv = {hkv}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes bf16 or fp32 q/k/v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if bias.dtype != torch.float32 or tuple(bias.shape) != (t, s):
        raise ValueError(f"bias must be fp32 [{t}, {s}], got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if not (isinstance(kv_len, torch.Tensor) and kv_len.dtype == torch.int32
            and kv_len.numel() == 1):
        raise TypeError("kv_len must be a one-element int32 device tensor")
    for x in (q, k, v, bias, kv_len):
        if x.device != q.device:
            raise ValueError("decode_attention inputs lie on different "
                             "devices")
        if not x.is_contiguous():
            raise ValueError("decode_attention inputs must be contiguous")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("decode_attention q/k/v must be 16-byte aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, kv_len) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v over keys [0, kv_len).

    q: [T, Hq, D]; k, v: [S, Hkv, D] seq-major cache; bias: [T, S] fp32;
    kv_len: int32 one-element tensor on q's device (any int on the CPU).
    Returns [T, Hq, D] in q.dtype. CUDA tensors go to the kernel (bf16 or
    fp32, D = 128, any T, S and GQA group; one launch), CPU tensors to
    ``decode_attention_reference``. Each kernel launch adds one to
    ``decode_attention.launches``. A call made while the current stream is
    capturing a CUDA graph launches nothing: it adds one to
    ``decode_attention.captured``, and whoever replays the graph adds the
    calls it holds to ``launches`` at every replay (``engine/graphs.py``),
    so ``launches`` counts the kernels the device runs.
    """
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, bias, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not "
                         f"{q.device}")
    _check(q, k, v, bias, kv_len)
    lib = _library()
    t, hq, d = q.shape
    s, hkv, _ = k.shape
    rows, _, n_split = launch_shape(t, hq, hkv, sm_count(q.device.index))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            kv_len.data_ptr(), out.data_ptr(), t, hq, hkv, s, rows,
            n_split, _DTYPE_CODE[q.dtype], 1.0 / (d ** 0.5), stream)
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    if torch.cuda.is_current_stream_capturing():
        decode_attention.captured += 1
    else:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.captured = 0
