"""The native (C++) host image prep, loaded through ctypes.

The port's copy of the JAX package's ``utils/native.py``: the library is
``msd_tpu_torch/csrc/image_prep.cpp`` (a copy of the JAX package's
``csrc/image_prep.cpp``: pad to square with the mean colour, PIL-compatible
bicubic resize, rounding to uint8, CLIP normalisation, CHW), built with
``g++`` and the JAX build's flags into ``msd_tpu_torch/_build/`` at first
use, so both packages resize a pixel the same way.

Unlike the JAX module, nothing falls back: where the library cannot be
built or loaded, or the call fails, ``image_prep_native`` raises. The PIL
path is asked for explicitly (``mm_utils.process_image(use_native=False)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "image_prep.cpp"
BUILD_DIR = _PKG / "_build"
# the JAX build's flags, then the portable set it retries with
GXX_FLAGS = (["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"],
             ["-O3", "-shared", "-fPIC"])


def build_library() -> Path:
    """Compile the library into ``_build/`` unless this source's library is
    there. The name carries a hash of the source and flags; the build
    writes a temporary file and renames it, so two processes building at
    once never load a half-written library. Raises with the compiler's
    output when neither flag set builds."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + repr(GXX_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"libimage_prep_{tag}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    errors = []
    for flags in GXX_FLAGS:
        try:
            res = subprocess.run(["g++", *flags, str(SOURCE), "-o", str(tmp)],
                                 capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError("g++ not found: the native image prep is "
                               "built with g++ at first use") from e
        if res.returncode == 0:
            os.replace(tmp, lib)
            return lib
        errors.append(f"g++ {' '.join(flags)}: {res.stderr}")
    raise RuntimeError("the native image prep did not build:\n"
                       + "\n".join(errors))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    f32 = ctypes.POINTER(ctypes.c_float)
    lib.image_prep.restype = ctypes.c_int
    lib.image_prep.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, f32, f32, f32]
    return lib


def image_prep_native(img: np.ndarray, out_size: int, mean: np.ndarray,
                      std: np.ndarray, pad_square: bool = True) -> np.ndarray:
    """uint8 HWC [h, w, 3] -> normalised float32 CHW [3, S, S] through the
    native pipeline. Raises if the library is unavailable or the call
    fails."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"image_prep_native takes [h, w, 3] uint8, got "
                         f"{img.shape}")
    h, w, _ = img.shape
    out = np.empty((3, out_size, out_size), np.float32)
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    f32 = ctypes.POINTER(ctypes.c_float)
    rc = _library().image_prep(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, out_size,
        int(pad_square), mean32.ctypes.data_as(f32),
        std32.ctypes.data_as(f32), out.ctypes.data_as(f32))
    if rc != 0:
        raise RuntimeError(f"image_prep failed ({rc}) on a {h}x{w} image "
                           f"to {out_size}")
    return out
