"""Reader and writer of the safetensors file format, in the port's own code.

A file is an 8-byte little-endian header length N, N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...,
"__metadata__"?: {str: str}}``, offsets relative to the end of the
header), then the raw little-endian bytes of every tensor. The JAX package
reads and writes it with ``safetensors.numpy``, which cannot hold bf16;
this module holds every dtype a checkpoint of this repository carries,
bf16 included, and needs nothing beyond torch.

``load_file`` maps the file (copy-on-write, so the file is never written)
and makes each tensor a view of the mapping with ``torch.frombuffer``: no
second host copy of the data is made, the pages are read as the tensors
are used.
"""

from __future__ import annotations

import json
import mmap
import struct
from typing import Dict, Optional

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
          "BOOL": torch.bool}
NAMES = {dt: name for name, dt in DTYPES.items()}


def load_file(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the file, by name: views of a copy-on-write mapping
    of the file on the host (a tensor whose bytes are not aligned to its
    element size is copied out), moved to ``device`` when it is not the
    CPU."""
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) \
            if size > 8 + n else None
    start = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES[info["dtype"]]
        shape = tuple(info["shape"])
        begin, end = info["data_offsets"]
        count = (end - begin) // dtype.itemsize
        if count == 0:
            t = torch.empty(shape, dtype=dtype)
        elif (start + begin) % dtype.itemsize:
            raw = bytearray(mapped[start + begin:start + end])
            t = torch.frombuffer(raw, dtype=dtype, count=count).view(shape)
        else:
            t = torch.frombuffer(mapped, dtype=dtype, count=count,
                                 offset=start + begin).view(shape)
        out[name] = t if str(device) == "cpu" else t.to(device)
    return out


def save_file(tensors: Dict[str, torch.Tensor], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (any device; copied to the host one at a time) as
    a safetensors file, the header padded with spaces to a multiple of 8
    bytes so the data starts aligned, as the format asks."""
    header, offset = {}, 0
    for name, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                host = t.detach().contiguous().cpu()
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)
