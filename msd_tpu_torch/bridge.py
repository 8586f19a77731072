"""Carry the JAX package's weights, caches and draft checkpoints across.

The port keeps the JAX package's parameter layouts (see ``models/llama``
and ``models/draft``), so a nested dict of numpy arrays taken from
``msd_tpu`` params converts leaf by leaf, bitwise:

- target: ``embed_tokens`` [V, H], ``layers`` {q/k/v_proj [L, out, in],
  o/gate/up/down_proj [L, in, out], norms [L, H]}, ``norm`` [H],
  ``lm_head`` [H, V];
- KV cache {"k", "v"} [L, S, Hkv, D];
- draft: ``embed_tokens``, ``fc_w`` [2H, H], ``fc_b`` [H] (a draft of
  ``DraftConfig(fc_bias=False)`` has none, on both sides), ``layers``,
  ``medusa`` {``mw`` [K, H, H], ``mb`` [K, H]}.

bf16 arrays (numpy's ``bfloat16`` extension dtype, as ``np.asarray`` of a
JAX bf16 array gives) are recognised by dtype name and moved as their
16-bit patterns, so this module needs neither JAX nor ml_dtypes.

It also reads the benchmark's draft-cache npz codec: leaves are
flattened under "/"-joined keys, bf16 leaves are stored as uint16 under a
``__bf16`` suffix, ``__meta__`` holds JSON bytes and ``__traj__/<i>`` int32
trajectories.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

_BF16_SUFFIX = "__bf16"
_META = "__meta__"
_TRAJ = "__traj__/"


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _bf16_from_bits(bits: np.ndarray, device) -> torch.Tensor:
    """16-bit patterns (any 2-byte numpy dtype) -> bf16 tensor."""
    bits = np.array(bits, copy=True).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16).to(device)


def leaf_to_torch(a, device="cuda") -> torch.Tensor:
    """One numpy leaf -> tensor of the same dtype and bits."""
    a = np.asarray(a)
    if _is_bf16(a):
        return _bf16_from_bits(a, device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> numpy. bf16 comes back as its uint16 bit patterns
    (numpy has no bf16 of its own); every other dtype as itself."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_torch(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same dict of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return leaf_to_torch(tree, device)


def to_numpy(tree):
    """Nested dict of tensors -> numpy (bf16 as uint16 bit patterns)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return leaf_to_numpy(tree)


def flatten(tree: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in tree.items():
        key = prefix + k
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def unflatten(flat: Dict) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def load_draft_npz(path: str, device="cuda"
                   ) -> Tuple[Dict, Dict, Optional[List[np.ndarray]]]:
    """Read a draft-cache npz -> (params as tensors, meta, trajectories or
    None)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[_META]).decode())
        flat, trajs = {}, {}
        for k in z.files:
            if k == _META:
                continue
            if k.startswith(_TRAJ):
                trajs[int(k[len(_TRAJ):])] = z[k]
            elif k.endswith(_BF16_SUFFIX):
                flat[k[:-len(_BF16_SUFFIX)]] = _bf16_from_bits(z[k], device)
            else:
                flat[k] = torch.from_numpy(z[k].copy()).to(device)
    traj_list = [trajs[i] for i in sorted(trajs)] if trajs else None
    return unflatten(flat), meta, traj_list
