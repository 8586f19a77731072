"""The weight bridge (msd_tpu_torch.bridge) and the port's import hygiene.

Round trips must be bitwise: JAX-initialised fp32 and bf16 params, the
KV cache, and the benchmark's draft-cache npz codec (bf16 leaves stored as
uint16 under a ``__bf16`` suffix) written by ``bench.save_draft_cache`` and
read back by ``bench.load_draft_cache``. The npz files are tiny and written
by the test itself.
"""

import ast
import json
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import bench
from msd_tpu import configs as JC
from msd_tpu.models import draft as JD
from msd_tpu.models import llama as JL
from msd_tpu_torch import bridge

REPO = pathlib.Path(__file__).resolve().parent.parent


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def _tiny_bundle(dtype):
    cfg = JC.LlamaConfig.tiny(vocab_size=48, hidden_size=32, layers=2,
                              heads=4, kv_heads=2, intermediate_size=40)
    dcfg = JC.DraftConfig(text=cfg, medusa_heads=3)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(5), 3)
    tp = JL.init_llama_params_stacked(k1, cfg, dtype)
    dp = JD.init_draft_params(k2, dcfg, dtype)
    dp["medusa"] = JD.init_medusa_params(k3, dcfg, dtype)
    kv = JL.init_kv_cache(cfg, 16, dtype)
    kv = {n: jax.random.normal(k3, v.shape, v.dtype) for n, v in kv.items()}
    return cfg, {"target": tp, "draft": dp, "kv": kv}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_params_round_trip_bitwise(dtype):
    _, tree = _tiny_bundle(dtype)
    host = jax.tree.map(np.asarray, tree)
    tt = bridge.to_torch(host, "cpu")
    want = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    flat_h, flat_t = bridge.flatten(host), bridge.flatten(tt)
    assert flat_h.keys() == flat_t.keys()
    for key, t in flat_t.items():
        assert t.dtype == want, key
        assert tuple(t.shape) == flat_h[key].shape, key
    back = bridge.flatten(bridge.to_numpy(tt))
    for key, a in flat_h.items():
        np.testing.assert_array_equal(back[key], _bits(a), err_msg=key)


def test_layouts_are_the_jax_layouts():
    cfg, tree = _tiny_bundle(jnp.float32)
    tt = bridge.to_torch(jax.tree.map(np.asarray, tree), "cpu")
    h, hkv = cfg.hidden_size, cfg.num_key_value_heads * cfg.head_dim
    lay = tt["target"]["layers"]
    assert tuple(lay["k_proj"].shape) == (2, hkv, h)          # [L, out, in]
    assert tuple(lay["down_proj"].shape) == (2, 40, h)        # [L, in, out]
    assert tuple(tt["target"]["lm_head"].shape) == (h, 48)    # [H, V]
    assert tuple(tt["kv"]["k"].shape) == (2, 16, 2, 8)        # [L, S, Hkv, D]
    assert tuple(tt["draft"]["fc_w"].shape) == (2 * h, h)
    assert tuple(tt["draft"]["medusa"]["mw"].shape) == (3, h, h)


def _save_draft_npz(path, params, meta, trajs):
    """The draft-cache codec written from the port's tensors, as a later
    port distill would write it: bf16 leaves as uint16 bits under the
    ``__bf16`` suffix, JSON meta bytes, int32 trajectories."""
    payload = {}
    for key, t in bridge.flatten(params).items():
        suffix = "__bf16" if t.dtype == torch.bfloat16 else ""
        payload[key + suffix] = bridge.leaf_to_numpy(t)
    for i, traj in enumerate(trajs):
        payload[f"__traj__/{i}"] = np.asarray(traj, np.int32)
    payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **payload)


def test_draft_npz_codec_both_ways(tmp_path):
    _, tree = _tiny_bundle(jnp.bfloat16)
    draft = jax.tree.map(np.asarray, tree["draft"])
    draft["step"] = np.arange(3, dtype=np.int32)            # a non-bf16 leaf
    meta = {"rounds_done": 5, "note": "tiny"}
    trajs = [np.array([3, 4, 5], np.int32), np.array([9], np.int32)]

    path = str(tmp_path / "jax_side.npz")
    bench.save_draft_cache(path, draft, meta, trajs)
    params, meta2, trajs2 = bridge.load_draft_npz(path, "cpu")
    assert meta2 == meta
    assert [t.tolist() for t in trajs2] == [t.tolist() for t in trajs]
    assert params["fc_w"].dtype == torch.bfloat16
    assert params["step"].dtype == torch.int32
    flat_j = bridge.flatten(draft)
    flat_t = bridge.flatten(bridge.to_numpy(params))
    assert flat_j.keys() == flat_t.keys()
    for key, a in flat_j.items():
        np.testing.assert_array_equal(flat_t[key], _bits(a), err_msg=key)

    path2 = str(tmp_path / "torch_side.npz")
    _save_draft_npz(path2, params, meta, trajs)
    got = bench.load_draft_cache(path2)
    assert got is not None
    draft3, meta3, trajs3 = got
    assert meta3 == meta and len(trajs3) == 2
    flat3 = bridge.flatten(draft3)
    for key, a in flat_j.items():
        assert flat3[key].dtype == a.dtype, key
        np.testing.assert_array_equal(_bits(flat3[key]), _bits(a),
                                      err_msg=key)


PORT_FILES = sorted((REPO / "msd_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_msd_tpu(path):
    """The card's machine has no JAX: no module of the port, and not the
    smoke, may import jax or anything of the JAX package."""
    banned = ("jax", "jaxlib", "msd_tpu", "flax", "optax", "orbax",
              "ml_dtypes")
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names = [str(node.args[0].value)]
        for name in names:
            root = name.split(".")[0]
            assert root not in banned, f"{path.name}:{node.lineno} {name}"
