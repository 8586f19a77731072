"""Checkpoint loading of the PyTorch port against the JAX package, on the
tiny synthetic checkpoints ``tests/test_weights_roundtrip.py`` writes (CPU,
fp32): the port's safetensors reader and writer against the
``safetensors`` package, ``load_llava`` (one file, shards, a LoRA
adapter), ``load_draft`` (EAGLE, stacked and per-head medusa heads, the
target's embedding), ``save_draft``, ``clip_config_from_state``,
``ServeAdapter.from_pretrained`` against ``LlavaMSD.from_pretrained``,
``server.main``'s server and ``cli.main --tiny``. Every param equals the
JAX loader's bitwise."""

import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from msd_tpu.configs import EngineConfig as JEng
from msd_tpu.configs import TreeConfig as JTree
from msd_tpu.harness.models.llava_msd import LlavaMSD
from msd_tpu.utils import weights as JW
from msd_tpu_torch import bridge
from msd_tpu_torch.configs import EngineConfig, TreeConfig
from msd_tpu_torch.serve import cli
from msd_tpu_torch.serve import server as TServer
from msd_tpu_torch.serve.adapter import ServeAdapter
from msd_tpu_torch.utils import safetensors_io as SIO
from msd_tpu_torch.utils import weights as TW
from tests.test_weights_roundtrip import (H, make_draft_checkpoint,
                                          make_llava_checkpoint)
from tests.test_torch_graphs import one_torch_thread  # noqa: F401 (autouse)

TREE = dict(top_k=4, max_depth=4, num_nodes=12)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _same_params(mine, theirs):
    """The port's param dict equals the JAX one, key for key, bitwise."""
    a = _flat(bridge.to_numpy(mine))
    b = _flat(jax.tree.map(np.asarray, theirs))
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The tiny LLaVA checkpoint, its sharded copy (two files and an
    index), and an EAGLE draft without embed_tokens."""
    from safetensors.numpy import load_file, save_file

    root = tmp_path_factory.mktemp("ckpt")
    rng = np.random.default_rng(0)
    make_llava_checkpoint(str(root / "llava"), rng)
    make_draft_checkpoint(str(root / "draft"), rng)
    state = load_file(str(root / "llava" / "model.safetensors"))
    sharded = root / "sharded"
    os.makedirs(sharded)
    names = sorted(state)
    parts = (names[:len(names) // 2], names[len(names) // 2:])
    weight_map = {}
    for i, part in enumerate(parts):
        fname = f"model-0000{i + 1}-of-00002.safetensors"
        save_file({k: state[k] for k in part}, str(sharded / fname))
        weight_map.update({k: fname for k in part})
    (sharded / "model.safetensors.index.json").write_text(
        json.dumps({"weight_map": weight_map}))
    (sharded / "config.json").write_text(
        (root / "llava" / "config.json").read_text())
    return {"llava": str(root / "llava"), "sharded": str(sharded),
            "draft": str(root / "draft"), "root": root}


# ---------------------------------------------------------------------------
# the safetensors format
# ---------------------------------------------------------------------------

def _tensors(dtype):
    g = torch.Generator().manual_seed(3)
    if dtype == torch.int8:
        return {"w": torch.randint(-128, 128, (5, 7), generator=g,
                                   dtype=torch.int8),
                "odd": torch.randint(-128, 128, (3,), generator=g,
                                     dtype=torch.int8)}
    return {"w": torch.randn(5, 7, generator=g).to(dtype),
            "v": torch.randn(3, generator=g).to(dtype),
            "empty": torch.zeros(0, 4, dtype=dtype)}


@pytest.mark.parametrize("package,dtype", [
    ("numpy", torch.float32), ("numpy", torch.float16),
    ("numpy", torch.int8), ("torch", torch.float32),
    ("torch", torch.float16), ("torch", torch.bfloat16),
    ("torch", torch.int8)])
def test_safetensors_io_matches_the_package(package, dtype, tmp_path):
    """The port reads files the safetensors package writes and the package
    reads the port's files, bitwise (numpy cannot hold bf16: the torch
    flavour covers it)."""
    import safetensors.numpy as SN
    import safetensors.torch as ST

    ts = _tensors(dtype)
    theirs, mine = str(tmp_path / "theirs.st"), str(tmp_path / "mine.st")
    if package == "numpy":
        SN.save_file({k: v.numpy() for k, v in ts.items()}, theirs)
    else:
        ST.save_file(ts, theirs)
    got = SIO.load_file(theirs)
    assert sorted(got) == sorted(ts)
    for k in ts:
        assert got[k].dtype == dtype and torch.equal(got[k], ts[k]), k
    SIO.save_file(ts, mine, {"format": "pt"})
    with open(mine, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        assert (8 + n) % 8 == 0       # the data starts 8-byte aligned
        assert json.loads(f.read(n))["__metadata__"] == {"format": "pt"}
    back = (SN.load_file(mine) if package == "numpy"
            else ST.load_file(mine))
    for k in ts:
        want = ts[k].numpy() if package == "numpy" else ts[k]
        if package == "numpy":
            np.testing.assert_array_equal(back[k], want)
        else:
            assert back[k].dtype == dtype and torch.equal(back[k], want)


# ---------------------------------------------------------------------------
# loaders against the JAX loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["llava", "sharded"])
def test_load_llava_matches_jax(ckpts, which):
    """Target, tower and projector of one file and of two shards equal the
    JAX loader's, with the same configs."""
    mine, mcfg = TW.load_llava(ckpts[which], torch.float32, "cpu")
    theirs, jcfg = JW.load_llava(ckpts[which], jnp.float32)
    _same_params(mine, theirs)
    for field in ("vocab_size", "hidden_size", "intermediate_size",
                  "num_hidden_layers", "num_attention_heads",
                  "num_key_value_heads", "max_position_embeddings",
                  "rms_norm_eps", "rope_theta"):
        assert getattr(mcfg.text, field) == getattr(jcfg.text, field), field
    for field in ("hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "image_size", "patch_size"):
        assert getattr(mcfg.vision, field) == \
            getattr(jcfg.vision, field), field
    # a bf16 load is the fp32 load cast once
    bf, _ = TW.load_llava(ckpts[which], torch.bfloat16, "cpu")
    assert torch.equal(bf["target"]["layers"]["o_proj"],
                       mine["target"]["layers"]["o_proj"].bfloat16())


def test_clip_config_from_state_matches_jax(ckpts):
    state = TW._load_state(ckpts["llava"])
    vis = {k[len(TW.TOWER_PREFIX):]: v for k, v in state.items()
           if k.startswith(TW.TOWER_PREFIX)}
    jvis = {k: v.numpy() for k, v in vis.items()}
    for heads in (None, 2):
        assert TW.clip_config_from_state(vis, heads).__dict__ == \
            JW.clip_config_from_state(jvis, heads).__dict__


def test_merge_lora_matches_jax(ckpts, tmp_path):
    """A PEFT LoRA dir over the tiny base: the merged checkpoint (the
    adapted q_proj, the overriding projector) equals the JAX loader's."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(5)
    lora = tmp_path / "lora"
    os.makedirs(lora)
    r = 4
    pre = "base_model.model.model."
    save_file({
        pre + "layers.0.self_attn.q_proj.lora_A.weight":
            (rng.normal(size=(r, H)) * 0.05).astype(np.float32),
        pre + "layers.0.self_attn.q_proj.lora_B.weight":
            (rng.normal(size=(H, r)) * 0.05).astype(np.float32),
        pre + "layers.1.mlp.down_proj.lora_A.weight":
            (rng.normal(size=(r, 128)) * 0.05).astype(np.float32),
        pre + "layers.1.mlp.down_proj.lora_B.weight":
            (rng.normal(size=(H, r)) * 0.05).astype(np.float32),
        pre + "mm_projector.0.weight":
            (rng.normal(size=(H, 64)) * 0.05).astype(np.float32),
    }, str(lora / "adapter_model.safetensors"))
    (lora / "adapter_config.json").write_text(json.dumps(
        {"r": r, "lora_alpha": 8,
         "base_model_name_or_path": ckpts["llava"]}))
    mine, _ = TW.load_llava(str(lora), torch.float32, "cpu")
    theirs, _ = JW.load_llava(str(lora), jnp.float32)
    _same_params(mine, theirs)
    base, _ = TW.load_llava(ckpts["llava"], torch.float32, "cpu")
    assert not torch.equal(mine["target"]["layers"]["q_proj"][0],
                           base["target"]["layers"]["q_proj"][0])
    assert torch.equal(mine["target"]["layers"]["q_proj"][1],
                       base["target"]["layers"]["q_proj"][1])


def _medusa_draft(path, per_head):
    """The tiny EAGLE draft with 3 medusa heads, stacked or per head."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(9)
    make_draft_checkpoint(path, rng)
    st = load_file(os.path.join(path, "model.safetensors"))
    mw = (rng.normal(size=(3, H, H)) * 0.05).astype(np.float32)
    mb = (rng.normal(size=(3, H)) * 0.05).astype(np.float32)
    if per_head:
        for k in range(3):
            st[f"medusa.{k}.w"], st[f"medusa.{k}.b"] = mw[k], mb[k]
    else:
        st["medusa.mw"], st["medusa.mb"] = mw, mb
    save_file(st, os.path.join(path, "model.safetensors"))
    return path


@pytest.mark.parametrize("kind", ["eagle", "stacked", "per_head"])
def test_load_draft_matches_jax(ckpts, kind, tmp_path):
    """A draft without embed_tokens takes the target's (shared, not
    copied, on the port's side); medusa heads stacked or per head."""
    path = ckpts["draft"] if kind == "eagle" else \
        _medusa_draft(str(tmp_path / kind), kind == "per_head")
    target, tcfg = TW.load_llava(ckpts["llava"], torch.float32, "cpu")
    jtarget, jcfg = JW.load_llava(ckpts["llava"], jnp.float32)
    mine, dcfg = TW.load_draft(path, tcfg.text,
                               target["target"]["embed_tokens"],
                               torch.float32, "cpu")
    theirs, jdcfg = JW.load_draft(path, jcfg.text,
                                  jtarget["target"]["embed_tokens"],
                                  jnp.float32)
    _same_params(mine, theirs)
    assert dcfg.medusa_heads == jdcfg.medusa_heads == \
        (0 if kind == "eagle" else 3)
    assert mine["embed_tokens"] is target["target"]["embed_tokens"]
    with pytest.raises(ValueError, match="embed_tokens"):
        TW.load_draft(path, tcfg.text, None, torch.float32, "cpu")


def test_save_draft_round_trips_both_ways(ckpts, tmp_path):
    """save_draft -> load_draft is the identity (medusa heads and embedding
    included); the JAX loader reads the port's export and the port's
    loader the JAX export, equal."""
    from msd_tpu.configs import DraftConfig as JDC
    from msd_tpu.models import draft as JD

    target, lcfg = TW.load_llava(ckpts["llava"], torch.float32, "cpu")
    jcfg = JW.load_llava(ckpts["llava"], jnp.float32)[1]
    jdcfg = JDC(text=jcfg.text, medusa_heads=2)
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    jdp = JD.init_draft_params(k1, jdcfg)
    jdp["medusa"] = JD.init_medusa_params(k2, jdcfg)
    dp = bridge.to_torch(jax.tree.map(np.asarray, jdp), "cpu")
    TW.save_draft(dp, str(tmp_path / "mine"), include_embed=True)
    JW.save_draft(jdp, str(tmp_path / "theirs"), include_embed=True)
    for path in ("mine", "theirs"):
        back, dcfg = TW.load_draft(str(tmp_path / path), lcfg.text,
                                   dtype=torch.float32, device="cpu")
        assert dcfg.medusa_heads == 2
        _same_params(back, jdp)
    jback, _ = JW.load_draft(str(tmp_path / "mine"), jcfg.text,
                             dtype=jnp.float32)
    _same_params(dp, jback)


# ---------------------------------------------------------------------------
# entry points over a checkpoint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft", ["eagle", "medusa"])
def test_from_pretrained_generates_jax_tokens(ckpts, draft, tmp_path):
    """ServeAdapter.from_pretrained and LlavaMSD.from_pretrained over the
    same checkpoint: the same engine budgets (an explicit EAGLE tree, or
    the medusa taper from max_seq_len), EOS, image rows and vocabulary
    classes; their generators commit the same tokens, text and image."""
    path = ckpts["draft"] if draft == "eagle" else \
        _medusa_draft(str(tmp_path / "medusa"), False)
    kw = dict(eng=JEng(max_seq_len=256, prompt_pad_multiple=32,
                       tree=JTree(**TREE))) if draft == "eagle" \
        else dict(max_seq_len=256)
    theirs = LlavaMSD.from_pretrained(ckpts["llava"], path,
                                      dtype=jnp.float32, **kw)
    if draft == "eagle":
        kw["eng"] = EngineConfig(max_seq_len=256, prompt_pad_multiple=32,
                                 tree=TreeConfig(**TREE))
    mine = ServeAdapter.from_pretrained(ckpts["llava"], path,
                                        dtype=torch.float32, device="cpu",
                                        **kw)
    assert mine.gen.eng.max_seq_len == theirs.gen.eng.max_seq_len == 256
    assert mine.gen.eng.tree.__dict__ == theirs.gen.eng.tree.__dict__
    assert (mine.gen.n_img, mine.gen.eos_id) == \
        (theirs.gen.n_img, theirs.gen.eos_id)
    # the port processes images at the tower's size (the JAX adapter keeps
    # its 336 default whatever the tower)
    assert mine.image_size == 28
    np.testing.assert_array_equal(mine.vocab_class, theirs.vocab_class)
    ids = np.arange(3, 14, dtype=np.int32)
    a = mine.gen.generate(ids, max_new_tokens=12)
    b = theirs.gen.generate(ids, max_new_tokens=12)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert (a.accept_steps, a.accept_len_sum) == \
        (b.accept_steps, b.accept_len_sum)
    px = np.random.default_rng(2).normal(size=(3, 28, 28)).astype(
        np.float32)
    ids[2] = -200
    a = mine.gen.generate(ids, mine.encode_image_fn(px), 12)
    b = theirs.gen.generate(ids, theirs.encode_image_fn(jnp.asarray(px)), 12)
    np.testing.assert_array_equal(a.tokens, b.tokens)


def test_server_main_serves_a_checkpoint(ckpts):
    """server.main's server (flags parsed, the checkpoint loaded, on a
    thread instead of blocking) answers /generate as the adapter's
    generator does, and /health."""
    from tests.test_torch_serve import _post

    args = TServer.parse_args([
        "--pretrained", ckpts["llava"], "--msd_model_path",
        _medusa_draft(str(ckpts["root"] / "server_draft"), False),
        "--port", "0", "--max-seq-len", "256", "--device", "cpu"])
    httpd = TServer.server_from_args(args)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        out = _post(port, "/generate", {"prompt": "count to ten",
                                        "max_new_tokens": 10})
        adapter = httpd.worker.adapter
        assert adapter.gen.eng.max_seq_len == 256
        # off the card the weights load in fp32
        assert adapter.gen.params["target"]["embed_tokens"].dtype == \
            torch.float32
        assert adapter.gen.dcfg.medusa_heads == 3
        again = _post(port, "/generate", {"prompt": "count to ten",
                                          "max_new_tokens": 10})
        assert out["text"] == again["text"]
        assert 0 < out["tokens_generated"] <= 10
        ar = _post(port, "/generate", {"prompt": "count to ten",
                                       "max_new_tokens": 10,
                                       "use_msd": False})
        assert ar["text"] == out["text"]      # greedy MSD == greedy AR
    finally:
        TServer.shutdown(httpd)


def test_cli_loads_a_checkpoint_as_the_server_does(ckpts):
    """cli's adapter over a checkpoint: off the card in fp32, as
    server.main's (``ServeAdapter.from_pretrained`` picks the dtype from
    the device for both)."""
    import argparse

    args = argparse.Namespace(
        tiny=False, pretrained=ckpts["llava"], device="cpu", no_msd=False,
        msd_model_path=_medusa_draft(str(ckpts["root"] / "cli_draft"),
                                     False), max_new_tokens=8)
    adapter = cli._load_adapter(args)
    for w in bridge.flatten(adapter.gen.params["target"]).values():
        assert w.dtype == torch.float32 and w.device.type == "cpu"


def test_cli_main_tiny_answers_a_piped_turn(monkeypatch, capsys):
    """cli.main --tiny reads one turn from stdin, streams the assistant's
    reply and ends at EOF."""
    monkeypatch.setattr(sys, "stdin", io.StringIO("hello there\n"))
    assert cli.main(["--tiny", "--device", "cpu",
                     "--max-new-tokens", "8"]) == 0
    out = capsys.readouterr()
    assert "chat ready" in out.err
    reply, rest = out.out[len("USER: ASSISTANT: "):].split("\n", 1)
    assert out.out.startswith("USER: ASSISTANT: ") and reply
    assert rest == "USER: "          # the next turn's prompt, then EOF
