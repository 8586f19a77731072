"""Checkpoint loading: HF LLaVA-1.5 and MSD draft checkpoints -> the port's
param dicts on a device (the JAX package's ``utils/weights.py``).

Reference loaders: LLaVA/llava/model/builder.py:26-167
(load_pretrained_model) and EAGLE/eagle/model/ea_model.py:116-142 (draft
weights from pytorch_model.bin or model.safetensors). Safetensors files
are read with the port's own reader (``utils/safetensors_io``: mapped,
any dtype, bf16 included), ``pytorch_model*.bin`` with
``torch.load(weights_only=True)``; tensors stay in their source dtype on
the host until the importers upload them and cast on the device.
``save_llava``, ``save_qwen2_vl`` and ``save_draft`` write the layouts
the loaders read. ``load_qwen2_vl`` reads a HF Qwen2-VL checkpoint (the
qkv-bias decoder under ``model.*``, ``lm_head.weight``, the vision tower
under ``visual.*``), ``load_qwen_vl_v1`` a Qwen-VL (v1) one (the fused-qkv
decoder under ``transformer.h.*``, the ViT and resampler under
``transformer.visual.*``).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from msd_tpu_torch.configs import (ClipVisionConfig, DraftConfig, LlamaConfig,
                                   LlavaConfig)
from msd_tpu_torch.utils.safetensors_io import load_file, save_file

State = Dict[str, torch.Tensor]


def _load_state(path: str) -> State:
    """Every tensor of a checkpoint directory (safetensors preferred)."""
    state: State = {}
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        for f in st_files:
            state.update(load_file(f))
        return state
    bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if bins:
        for f in bins:
            state.update(torch.load(f, map_location="cpu",
                                    weights_only=True))
        return state
    raise FileNotFoundError(f"no safetensors/bin checkpoints under {path}")


def llama_config_from_json(path: str) -> LlamaConfig:
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    return LlamaConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        max_position_embeddings=cfg.get("max_position_embeddings", 4096),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
        rope_theta=cfg.get("rope_theta", 10000.0),
    )


def merge_lora_state(state: State, lora_path: str, log=None) -> State:
    """Merge a PEFT LoRA adapter dir into a flat base state dict:
    W += (alpha / r) * B @ A per adapted linear, in fp32 (the product in
    numpy, as the JAX package computes it); the adapter's non-LoRA
    trainables (projector etc.) override the base entries (builder.py:
    50-90)."""
    with open(os.path.join(lora_path, "adapter_config.json")) as f:
        acfg = json.load(f)
    scaling = acfg.get("lora_alpha", 16) / acfg.get("r", 16)
    astate = _load_state(lora_path)

    def canon(k: str) -> str:
        for pre in ("base_model.model.", "base_model."):
            if k.startswith(pre):
                return k[len(pre):]
        return k

    def f32(t: torch.Tensor) -> np.ndarray:
        return t.float().numpy()

    state = dict(state)
    n_merged = 0
    for k, a in astate.items():
        if ".lora_A." not in k:
            continue
        target = canon(k).split(".lora_A.")[0] + ".weight"
        if target not in state:
            if log:
                log(f"merge_lora: no base weight for {target}; skipping")
            continue
        b = astate[k.replace(".lora_A.", ".lora_B.")]
        state[target] = torch.from_numpy(
            f32(state[target]) + scaling * (f32(b) @ f32(a)))
        n_merged += 1
    for k, v in astate.items():
        if ".lora_A." not in k and ".lora_B." not in k:
            state[canon(k)] = v
    if log:
        log(f"merge_lora: merged {n_merged} adapted linears "
            f"(scaling={scaling})")
    return state


def clip_config_from_state(vis_state: State,
                           heads: Optional[int] = None) -> ClipVisionConfig:
    """The CLIP tower config from weight shapes (a prefix-stripped state of
    ``vision_model.*`` keys). The head count is not in the shapes; it
    defaults to hidden // 64 (CLIP's 64-dim heads)."""
    pe = vis_state["vision_model.embeddings.patch_embedding.weight"]
    hidden, _, patch, _ = pe.shape
    npos = vis_state[
        "vision_model.embeddings.position_embedding.weight"].shape[0]
    grid = int(round((npos - 1) ** 0.5))
    n_layers = 1 + max(int(k.split(".")[3]) for k in vis_state
                       if k.startswith("vision_model.encoder.layers."))
    inter = vis_state[
        "vision_model.encoder.layers.0.mlp.fc1.weight"].shape[0]
    return ClipVisionConfig(
        hidden_size=int(hidden), intermediate_size=int(inter),
        num_hidden_layers=n_layers,
        num_attention_heads=heads or max(1, hidden // 64),
        image_size=grid * patch, patch_size=int(patch))


TOWER_PREFIX = "model.vision_tower.vision_tower."


def load_llava(path: str, dtype=torch.bfloat16, device="cuda"
               ) -> Tuple[Dict, LlavaConfig]:
    """A local LLaVA-1.5 checkpoint dir -> ({target, vision, projector},
    config) on ``device`` in ``dtype``.

    The llava-hf / liuhaotian layout: LM weights under ``model.*``, the
    projector under ``model.mm_projector.*``, the CLIP tower under
    ``model.vision_tower.vision_tower.vision_model.*`` or in a separate
    CLIP checkpoint dir named by ``mm_vision_tower`` in config.json. A LoRA
    adapter dir (``adapter_config.json``) is merged into its local base
    model."""
    from msd_tpu_torch.models.clip_vit import params_from_hf_clip
    from msd_tpu_torch.models.llama import params_from_hf
    from msd_tpu_torch.models.llava import params_from_hf_projector

    if os.path.exists(os.path.join(path, "adapter_config.json")):
        with open(os.path.join(path, "adapter_config.json")) as f:
            base = json.load(f).get("base_model_name_or_path", "")
        if not os.path.isdir(base):
            raise FileNotFoundError(
                f"LoRA adapter at {path} needs a local base model dir; "
                f"base_model_name_or_path={base!r} not found")
        state = merge_lora_state(_load_state(base), path)
        tcfg = llama_config_from_json(base)
    else:
        state = _load_state(path)
        tcfg = llama_config_from_json(path)

    target = params_from_hf(state, tcfg, "model.", dtype, device)
    projector = params_from_hf_projector(state, dtype, device)
    if any(k.startswith(TOWER_PREFIX + "vision_model.") for k in state):
        vis_state = {k[len(TOWER_PREFIX):]: v for k, v in state.items()
                     if k.startswith(TOWER_PREFIX + "vision_model.")}
    else:
        with open(os.path.join(path, "config.json")) as f:
            tower_path = json.load(f).get("mm_vision_tower")
        if not (tower_path and os.path.isdir(tower_path)):
            raise FileNotFoundError(
                "vision tower weights not found in checkpoint; set "
                "mm_vision_tower in config.json to a local CLIP dir")
        vis_state = _load_state(tower_path)
    vcfg = clip_config_from_state(vis_state)
    vision = params_from_hf_clip(vis_state, vcfg, dtype=dtype, device=device)
    return ({"target": target, "vision": vision, "projector": projector},
            LlavaConfig(text=tcfg, vision=vcfg))


def load_draft(path: str, tcfg: LlamaConfig,
               base_embed: Optional[torch.Tensor] = None,
               dtype=torch.bfloat16, device="cuda") -> Tuple[Dict, DraftConfig]:
    """An MSD/EAGLE draft checkpoint (lucylyn/MSD-LLaVA1.5-*B layout) ->
    (params, config). Medusa heads, this framework's extension, are
    stacked ``medusa.mw`` [K, H, H] / ``medusa.mb`` [K, H] or per head
    ``medusa.{k}.w`` / ``.b``. A checkpoint without ``embed_tokens`` (the
    reference trains with the base embedding frozen) takes
    ``base_embed``, the target's; a tensor already on ``device`` in
    ``dtype`` is shared, not copied."""
    from msd_tpu_torch.models.draft import params_from_torch_draft
    from msd_tpu_torch.models.llama import upload

    state = dict(_load_state(path))
    med = None
    if "medusa.mw" in state:
        med = {"mw": state.pop("medusa.mw"), "mb": state.pop("medusa.mb")}
    elif "medusa.0.w" in state:
        ws, bs, k = [], [], 0
        while f"medusa.{k}.w" in state:
            ws.append(state.pop(f"medusa.{k}.w"))
            bs.append(state.pop(f"medusa.{k}.b"))
            k += 1
        med = {"mw": torch.stack(ws), "mb": torch.stack(bs)}
    dcfg = DraftConfig(text=tcfg,
                       medusa_heads=med["mw"].shape[0] if med else 0)
    if "embed_tokens.weight" not in state:
        if base_embed is None:
            raise ValueError("draft checkpoint lacks embed_tokens; pass "
                             "base_embed from the target model")
        state["embed_tokens.weight"] = base_embed
    params = params_from_torch_draft(state, dcfg, dtype, device)
    if med is not None:
        params["medusa"] = {k: upload(v, device, dtype)
                            for k, v in med.items()}
    return params, dcfg


def save_draft(params: Dict, path: str, include_embed: bool = False) -> str:
    """Export a draft param dict (medusa heads included) as the fp32
    torch-layout safetensors file ``load_draft`` reads (the reference
    ships cnets state_dicts the same way; ``medusa.mw``/``.mb`` is this
    framework's extension). Returns the file's path."""
    from msd_tpu_torch.models.llama import _HF_LAYER_MAP

    os.makedirs(path, exist_ok=True)
    st = {}
    layers = params["layers"]
    for i in range(layers["q_proj"].shape[0]):
        for ours, (theirs, transpose) in _HF_LAYER_MAP.items():
            if ours == "input_layernorm" and i == 0:
                continue  # EAGLE layer 0 has no input_layernorm
            w = layers[ours][i].float()
            st[f"layers.{i}.{theirs}"] = w.T if transpose else w
    st["fc.weight"] = params["fc_w"].float().T
    if "fc_b" in params:
        st["fc.bias"] = params["fc_b"].float()
    if include_embed and "embed_tokens" in params:
        st["embed_tokens.weight"] = params["embed_tokens"].float()
    if "medusa" in params:
        st["medusa.mw"] = params["medusa"]["mw"].float()
        st["medusa.mb"] = params["medusa"]["mb"].float()
    out = os.path.join(path, "model.safetensors")
    save_file(st, out)
    return out


def hf_llava_state(params: Dict) -> Dict[str, torch.Tensor]:
    """The HF-layout state dict of a LLaVA param dict (the inverse of
    ``load_llava``'s importers), as views and transposes of its tensors,
    in order: the LM (layer by layer), the projector, the CLIP tower."""
    from msd_tpu_torch.models.llama import _HF_LAYER_MAP

    tp, vp, pp = params["target"], params["vision"], params["projector"]
    st = {"model.embed_tokens.weight": tp["embed_tokens"]}
    for i in range(tp["layers"]["q_proj"].shape[0]):
        for ours, (theirs, transpose) in _HF_LAYER_MAP.items():
            w = tp["layers"][ours][i]
            st[f"model.layers.{i}.{theirs}"] = w.T if transpose else w
    st["model.norm.weight"] = tp["norm"]
    st["lm_head.weight"] = tp["lm_head"].T
    for j, name in ((0, "fc1"), (2, "fc2")):
        st[f"model.mm_projector.{j}.weight"] = pp[name].T
        st[f"model.mm_projector.{j}.bias"] = pp[name + "_b"]
    v = TOWER_PREFIX + "vision_model."
    h = vp["patch_embed"].shape[1]
    p = int(round((vp["patch_embed"].shape[0] // 3) ** 0.5))
    st[v + "embeddings.patch_embedding.weight"] = \
        vp["patch_embed"].T.reshape(h, 3, p, p)
    st[v + "embeddings.class_embedding"] = vp["class_embed"]
    st[v + "embeddings.position_embedding.weight"] = vp["pos_embed"]
    st[v + "pre_layrnorm.weight"] = vp["pre_ln_w"]
    st[v + "pre_layrnorm.bias"] = vp["pre_ln_b"]
    names = {"ln1_w": "layer_norm1.weight", "ln1_b": "layer_norm1.bias",
             "ln2_w": "layer_norm2.weight", "ln2_b": "layer_norm2.bias",
             "fc1": "mlp.fc1.weight", "fc1_b": "mlp.fc1.bias",
             "fc2": "mlp.fc2.weight", "fc2_b": "mlp.fc2.bias"}
    for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                         ("o", "out_proj")):
        names[f"{ours}_proj"] = f"self_attn.{theirs}.weight"
        names[f"{ours}_bias"] = f"self_attn.{theirs}.bias"
    for i in range(vp["layers"]["q_proj"].shape[0]):
        for ours, theirs in names.items():
            w = vp["layers"][ours][i]
            st[f"{v}encoder.layers.{i}.{theirs}"] = \
                w.T if w.dim() == 2 else w
    return st


SHARD_BYTES = 5 * 10 ** 9      # the HF hub's default shard size


def _save_shards(st: Dict[str, torch.Tensor], path: str, dtype) -> int:
    """Write a HF state dict as ``model-0000i-of-0000n.safetensors``
    shards of at most SHARD_BYTES each (a tensor is never split) and
    ``model.safetensors.index.json``, every tensor in ``dtype``, cast and
    copied to the host one shard at a time. Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    shards, cur, size = [], [], 0
    for name, t in st.items():
        n = t.numel() * dtype.itemsize
        if cur and size + n > SHARD_BYTES:
            shards.append(cur)
            cur, size = [], 0
        cur.append(name)
        size += n
    shards.append(cur)
    weight_map, written = {}, 0
    for i, names in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file({k: st[k].to(dtype) for k in names},
                  os.path.join(path, fname), {"format": "pt"})
        written += os.path.getsize(os.path.join(path, fname))
        weight_map.update({k: fname for k in names})
    total = sum(t.numel() * dtype.itemsize for t in st.values())
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return written


def save_llava(params: Dict, lcfg: LlavaConfig, path: str,
               dtype=torch.bfloat16) -> int:
    """Write a LLaVA param dict as the HF checkpoint ``load_llava`` reads:
    safetensors shards (``_save_shards``) and ``config.json``, every
    tensor in ``dtype``. Returns the bytes written."""
    written = _save_shards(hf_llava_state(params), path, dtype)
    t, v = lcfg.text, lcfg.vision
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["LlavaLlamaForCausalLM"],
            "model_type": "llava", "vocab_size": t.vocab_size,
            "hidden_size": t.hidden_size,
            "intermediate_size": t.intermediate_size,
            "num_hidden_layers": t.num_hidden_layers,
            "num_attention_heads": t.num_attention_heads,
            "num_key_value_heads": t.num_key_value_heads,
            "max_position_embeddings": t.max_position_embeddings,
            "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
            "mm_projector_type": lcfg.mm_projector_type,
            "mm_hidden_size": v.hidden_size,
            "mm_vision_select_layer": v.select_layer,
            "torch_dtype": str(dtype).split(".")[-1]}, f, indent=1)
    return written


def load_qwen2_vl(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local Qwen2-VL checkpoint dir -> (lm_params, vision_params,
    text_cfg, vision_cfg) on ``device`` in ``dtype`` (the JAX
    ``load_qwen2_vl``): the text config from config.json's top level
    (``rope_scaling.mrope_section``), the tower's from its
    ``vision_config``, the merger's output width from the LM's hidden."""
    from msd_tpu_torch.models.qwen2vl import (Qwen2VLTextConfig,
                                              params_from_hf_qwen2)
    from msd_tpu_torch.models.qwen2vl_vision import (
        Qwen2VisionConfig, params_from_hf_qwen_vision)

    state = _load_state(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    tcfg = Qwen2VLTextConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        num_key_value_heads=cfg.get("num_key_value_heads",
                                    cfg["num_attention_heads"]),
        max_position_embeddings=cfg.get("max_position_embeddings", 32768),
        rms_norm_eps=cfg.get("rms_norm_eps", 1e-6),
        rope_theta=cfg.get("rope_theta", 1e6),
        mrope_section=tuple(cfg.get("rope_scaling", {}).get(
            "mrope_section", (16, 24, 24))))
    vc = cfg.get("vision_config", {})
    vcfg = Qwen2VisionConfig(
        embed_dim=vc.get("embed_dim", 1280), depth=vc.get("depth", 32),
        num_heads=vc.get("num_heads", 16),
        mlp_ratio=vc.get("mlp_ratio", 4.0),
        patch_size=vc.get("patch_size", 14),
        temporal_patch_size=vc.get("temporal_patch_size", 2),
        spatial_merge_size=vc.get("spatial_merge_size", 2),
        hidden_size=cfg["hidden_size"])
    lm = params_from_hf_qwen2(state, tcfg, "model.", dtype, device)
    vision = params_from_hf_qwen_vision(state, vcfg, "visual.", dtype,
                                        device)
    return lm, vision, tcfg, vcfg


def load_qwen_vl_v1(path: str, dtype=torch.bfloat16, device="cuda"):
    """A local Qwen-VL (v1) checkpoint dir -> (lm_params, vision_params,
    text_cfg, vision_cfg) on ``device`` in ``dtype`` (the JAX
    ``load_qwen_vl_v1``): the public Qwen/Qwen-VL remote-code names
    (``transformer.h.*`` with the fused ``c_attn``, ``transformer.visual.*``
    the ViT and resampler); the text config from config.json's top level
    (``intermediate_size // 2``: the w1/w2 halves, ``layer_norm_epsilon``,
    ``rotary_emb_base``), the tower's from its ``visual`` block, each field
    defaulting to the public model's."""
    from msd_tpu_torch.models.qwen_vl_v1 import (
        QwenVLV1TextConfig, QwenVLVisionConfig, params_from_hf_qwen_v1,
        params_from_hf_qwen_vl_vision)

    state = _load_state(path)
    with open(os.path.join(path, "config.json")) as f:
        cfg = json.load(f)
    tcfg = QwenVLV1TextConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"] // 2,
        num_hidden_layers=cfg["num_hidden_layers"],
        num_attention_heads=cfg["num_attention_heads"],
        max_position_embeddings=cfg.get("max_position_embeddings", 8192),
        rms_norm_eps=cfg.get("layer_norm_epsilon", 1e-6),
        rope_theta=cfg.get("rotary_emb_base", 10000.0))
    vc = cfg.get("visual", {})
    vcfg = QwenVLVisionConfig(
        image_size=vc.get("image_size", 448),
        patch_size=vc.get("patch_size", 14),
        width=vc.get("width", 1664), layers=vc.get("layers", 48),
        heads=vc.get("heads", 16), mlp_size=vc.get("mlp_size", 8192),
        output_dim=vc.get("output_dim", cfg["hidden_size"]),
        n_queries=vc.get("n_queries", 256))
    lm = params_from_hf_qwen_v1(state, tcfg, dtype, device)
    vision = params_from_hf_qwen_vl_vision(state, vcfg,
                                           dtype=dtype, device=device)
    return lm, vision, tcfg, vcfg


def hf_qwen2_vl_state(lm: Dict, vision: Dict, vcfg
                      ) -> Dict[str, torch.Tensor]:
    """The HF-layout state dict of a Qwen2-VL LM and tower (the inverse of
    ``load_qwen2_vl``'s importers), as views and transposes of their
    tensors: the LM layer by layer, ``lm_head``, the tower."""
    from msd_tpu_torch.models.llama import _HF_BIAS_MAP, _HF_LAYER_MAP
    from msd_tpu_torch.models.qwen2vl_vision import hf_qwen_vision_state

    st = {"model.embed_tokens.weight": lm["embed_tokens"]}
    layer_map = dict(_HF_LAYER_MAP, **_HF_BIAS_MAP)
    for i in range(lm["layers"]["q_proj"].shape[0]):
        for ours, (theirs, transpose) in layer_map.items():
            w = lm["layers"][ours][i]
            st[f"model.layers.{i}.{theirs}"] = w.T if transpose else w
    st["model.norm.weight"] = lm["norm"]
    st["lm_head.weight"] = lm["lm_head"].T
    st.update(hf_qwen_vision_state(vision, vcfg))
    return st


def save_qwen2_vl(lm: Dict, vision: Dict, tcfg, vcfg, path: str,
                  dtype=torch.bfloat16) -> int:
    """Write a Qwen2-VL LM and tower as the HF checkpoint
    ``load_qwen2_vl`` reads: safetensors shards (``_save_shards``) and a
    ``config.json`` with ``rope_scaling.mrope_section`` and
    ``vision_config``, every tensor in ``dtype``. Returns the bytes
    written."""
    written = _save_shards(hf_qwen2_vl_state(lm, vision, vcfg), path, dtype)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({
            "architectures": ["Qwen2VLForConditionalGeneration"],
            "model_type": "qwen2_vl", "vocab_size": tcfg.vocab_size,
            "hidden_size": tcfg.hidden_size,
            "intermediate_size": tcfg.intermediate_size,
            "num_hidden_layers": tcfg.num_hidden_layers,
            "num_attention_heads": tcfg.num_attention_heads,
            "num_key_value_heads": tcfg.num_key_value_heads,
            "max_position_embeddings": tcfg.max_position_embeddings,
            "rms_norm_eps": tcfg.rms_norm_eps, "rope_theta": tcfg.rope_theta,
            "rope_scaling": {"type": "mrope",
                             "mrope_section": list(tcfg.mrope_section)},
            "tie_word_embeddings": False,
            "vision_config": {
                "embed_dim": vcfg.embed_dim, "depth": vcfg.depth,
                "num_heads": vcfg.num_heads, "mlp_ratio": vcfg.mlp_ratio,
                "patch_size": vcfg.patch_size,
                "temporal_patch_size": vcfg.temporal_patch_size,
                "spatial_merge_size": vcfg.spatial_merge_size,
                "in_chans": vcfg.in_channels,
                "hidden_size": vcfg.hidden_size},
            "torch_dtype": str(dtype).split(".")[-1]}, f, indent=1)
    return written
