"""Rank program of tests/test_torch_parallel.py: one rank of a world of four
gloo ranks on the CPU, fp32, tiny sizes. Imports torch and the port, never
JAX.

    python -m tests.torch_parallel_ranks RANK WORLD STORE WORKDIR

Reads WORKDIR/inputs.pkl (the JAX package's weights and inputs as numpy
trees, written by the test) and writes WORKDIR/rank<RANK>.pt: TP=4
decodes (EAGLE, medusa, int8 and int4 targets), the TP prefill hidden with
and without the planted fault, this rank's slices of seeded bf16, int8
and int4 trees, ZeRO-1 specs on a (2, 2) mesh, the 4-stage pipeline and
both 4-shard sequence modes, and whether ``cuda_graphs=True`` over gloo is
refused.
"""

from __future__ import annotations

import os
import pickle
import sys

import torch

from msd_tpu_torch import bridge
from msd_tpu_torch.configs import (DraftConfig, EngineConfig, LlamaConfig,
                                   TreeConfig)
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.ops.attention import causal_prefill_bias
from msd_tpu_torch.parallel import comm
from msd_tpu_torch.parallel.pipeline import (pipeline_forward,
                                             shard_layers_for_pipeline)
from msd_tpu_torch.parallel.sequence import sequence_parallel_forward
from msd_tpu_torch.parallel.sharding import (draft_param_specs,
                                             llama_param_specs, make_mesh,
                                             shard_params, zero_opt_specs)

DEV = "cpu"


def seeded_trees(cfg: LlamaConfig) -> dict:
    """The bf16 target of seed 3 and its int8 and int4 transforms (the
    test rebuilds them to reassemble the slices)."""
    tp = L.init_llama_params(cfg, torch.Generator().manual_seed(3), DEV,
                             torch.bfloat16)
    return {"bf16": tp, "int8": L.quantize_llama_params(tp, bits=8),
            "int4": L.quantize_llama_params(tp, bits=4)}


def _decode(case: dict, mesh, max_new: int) -> dict:
    cfg = LlamaConfig.tiny(**case["cfg"])
    dcfg = DraftConfig(text=cfg, medusa_heads=case["medusa_heads"])
    tp = shard_params(bridge.to_torch(case["tp"], DEV), llama_param_specs(cfg),
                      mesh)
    dp = bridge.to_torch(case["dp"], DEV)
    dp = shard_params(dp, draft_param_specs(dcfg, "fc_b" in dp), mesh)
    eng = EngineConfig(tree=TreeConfig(**case["tree"]), **case["eng"])
    gen = MSDGenerator(tp, dp, cfg, dcfg, eng, eos_id=case["eos_id"],
                       device=DEV, cuda_graphs=False)
    msd = gen.generate(case["ids"], max_new_tokens=max_new)
    ar = gen.naive_generate(case["ids"], max_new_tokens=max_new)
    out = {"tokens": msd.tokens, "steps": msd.accept_steps,
           "ar": ar.tokens}
    try:
        MSDGenerator(tp, dp, cfg, dcfg, eng, device=DEV, cuda_graphs=True)
        out["graphs_refused"] = False
    except ValueError:
        out["graphs_refused"] = True
    return out


def _hidden(case: dict, mesh) -> dict:
    """The TP prefill hidden of the EAGLE case's prompt, and the same with
    the o_proj sum skipped."""
    from chip_smoke import o_proj_sum_skipped

    cfg = LlamaConfig.tiny(**case["cfg"])
    tp = shard_params(bridge.to_torch(case["tp"], DEV), llama_param_specs(cfg),
                      mesh)
    ids = torch.from_numpy(case["ids"])
    T = len(ids)
    cos, sin = L.make_rope(cfg, 64, DEV)

    def forward():
        kv = L.init_kv_cache(cfg, T, torch.float32, DEV, mesh=mesh)
        return L.llama_forward(tp, cfg, L.embed_tokens(tp, ids),
                               torch.arange(T, dtype=torch.int32), kv, 0,
                               causal_prefill_bias(T, T, device=DEV), cos,
                               sin)[0]

    good = forward()
    with o_proj_sum_skipped():
        bad = forward()
    return {"good": good, "fault": bad,
            "kv_heads": L.init_kv_cache(cfg, T, device=DEV,
                                        mesh=mesh)["k"].shape[2]}


def main(rank: int, world: int, store: str, workdir: str) -> None:
    torch.set_num_threads(1)
    comm.init(rank, world, store)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(world, dp=1, tp=world)
    out = {"rank": rank, "mesh_shape": make_mesh().shape}
    for name in ("eagle", "medusa"):
        out[name] = _decode(inp[name], mesh, 16)
    for bits in (8, 4):
        out[f"int{bits}"] = _decode(inp[f"int{bits}"], mesh, 10)
    out["hidden"] = _hidden(inp["eagle"], mesh)

    cfg = LlamaConfig.tiny(**inp["slices_cfg"])
    out["slices"] = {k: {n: v for n, v in
                         shard_params(t, llama_param_specs(cfg), mesh).items()
                         if n != "mesh"}
                     for k, t in seeded_trees(cfg).items()}

    zc = inp["zero"]
    zmesh = make_mesh(world, dp=2, tp=2)
    dcfg = DraftConfig(text=LlamaConfig.tiny(**zc["cfg"]))
    dparams = bridge.to_torch(zc["dp"], DEV)
    out["zero"] = zero_opt_specs(draft_param_specs(dcfg, "fc_b" in dparams),
                                 dparams, zmesh)

    pc = inp["pipeline"]
    pcfg = LlamaConfig.tiny(**pc["cfg"])
    stages = comm.Mesh((world,), ("stage",))
    params = shard_layers_for_pipeline(bridge.to_torch(pc["params"], DEV),
                                       stages)
    T = pc["emb"].shape[1]
    cos, sin = L.make_rope(pcfg, 64, DEV)
    out["pipeline"] = pipeline_forward(
        params, pcfg, torch.from_numpy(pc["emb"]),
        causal_prefill_bias(T, T, device=DEV), cos, sin, stages)

    sc = inp["sequence"]
    scfg = LlamaConfig.tiny(**sc["cfg"])
    shards = comm.Mesh((world,), ("seq",))
    params = bridge.to_torch(sc["params"], DEV)
    T = sc["emb"].shape[0]
    cos, sin = L.make_rope(scfg, 64, DEV)
    out["sequence"] = {mode: sequence_parallel_forward(
        params, scfg, torch.from_numpy(sc["emb"]),
        causal_prefill_bias(T, T, device=DEV), cos, sin, shards, mode=mode)
        for mode in ("gather", "ring")}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    comm.leave()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
