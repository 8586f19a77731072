"""Rank program of tests/test_torch_parallel_paths.py: one rank of a world
of two gloo ranks on the CPU, fp32, tiny sizes, TP=2. Imports torch and
the port, never JAX.

    python -m tests.torch_parallel_paths_ranks RANK WORLD STORE WORKDIR

Reads WORKDIR/inputs.pkl (the JAX package's weights, the prompts and the
calibration tables fitted on JAX's collected records, written by the
test) and writes WORKDIR/rank<RANK>.pt: on the sharded generator,
``generate_batch`` of two prompts and each prompt's solo run, a
``ContinuousScheduler`` of 2 slots over 3 staggered requests, a collecting
run (and the same with the feature's q_proj partial sums left unsummed),
a calibrated run after ``set_calibrator`` (rank 1 offering other tables),
a two-image ``generate`` and ``naive_generate``, one ``score``, a
``generate`` with ``canonical_attn=False`` and ``attn_impl="pallas"``, whether
inline prompts and ``cuda_graphs=True`` are refused, and the
``agreed_union`` of rank-specific sets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import pickle
import sys

import torch

from msd_tpu_torch import bridge
from msd_tpu_torch.calib.device import CalibTables
from msd_tpu_torch.configs import (DraftConfig, EngineConfig, LlamaConfig,
                                   TreeConfig)
from msd_tpu_torch.engine.generator import MSDGenerator
from msd_tpu_torch.models import draft as D
from msd_tpu_torch.models import llama as L
from msd_tpu_torch.parallel import comm
from msd_tpu_torch.parallel.sharding import (draft_param_specs,
                                             llama_param_specs, make_mesh,
                                             shard_params)
from msd_tpu_torch.serve.continuous import ContinuousScheduler, Request

DEV = "cpu"


@contextlib.contextmanager
def q_partial_unsummed():
    """The planted fault: the calibration feature's ``x @ q_proj`` stays
    this rank's partial product (``draft.stored_proj`` without its sum
    over ``model`` for q_proj)."""
    orig = D.stored_proj

    def faulty(lp, name, x, mesh=None):
        if name != "q_proj":
            return orig(lp, name, x, mesh)
        w = L._w(lp, name, x.dtype)
        lo = mesh.coords["model"] * w.shape[0]
        return x[..., lo:lo + w.shape[0]] @ w

    D.stored_proj = faulty
    try:
        yield
    finally:
        D.stored_proj = orig


def _run(inp: dict, rank: int, mesh) -> dict:
    cfg = LlamaConfig.tiny(**inp["cfg"])
    dcfg = DraftConfig(text=cfg)
    tp = shard_params(bridge.to_torch(inp["tp"], DEV), llama_param_specs(cfg),
                      mesh)
    dp = bridge.to_torch(inp["dp"], DEV)
    dp = shard_params(dp, draft_param_specs(dcfg, "fc_b" in dp), mesh)
    eng = EngineConfig(tree=TreeConfig(**inp["tree"]), **inp["eng"])
    gen = MSDGenerator(tp, dp, cfg, dcfg, eng, n_img=inp["n_img"],
                       eos_id=-1, device=DEV, cuda_graphs=False)
    ids, new = inp["ids"], inp["new"]
    feats = {k: torch.from_numpy(v) for k, v in inp["feats"].items()}
    out = {"rank": rank}

    lanes = gen.generate_batch([ids["a"], ids["b"]], [feats["a"], feats["b"]],
                               new["batch"])
    out["batch"] = [(r.tokens, r.accept_steps) for r in lanes]
    out["solo"] = []
    for k in "ab":
        r = gen.generate(ids[k], feats[k], new["batch"])
        out["solo"].append((r.tokens, r.accept_steps))

    sched = ContinuousScheduler(gen, n_slots=2, segment=inp["segment"])
    reqs = [Request(ids=ids[k], img_feats=feats[k], max_new=n)
            for k, n in inp["requests"]]
    sched.submit(reqs[0])
    sched.submit(reqs[1])
    sched.step()
    sched.submit(reqs[2])
    sched.run_all()
    sched.close()
    out["sched"] = [(r.tokens, r.error) for r in reqs]

    c = gen.generate(ids["a"], feats["a"], new["calib"],
                     collect_calibration=True)
    out["collect"] = {"tokens": c.tokens, "steps": c.accept_steps,
                      "data": c.calib_data}
    with q_partial_unsummed():
        f = gen.generate(ids["a"], feats["a"], new["calib"],
                         collect_calibration=True)
    out["fault_attn"] = f.calib_data["attn"]

    # rank 1 offers other tables: set_calibrator installs rank 0's
    alpha = inp["base_alpha"] + rank
    gen.set_calibrator(CalibTables.from_host(inp["export"],
                                             inp["vocab_class"], alpha, DEV))
    out["tables"] = list(gen.params["calib"])
    u = gen.generate(ids["b"], feats["b"], new["calib"], use_calibration=True)
    out["use"] = (u.tokens, u.accept_steps, u.accept_len_sum)

    blocks = [feats["m0"], feats["m1"]]
    out["multi"] = {
        "msd": gen.generate(ids["m"], blocks, new["multi"]).tokens,
        "ar": gen.naive_generate(ids["m"], blocks, new["multi"]).tokens}

    ids_s, start = inp["score"]
    out["score"] = gen.score(ids_s, start, feats["a"])

    # the original tree_bias verification at the local heads, its tree
    # rows through K1's twin
    nc_cfg = dataclasses.replace(cfg, attn_impl="pallas")
    nc = MSDGenerator(tp, dp, nc_cfg, dataclasses.replace(dcfg, text=nc_cfg),
                      dataclasses.replace(eng, canonical_attn=False),
                      n_img=inp["n_img"], eos_id=-1, device=DEV,
                      cuda_graphs=False)
    r = nc.generate(ids["a"], feats["a"], new["batch"])
    out["noncanonical"] = (r.tokens, r.accept_steps)

    refused = {}
    try:
        MSDGenerator(tp, dp, cfg, dcfg, eng, n_img=inp["n_img"], device=DEV,
                     image_mode="inline", cuda_graphs=False)
        refused["inline"] = ""
    except NotImplementedError as e:
        refused["inline"] = str(e)
    try:
        MSDGenerator(tp, dp, cfg, dcfg, eng, n_img=inp["n_img"], device=DEV,
                     cuda_graphs=True)
        refused["graphs"] = ""
    except ValueError as e:
        refused["graphs"] = str(e)
    out["refused"] = refused
    names = ("q_proj", "down_proj", "lm_head")
    out["union"] = L.agreed_union({names[rank]}, names, mesh, DEV)
    return out


def main(rank: int, world: int, store: str, workdir: str) -> None:
    torch.set_num_threads(1)
    comm.init(rank, world, store)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    out = _run(inp, rank, make_mesh(world, dp=1, tp=world))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    comm.leave()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
