"""Rank program of tests/test_torch_parallel_train.py: one rank of a world
of four gloo ranks on the CPU, fp32, tiny sizes, on a (data 2, model 2)
mesh. Imports torch and the port, never JAX.

    python -m tests.torch_parallel_train_ranks RANK WORLD STORE WORKDIR

Reads WORKDIR/inputs.pkl (the JAX package's weights, records and configs
as numpy trees, written by the test) and writes WORKDIR/rank<RANK>.pt:
this rank's ZeRO-1 moment shapes and bytes, the gathered gradient of the
draft loss (and the same with megatron's *f* made the identity), three
``DraftTrainer(mesh=)`` steps with and without medusa heads (metrics and
gathered parameters after each), a save/restore round trip, and three
``LlavaFinetuner(mesh=)`` steps of stages 1 and 2.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys

import numpy as np
import torch

from msd_tpu_torch import bridge
from msd_tpu_torch.configs import DraftConfig, LlamaConfig
from msd_tpu_torch.models.llama import make_rope
from msd_tpu_torch.parallel import comm
from msd_tpu_torch.parallel.sharding import (_prune_specs, draft_param_specs,
                                             gather_params, leaves_with_specs,
                                             make_mesh, reduce_grads,
                                             shard_params)
from msd_tpu_torch.train import draft_train as DT
from msd_tpu_torch.train import finetune as FT
from msd_tpu_torch.train.trainer import (DraftTrainer, TrainerConfig,
                                         data_rows, tree_map)

DEV = "cpu"


@contextlib.contextmanager
def f_is_identity():
    """The planted fault: megatron's *f* passes the gradient through
    unsummed, so upstream of each layer only this rank's heads' share of
    the gradient arrives."""
    orig = comm.copy_to
    comm.copy_to = lambda x, mesh, axis="model": x
    try:
        yield
    finally:
        comm.copy_to = orig


def _paths(tree, prefix=""):
    """Path of every tensor of a tree in ``sharding.leaves_with_specs``
    order (sorted keys)."""
    out = []
    for k in sorted(tree):
        if k == "mesh":
            continue
        p = f"{prefix}/{k}"
        out += _paths(tree[k], p) if isinstance(tree[k], dict) else [p]
    return out


def _draft_cfg(case: dict, medusa: int) -> DraftConfig:
    return DraftConfig(text=LlamaConfig.tiny(**case["cfg"]),
                       medusa_heads=medusa)


def _trainer(case: dict, medusa: int, mesh, ckpt=None) -> DraftTrainer:
    dparams = bridge.to_torch(case["params"][medusa], DEV)
    tc = TrainerConfig(train=DT.TrainConfig(**case["train"]),
                       ckpt_dir=ckpt or "unused", **case["trainer"])
    return DraftTrainer(_draft_cfg(case, medusa), dparams,
                        torch.from_numpy(case["head"]), tc, DEV, mesh)


def _moments(tr: DraftTrainer) -> dict:
    """{path: exp_avg shape} of this rank's moments after the steps, the
    trained leaves that have none (no gradient reached them) and the ZeRO
    byte counts."""
    paths = dict(zip((id(p) for p, _ in _leaves(tr.params, tr.specs)),
                     _paths(tr.params)))
    shapes, none = {}, []
    for p, sl in zip(tr.zero.leaves, tr.zero.slices):
        st = tr.opt.state.get(sl, {})
        if "exp_avg" not in st:
            none.append(paths[id(p)])
            continue
        assert st["exp_avg"].shape == st["exp_avg_sq"].shape
        shapes[paths[id(p)]] = tuple(st["exp_avg"].shape)
    return {"shapes": shapes, "none": none,
            "bytes": tr.zero.moment_bytes(tr.opt)}


def _leaves(params, specs):
    return leaves_with_specs(params, _prune_specs(specs, params))


def sharded_grads(case: dict, mesh) -> dict:
    """The draft loss's gradient over the mesh: each data rank's rows of
    the batch, summed over ``data``, gathered over ``model``."""
    dcfg = _draft_cfg(case, 3)
    specs = draft_param_specs(dcfg, True)
    params = shard_params(bridge.to_torch(case["params"][3], DEV), specs,
                          mesh)
    for name, sub in params.items():
        if name not in ("mesh", "embed_tokens"):
            tree_map(lambda t: t.requires_grad_(True), sub)
    head = shard_params({"w": torch.from_numpy(case["head"])},
                        {"w": (None, "model")}, mesh)["w"]
    batch = data_rows(DT.Batch(**{k: torch.from_numpy(v.copy()) for k, v
                                  in case["grad_batch"].items()}), mesh)
    cos, sin = make_rope(dcfg.text, batch.hidden.shape[1] + 8, DEV)
    v, pl, _, _ = DT.draft_loss(params, dcfg, head, batch, cos, sin,
                                **case["grad_kw"])
    (1.0 * v + 0.1 * pl).backward()
    leaves = [p for p, _ in _leaves(params, specs) if p.grad is not None]
    reduce_grads([p.grad for p in leaves], mesh)
    grads = tree_map(lambda t: t.grad if t.grad is not None
                     else torch.zeros_like(t), params)
    return gather_params(grads, specs, mesh)


def draft_runs(case: dict, mesh, workdir: str, rank: int) -> dict:
    out = {}
    recs = case["records"]
    for medusa in (0, 3):
        tr = _trainer(case, medusa, mesh, os.path.join(workdir, "ckpt"))
        steps = []
        for e in range(3):
            m = tr.run_epoch([], recs[2 * e:2 * e + 2], log=lambda *a: None)
            steps.append({"metrics": m, "params": tr.gathered_params()})
        out[medusa] = {"steps": steps, "moments": _moments(tr),
                       "update_count": DT.update_count(tr.opt)}
        if medusa == 3:
            path = tr.save("mid")
            back = _trainer(case, medusa, mesh, os.path.join(workdir, "ckpt"))
            back.restore(path)
            same = all(torch.equal(a, b) for a, b in zip(
                [p for p, _ in _leaves(tr.params, tr.specs)],
                [p for p, _ in _leaves(back.params, back.specs)]))
            sa, sb = tr.opt.state_dict(), back.opt.state_dict()
            same_opt = sa["param_groups"] == sb["param_groups"] and all(
                torch.equal(v, sb["state"][i][k])
                for i, st in sa["state"].items() for k, v in st.items())
            epoch = (back.epoch, back.step_count)
            ma = tr.run_epoch([], recs[:2], log=lambda *a: None)
            mb = back.run_epoch([], recs[:2], log=lambda *a: None)
            cont = ma["loss"] == mb["loss"] and all(torch.equal(a, b) for a, b
                                                    in zip(tr.zero.slices,
                                                           back.zero.slices))
            out["restore"] = {"params": same, "opt": same_opt,
                              "continues": cont,
                              "epoch": epoch,
                              "files": sorted(os.listdir(path))}
    return out


def finetune_runs(case: dict, mesh) -> dict:
    cfg = LlamaConfig.tiny(**case["cfg"])
    out = {}
    for stage, kw in case["stages"].items():
        params = bridge.to_torch(case["params"], DEV)
        ft = FT.LlavaFinetuner(cfg, params, case["n_img"],
                               FT.FinetuneConfig(**kw), case["max_exp"],
                               mesh=mesh)
        batches = list(FT.batches_from_finetune_records(
            case["records"], 2, np.random.default_rng(case["seed"]),
            case["n_img"], case["vision_h"], device=DEV))
        steps = []
        for b in batches[:3]:
            m = ft.run(iter([b]), log=lambda *a: None)
            steps.append({"metrics": m, "params": ft.gathered_params()})
        lm = {}
        if "lm" in ft.zero:
            z, o = ft.zero["lm"], ft.opt["lm"]
            q = ft.params["target"]["layers"]["q_proj"]
            i = next(i for i, p in enumerate(z.leaves) if p is q)
            lm = {"q_proj": tuple(q.shape),
                  "q_proj_moment": tuple(o.state[z.slices[i]]
                                         ["exp_avg"].shape)}
        out[stage] = {"steps": steps, "groups": sorted(ft.opt), **lm}
    return out


def main(rank: int, world: int, store: str, workdir: str) -> None:
    torch.set_num_threads(1)
    comm.init(rank, world, store)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(world, dp=2, tp=2)
    out = {"rank": rank, "coords": mesh.coords}
    out["grads"] = sharded_grads(inp["draft"], mesh)
    with f_is_identity():
        out["grads_f_fault"] = sharded_grads(inp["draft"], mesh)
    out["draft"] = draft_runs(inp["draft"], mesh, workdir, rank)
    out["finetune"] = finetune_runs(inp["finetune"], mesh)
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    comm.leave()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
