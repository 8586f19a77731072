"""Draft-head training loop: the port of the JAX package's
``train/trainer.py``.

An epoch loop over records (``.npz`` files of ``train/data_gen`` records)
with the text -> visual curriculum, in-step input noise, AdamW with warmup
and a global-norm clip over fp32 master weights, and per-epoch torch
checkpoints with full optimizer state. The batch order of epoch e comes
from ``np.random.default_rng(e)``, the JAX trainer's numpy stream, so both
trainers see the same batches. With ``TrainerConfig.wandb_project`` the
step metrics go to W&B as ``train/*`` every ``log_every`` steps and the
epoch means as ``epoch/*`` (``harness.loggers.WandbLogger``, which does
nothing without the ``wandb`` package).
"""

from __future__ import annotations

import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from msd_tpu_torch.configs import DraftConfig
from msd_tpu_torch.models.llama import make_rope
from msd_tpu_torch.parallel.comm import Mesh, barrier
from msd_tpu_torch.parallel.sharding import (draft_param_specs,
                                             gather_params, shard_opt_state_zero,
                                             shard_params)
from msd_tpu_torch.train.draft_train import (Batch, TrainConfig,
                                             curriculum_visual_ratio,
                                             make_optimizer, train_step,
                                             trainable, trained_leaves)


@dataclass
class TrainerConfig:
    train: TrainConfig = field(default_factory=TrainConfig)
    batch_size: int = 2
    max_len: int = 512
    num_epochs: int = 40
    ckpt_dir: str = "checkpoints/draft"
    log_every: int = 50
    # W&B experiment logging (main_deepspeed.py:141-143 wandb.init); None
    # disables. The logger does nothing when wandb is unavailable/offline.
    wandb_project: Optional[str] = None


def _load_records(paths: List[str]) -> List[Dict[str, np.ndarray]]:
    return [dict(np.load(p)) for p in paths]


def prepad_records(records: List[Dict], max_len: int,
                   device) -> Dict[str, torch.Tensor]:
    """Pad, stack and move ALL records to ``device`` once; batches then
    index on the device."""

    def pad(a, value=0.0):
        out = np.full((max_len,) + a.shape[1:], value, a.dtype)
        out[:min(len(a), max_len)] = a[:max_len]
        return out

    def stack(name):
        return torch.from_numpy(np.stack([pad(np.asarray(g[name]))
                                          for g in records])).to(device)

    data = {k: stack(k) for k in ("emb_next", "hidden", "target",
                                  "loss_mask", "img_mask")}
    data["attn_len"] = torch.tensor(
        [min(int(g["attn_len"]), max_len) for g in records],
        dtype=torch.int32, device=device)
    return data


def batches_from_records(data: Dict[str, torch.Tensor], batch_size: int,
                         rng: np.random.Generator) -> Iterator[Batch]:
    """Batches of ``prepad_records`` output in the order of one
    ``rng.permutation``; a last incomplete batch is dropped."""
    n = data["attn_len"].shape[0]
    order = rng.permutation(n)
    dev = data["attn_len"].device
    for i in range(0, len(order) - batch_size + 1, batch_size):
        idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
        yield Batch(**{k: data[k][idx] for k in Batch._fields})


def tree_map(fn, tree):
    """``fn`` over the tensors of a nested dict of parameters (a tree's
    ``"mesh"`` entry, ``shard_params``', is carried over as it is)."""
    if isinstance(tree, dict):
        return {k: (v if k == "mesh" else tree_map(fn, v))
                for k, v in tree.items()}
    return fn(tree)


def data_rows(batch, mesh):
    """This rank's contiguous ``batch_size / dp`` rows of each tensor of a
    global batch (a NamedTuple) over the mesh's ``data`` axis."""
    dp = mesh.shape["data"]
    n = batch[0].shape[0]
    if n % dp:
        raise ValueError(f"batch size {n} does not split over data ({dp})")
    rows = n // dp
    return type(batch)(*(x.narrow(0, mesh.coords["data"] * rows, rows)
                         for x in batch))


class DraftTrainer:
    """Trains a copy of ``dparams`` (fp32 master weights) against the
    target's ``head_w``; the caller's tensors are not modified.

    With ``mesh`` (a (data, model) ``comm.Mesh`` from
    ``parallel/sharding.make_mesh``; every rank of it builds the trainer
    and runs the same calls) the copy is this rank's megatron shard
    (``draft_param_specs``), ``head_w`` is split on its columns, each
    batch of ``batches_from_records`` (the same order on every rank) gives
    each data rank its contiguous ``batch_size / dp`` rows, and the AdamW
    moments are ZeRO-1 slices over ``data`` (``shard_opt_state_zero``):
    one sharded step computes what one device computes for the global
    batch. ``cuda_graphs`` does not apply: the trainer runs eagerly.
    ``gathered_params`` rebuilds the full tree."""

    def __init__(self, dcfg: DraftConfig, dparams: Dict,
                 head_w: torch.Tensor, tc: TrainerConfig = TrainerConfig(),
                 device=None, mesh: Optional[Mesh] = None):
        self.dcfg, self.tc, self.mesh = dcfg, tc, mesh
        self.device = torch.device(device) if device is not None \
            else head_w.device
        self.params = tree_map(lambda t: t.detach().to(
            self.device, torch.float32, copy=True), dparams)
        # the loss multiplies fp32 activations by the head: cast it once
        self.head_w = head_w.to(self.device, torch.float32)
        self.zero = None
        if mesh is not None:
            if tc.batch_size % mesh.shape["data"]:
                raise ValueError(f"batch_size {tc.batch_size} does not "
                                 f"split over data ({mesh.shape['data']})")
            self.specs = draft_param_specs(dcfg, "fc_b" in dparams)
            self.params = shard_params(self.params, self.specs, mesh)
            self.head_w = shard_params({"w": self.head_w},
                                       {"w": (None, "model")}, mesh)["w"]
        for name, sub in self.params.items():
            if name != "mesh":
                tree_map(lambda t: t.requires_grad_(
                    trainable(tc.train, name)), sub)
        if mesh is None:
            self.opt = make_optimizer(tc.train, self.params)
        else:
            self.zero = shard_opt_state_zero(
                self.params, self.specs, mesh,
                trained_leaves(tc.train, self.params))
            self.opt = torch.optim.AdamW(
                self.zero.slices, lr=0.0, betas=(tc.train.b1, tc.train.b2),
                eps=1e-8, weight_decay=tc.train.weight_decay)
        self.cos_t, self.sin_t = make_rope(dcfg.text, tc.max_len + 8,
                                           self.device)
        self.rng = torch.Generator(device=self.device).manual_seed(0)
        self.step_count = 0
        self.epoch = 0
        self._data = (None, None)   # (key of a record list, its prepad)
        self.wandb = None
        if tc.wandb_project:
            from msd_tpu_torch.harness.loggers import WandbLogger
            self.wandb = WandbLogger(project=tc.wandb_project,
                                     config={"train": vars(tc.train),
                                             "batch_size": tc.batch_size,
                                             "max_len": tc.max_len})

    def _prepadded(self, records: List[Dict]) -> Dict[str, torch.Tensor]:
        """``prepad_records`` of ``records``, kept while the same record
        objects come back (run_epoch rebuilds the list each epoch)."""
        key = (tuple(id(r) for r in records), self.tc.max_len)
        if self._data[0] != key:
            self._data = (None, None)   # hold at most one dataset
            self._data = (key, prepad_records(records, self.tc.max_len,
                                              self.device))
        return self._data[1]

    def run_epoch(self, visual_records: List[Dict], text_records: List[Dict],
                  log=print) -> Dict[str, float]:
        ratio = curriculum_visual_ratio(self.epoch, self.tc.num_epochs)
        rng = np.random.default_rng(self.epoch)
        n = max(len(visual_records) + len(text_records), 1)
        n_vis = int(round(ratio * min(len(visual_records), n)))
        pool = (list(rng.choice(len(visual_records), n_vis, replace=False))
                if n_vis else [])
        records = [visual_records[i] for i in pool] + text_records
        metrics_acc: Dict[str, float] = {}
        count = 0
        t0 = time.time()
        for batch in batches_from_records(self._prepadded(records),
                                          self.tc.batch_size, rng):
            if self.mesh is not None:
                batch = data_rows(batch, self.mesh)
            metrics = train_step(self.params, self.opt, self.dcfg,
                                 self.tc.train, self.head_w, batch, self.rng,
                                 self.cos_t, self.sin_t, self.zero)
            self.step_count += 1
            count += 1
            for k, v in metrics.items():
                metrics_acc[k] = metrics_acc.get(k, 0.0) + float(v)
            if count % self.tc.log_every == 0:
                log(f"epoch {self.epoch} step {count}: " + " ".join(
                    f"{k}={metrics_acc[k]/count:.4f}" for k in metrics_acc))
                if self.wandb:
                    self.wandb.log({f"train/{k}": float(v)
                                    for k, v in metrics.items()},
                                   step=self.step_count)
        out = {k: v / max(count, 1) for k, v in metrics_acc.items()}
        out["steps"] = count
        out["visual_ratio"] = ratio
        out["seconds"] = time.time() - t0
        if self.wandb:
            self.wandb.log({f"epoch/{k}": float(v) for k, v in out.items()},
                           step=self.step_count)
        self.epoch += 1
        return out

    def gathered_params(self) -> Dict:
        """A copy of the full fp32 tree (under a mesh every rank must call
        it: the shards are gathered over ``model``)."""
        if self.mesh is None:
            return tree_map(lambda t: t.detach().clone(), self.params)
        return gather_params(self.params, self.specs, self.mesh)

    def _state_file(self, path: str) -> str:
        return os.path.join(path, "state.pt" if self.mesh is None
                            else f"state_rank{self.mesh.rank}.pt")

    def save(self, tag: Optional[str] = None) -> str:
        """Write ``<ckpt_dir>/<tag or epoch_N>/``: ``state.pt`` (params and
        optimizer state) and ``trainer.json`` (epoch, step_count). Under a
        mesh each rank writes its own shard, ``state_rank<r>.pt`` (its
        megatron slices and its ZeRO-1 optimizer state), and rank 0 the
        json; ``restore`` on the same mesh reads them back."""
        path = os.path.abspath(os.path.join(
            self.tc.ckpt_dir, tag or f"epoch_{self.epoch}"))
        os.makedirs(path, exist_ok=True)
        params = {k: v for k, v in self.params.items() if k != "mesh"}
        torch.save({"params": tree_map(torch.Tensor.detach, params),
                    "opt_state": self.opt.state_dict()},
                   self._state_file(path))
        if self.mesh is None or self.mesh.rank == 0:
            with open(os.path.join(path, "trainer.json"), "w") as f:
                json.dump({"epoch": self.epoch,
                           "step_count": self.step_count}, f)
        if self.mesh is not None:
            barrier(self.mesh)
        return path

    def restore(self, path: str) -> None:
        """Load a ``save`` directory into this trainer, params in place."""
        state = torch.load(self._state_file(path), map_location=self.device,
                           weights_only=True)

        def load(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    if k != "mesh":
                        load(dst[k], src[k])
            else:
                with torch.no_grad():
                    dst.copy_(src)

        load(self.params, state["params"])
        if self.zero is not None:
            self.zero.scatter_params()
        self.opt.load_state_dict(state["opt_state"])
        with open(os.path.join(path, "trainer.json")) as f:
            meta = json.load(f)
        self.epoch = meta["epoch"]
        self.step_count = meta["step_count"]


def train_from_dirs(dcfg: DraftConfig, dparams: Dict, head_w: torch.Tensor,
                    visual_dir: str, text_dir: str,
                    tc: TrainerConfig = TrainerConfig(), log=print,
                    device=None) -> DraftTrainer:
    trainer = DraftTrainer(dcfg, dparams, head_w, tc, device)
    vis = _load_records(sorted(glob.glob(os.path.join(visual_dir, "*.npz"))))
    txt = _load_records(sorted(glob.glob(os.path.join(text_dir, "*.npz"))))
    for _ in range(tc.num_epochs):
        m = trainer.run_epoch(vis, txt, log=log)
        log(f"epoch {trainer.epoch - 1} done: {m}")
        trainer.save()
    return trainer
