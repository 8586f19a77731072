"""Distill -> evaluate pipeline: one command from teacher states to a
per-task measured acceptance length (alpha). The port of the JAX
package's ``train/pipeline.py``.

The reference splits this across ge_data (ge_data_all_llava15.py), the
DeepSpeed trainer (main_deepspeed.py:447-484) and a separate lmms-eval run
whose evaluator attaches msd_stats (lmms-eval/lmms_eval/evaluator.py:
655-665). ``distill_and_eval`` chains the three against a live adapter:

  1. collect on-policy teacher records from the task's own docs (the
     target's greedy continuations: the MSD engine's own trajectory
     hiddens, or a teacher re-forward at the engine verify's program
     shape),
  2. train the draft head (``DraftTrainer``; W&B logging via
     ``TrainerConfig.wandb_project``),
  3. install the bf16 cast of the trained draft with
     ``MSDGenerator.set_draft`` (which releases the CUDA graphs captured
     over the old draft) and run the harness ``evaluate``, returning
     results with msd_stats (+ the acceptance JSON via the adapter's
     ``write_run_outputs`` when log_dir is set).

CLI: ``python -m msd_tpu_torch.train pipeline --basepath <ckpt>
--msd-model-path <draft> --tasks chartqa --limit 64`` (``--tiny`` for a
random tiny stack, ``--device cpu`` off the card).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def collect_onpolicy_records(lm, task, n_docs: int, max_new: int = 64,
                             pad_to: Optional[int] = None,
                             log=print, msd_trajectories: bool = True
                             ) -> List[Dict]:
    """Greedy target continuations on the task's docs -> trainer records.

    msd_trajectories=True records the MSD engine's own greedy path (the
    verify program's argmax trajectory, ``generate(collect_hiddens=True)``)
    so the distilled draft's later decode stays on-trajectory even where
    the AR program's argmax flips a bf16 near-tie; False re-forwards the
    AR continuation at the verify's program shape."""
    from msd_tpu_torch.train.data_gen import (make_record_from_ids,
                                              record_from_traj)

    gen = lm.gen
    tcfg = gen.tcfg
    docs = task.load_docs(limit=n_docs)
    recs = []
    emb_host = None
    for doc in docs[:n_docs]:
        ctx = task.doc_to_text(doc)
        visuals = task.doc_to_visual(doc)
        ids, feats = lm._prepare(ctx, visuals)
        n_img = gen.n_img if feats is not None else 0
        if msd_trajectories:
            r = gen.generate(ids, img_feats=feats, max_new_tokens=max_new,
                             collect_hiddens=True)
            e0 = len(ids) + max(n_img - 1, 0)
            pad = pad_to or ((r.traj_hidden.shape[0] + 127) // 128) * 128
            if emb_host is None:
                emb_host = gen.params["target"]["embed_tokens"].float() \
                    .cpu().numpy()
            recs.append(record_from_traj(
                r.traj_hidden, r.exp_ids, e0, gen._img_pos(ids), n_img,
                feats.float().cpu().numpy() if feats is not None else None,
                emb_host, pad))
            continue
        cont = gen.naive_generate(ids, img_feats=feats,
                                  max_new_tokens=max_new).tokens
        full = np.concatenate([ids, cont]).astype(np.int32)
        mask = np.zeros((len(full),), np.float32)
        mask[max(len(ids) - 1, 0):] = 1.0
        pad = pad_to or ((len(full) + 127) // 128) * 128
        recs.append(make_record_from_ids(
            gen.params["target"], tcfg, full, mask, pad_to=pad,
            img_feats=feats, n_img=n_img,
            verify_chunk=gen.eng.tree.num_nodes,
            cache_len=gen.eng.max_seq_len + gen.eng.tree.num_nodes))
    log(f"pipeline: {len(recs)} on-policy records from task {task.name}")
    return recs


def distill_and_eval(lm, tasks: List[str], *, distill_docs: int = 16,
                     distill_steps: int = 200, distill_max_new: int = 48,
                     limit: Optional[int] = None, lr: float = 1e-3,
                     batch_size: int = 2, wandb_project: Optional[str] = None,
                     noise_rel: float = 0.01, log=print) -> Dict:
    """Train the adapter's draft on its own target's trajectories, install
    it (``set_draft``), then evaluate; returns the harness results dict
    (msd_stats carries the measured per-run alpha)."""
    from msd_tpu_torch.harness.evaluator import evaluate
    from msd_tpu_torch.harness.registry import TASK_REGISTRY, get_task
    from msd_tpu_torch.harness.tasks import register_builtin_tasks
    from msd_tpu_torch.models.llama import _w
    from msd_tpu_torch.train.draft_train import TrainConfig
    from msd_tpu_torch.train.trainer import (DraftTrainer, TrainerConfig,
                                             tree_map)

    if not TASK_REGISTRY:
        register_builtin_tasks()

    recs = []
    for tname in tasks:
        recs += collect_onpolicy_records(lm, get_task(tname), distill_docs,
                                         max_new=distill_max_new, log=log)
    max_len = max(r["hidden"].shape[0] for r in recs)

    gen = lm.gen
    # a quantized target's head, dequantized (the trainer multiplies by it)
    head_w = _w(gen.params["target"], "lm_head")
    tc = TrainerConfig(
        train=TrainConfig(lr=lr, warmup_steps=min(20, distill_steps // 4),
                          total_steps=max(distill_steps, 8), noise_std=0.0,
                          noise_rel=noise_rel),
        batch_size=batch_size, max_len=max_len, num_epochs=1,
        log_every=max(distill_steps // 4, 1), wandb_project=wandb_project)
    trainer = DraftTrainer(gen.dcfg, dict(gen.params["draft"]), head_w, tc)
    last = {}
    while trainer.step_count < distill_steps:
        last = trainer.run_epoch([], recs, log=log)
    log(f"pipeline: distilled {trainer.step_count} steps "
        f"(top1_agree={last.get('top1_agree', 0):.3f})")

    # install the trained draft in the served dtype, keeping the frozen
    # shared embedding
    old = gen.params["draft"]
    dtype = old["embed_tokens"].dtype
    trained = {k: tree_map(lambda t: t.detach().to(dtype), v)
               for k, v in trainer.params.items() if k != "embed_tokens"}
    trained["embed_tokens"] = old["embed_tokens"]
    del trainer
    gen.set_draft(trained)

    # clean per-run alpha: drop any acceptance stats accumulated before
    lm.total_accept_len = 0
    lm.total_accept_steps = 0
    out = evaluate(lm, tasks, limit=limit)
    if getattr(lm, "log_dir", None):
        lm.write_run_outputs()
    return out


def main_pipeline(args):
    """``python -m msd_tpu_torch.train pipeline``: the adapter from a
    checkpoint (``LlavaMSD.from_pretrained``) or ``--tiny``, distilled and
    evaluated on ``args.device``. Prints the results and msd_stats;
    returns (adapter, results)."""
    import json

    from msd_tpu_torch.harness.models.llava_msd import LlavaMSD

    lm = (LlavaMSD.from_tiny(device=args.device, log_dir=args.log_dir)
          if args.tiny else
          LlavaMSD.from_pretrained(args.basepath, args.msd_model_path or
                                   args.basepath, device=args.device,
                                   log_dir=args.log_dir))
    out = distill_and_eval(
        lm, args.tasks.split(","), distill_docs=args.distill_docs,
        distill_steps=args.distill_steps, limit=args.limit,
        wandb_project=args.wandb_project)
    print(json.dumps({"results": out["results"],
                      "msd_stats": out.get("msd_stats", {})}, indent=2,
                     default=str))
    return lm, out
