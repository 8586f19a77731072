"""Evaluation orchestration (mirror of lmms-eval/lmms_eval/evaluator.py).

simple_evaluate resolves the model adapter + tasks, builds requests (with
rank/world_size sharding and the ``bottom`` tail-slice), dispatches
``generate_until``, applies per-doc metrics, aggregates, and attaches
``msd_stats = {avg_accept_len, accept_steps, accept_len}``
(evaluator.py:655-665).

Multi-process: each process evaluates its rank's shard; metric lists are
all-gathered with ``torch.distributed`` when the world has more than one
process (evaluator.py:566-597 gathers with gather_object).

The port of the JAX package's ``harness/evaluator.py``. Its models are the
port's LLaVA adapters (``harness/models/llava_msd.py``); the Qwen adapter
comes with the Qwen models.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from msd_tpu_torch.harness.registry import TASK_REGISTRY, get_model, get_task
from msd_tpu_torch.harness.tasks import register_builtin_tasks


def evaluate(lm, task_names: List[str], *, limit: Optional[int] = None,
             bottom: Optional[int] = None, rank: int = 0,
             world_size: int = 1,
             cache_requests: Optional[str] = None,
             request_cache_dir: Optional[str] = None,
             num_fewshot: int = 0,
             system_instruction: Optional[str] = None,
             gen_kwargs: Optional[Dict] = None,
             predict_only: bool = False,
             write_out: bool = False) -> Dict:
    results: Dict[str, Dict] = {}
    for tname in task_names:
        task = get_task(tname)
        docs = _load_docs_cached(task, tname,
                                 limit=None if bottom else limit,
                                 cache_requests=cache_requests,
                                 cache_dir=request_cache_dir)
        # load_docs already applied `limit` (unless bottom) — re-applying a
        # FRACTIONAL limit in doc_iterator would square it (f -> f^2 docs)
        reqs = task.build_requests(docs, rank=rank, world_size=world_size,
                                   limit=None, bottom=bottom,
                                   num_fewshot=num_fewshot,
                                   system_instruction=system_instruction,
                                   gen_kwargs_override=gen_kwargs)
        if write_out and reqs:
            # print the first built prompt per task for inspection
            # (lmms-eval/__main__.py:190-195 / utils.py run_task_tests analog)
            import sys
            print(f"[write_out] task={tname} doc_id={reqs[0].doc_id} "
                  f"prompt:\n{reqs[0].arguments[0]}", file=sys.stderr)
        rtype = reqs[0].request_type if reqs else "generate_until"
        t0 = time.time()
        resps = getattr(lm, rtype)(reqs)
        duration = time.time() - t0
        # group responses per doc in request order (loglikelihood tasks emit
        # one request per choice; process_results sees the full list)
        doc_order: List[int] = []
        by_doc: Dict[int, Dict] = {}
        for r, resp in zip(reqs, resps):
            if r.doc_id not in by_doc:
                by_doc[r.doc_id] = {"doc": r.doc, "resps": []}
                doc_order.append(r.doc_id)
            by_doc[r.doc_id]["resps"].append(resp)
        if predict_only:
            # log responses, skip metrics entirely
            # (lmms-eval/__main__.py:272-278: predict_only implies
            # log_samples and no metric computation)
            per_doc = [{} for _ in doc_order]
            agg = {}
        else:
            per_doc = [task.process_results(by_doc[d]["doc"],
                                            by_doc[d]["resps"])
                       for d in doc_order]
            per_doc = _gather_metrics(per_doc, world_size)
            agg = task.aggregate(per_doc)
        results[tname] = {
            "metrics": agg,
            "n_docs": len(per_doc),
            "synthetic_docs": bool(getattr(task, "used_synthetic_docs",
                                           False)),
            # per-task comparability caveat (PARITY.md deviations)
            "scoring_deviation": getattr(task, "scoring_deviation", None),
            "duration_seconds": duration,
            "samples": [
                {"doc_id": d,
                 "response": (by_doc[d]["resps"][0]
                              if len(by_doc[d]["resps"]) == 1
                              else by_doc[d]["resps"]),
                 "scores": s}
                for d, s in zip(doc_order, per_doc)],
        }
    out = {"results": {t: v["metrics"] for t, v in results.items()},
           "details": results}
    synth = [t for t, v in results.items() if v["synthetic_docs"]]
    if synth:  # loud top-level marker (VERDICT r1 weak #3)
        out["synthetic_tasks"] = synth
    if hasattr(lm, "msd_stats"):
        out["msd_stats"] = lm.msd_stats
    return out


def _load_docs_cached(task, tname: str, *, limit,
                      cache_requests: Optional[str],
                      cache_dir: Optional[str]) -> List[Dict]:
    """Doc-list (request-building) cache: the reference's ``cache_requests``
    surface (lmms-eval/__main__.py:177-183, evaluator.py:678-683 — "true"
    reads+writes, "refresh" rebuilds and overwrites, "delete" drops the
    cached entry then rebuilds)."""
    if not cache_requests:
        return task.load_docs(limit=limit)
    import pickle
    d = cache_dir or ".request_cache"
    import os
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"requests_{tname}_{limit}.pkl")
    if cache_requests == "delete" and os.path.exists(path):
        os.remove(path)
    if cache_requests == "true" and os.path.exists(path):
        with open(path, "rb") as f:
            payload = pickle.load(f)
        task.used_synthetic_docs = payload["synthetic"]
        return payload["docs"]
    docs = task.load_docs(limit=limit)
    if cache_requests in ("true", "refresh"):
        with open(path, "wb") as f:
            pickle.dump({"docs": docs,
                         "synthetic": bool(getattr(
                             task, "used_synthetic_docs", False))}, f)
    return docs


def _gather_metrics(per_doc: List[Dict], world_size: int) -> List[Dict]:
    if world_size <= 1:
        return per_doc
    import numpy as np
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() != world_size:
        raise RuntimeError(
            f"world_size={world_size} needs an initialized torch.distributed "
            "process group of that size")
    # only numeric metric values survive a multi-process gather; string
    # payloads (e.g. corpus-caption preds/refs) are process-local and
    # dropped here
    keys = sorted({k for d in per_doc for k, v in d.items()
                   if isinstance(v, (int, float))})
    arr = np.asarray([[d.get(k, np.nan) for k in keys] for d in per_doc],
                     dtype=np.float64).reshape(-1, len(keys))
    parts = [None] * world_size
    dist.all_gather_object(parts, arr)
    gathered = np.concatenate(parts).reshape(-1, len(keys))
    out = []
    for row in gathered:
        out.append({k: float(v) for k, v in zip(keys, row)
                    if not np.isnan(v)})
    return out


def check_integrity(task_names: List[str]) -> None:
    """Self-test each task before the run (the reference's --check_integrity
    -> run_task_tests, lmms-eval/__main__.py:185-188): docs load, the first
    doc renders through doc_to_text/doc_to_visual, and process_results
    accepts a dummy response."""
    for tname in task_names:
        task = get_task(tname)
        docs = task.load_docs(limit=1)
        if not docs:
            raise AssertionError(f"task {tname}: no docs")
        ctx = task.doc_to_text(docs[0])
        if not isinstance(ctx, str) or not ctx:
            raise AssertionError(f"task {tname}: doc_to_text returned "
                                 f"{ctx!r}")
        task.doc_to_visual(docs[0])
        if task.output_type == "generate_until":
            r = task.process_results(docs[0], ["dummy response"])
            if not isinstance(r, dict):
                raise AssertionError(
                    f"task {tname}: process_results returned {type(r)}")


def simple_evaluate(*, model, model_args: Optional[Dict] = None,
                    tasks: List[str], limit: Optional[int] = None,
                    bottom: Optional[int] = None, use_msd: bool = True,
                    use_calibration: bool = False, train_ratio: float = 0.2,
                    msd_model_path: Optional[str] = None,
                    rank: int = 0, world_size: int = 1,
                    use_cache: Optional[str] = None,
                    cache_requests: Optional[str] = None,
                    num_fewshot: int = 0,
                    system_instruction: Optional[str] = None,
                    gen_kwargs: Optional[Dict] = None,
                    predict_only: bool = False,
                    write_out: bool = False,
                    do_check_integrity: bool = False) -> Dict:
    if not TASK_REGISTRY:
        register_builtin_tasks()
    if do_check_integrity:
        check_integrity(tasks)
    # model classes register themselves at import time
    import msd_tpu_torch.harness.models.llava_msd  # noqa: F401
    import msd_tpu_torch.harness.models.qwen2_vl_msd  # noqa: F401
    if isinstance(model, str):
        cls = get_model(model)
        margs = dict(model_args or {})
        margs.setdefault("use_msd", use_msd)
        margs.setdefault("use_calibration", use_calibration)
        margs.setdefault("train_ratio", train_ratio)
        tiny = str(margs.pop("tiny", "")).lower() in ("1", "true", "yes")
        pretrained = margs.pop("pretrained", None)
        if tiny and not pretrained:
            lm = cls.from_tiny(**margs)
        elif pretrained:
            lm = cls.from_pretrained(pretrained, msd_model_path, **margs)
        else:
            raise ValueError(
                "model_args must include 'pretrained' (checkpoint dir), or "
                "pass a constructed adapter instance instead of a name")
    else:
        lm = model
    if use_cache:
        # sqlite response cache around ANY adapter (api/model.py:151-218;
        # CLI flag --use_cache, lmms-eval/__main__.py:170-176)
        from msd_tpu_torch.harness.cache import CachingLM
        tag = model if isinstance(model, str) else type(model).__name__
        lm = CachingLM(lm, use_cache, model_tag=tag)
    return evaluate(lm, tasks, limit=limit, bottom=bottom, rank=rank,
                    world_size=world_size, cache_requests=cache_requests,
                    request_cache_dir=(use_cache + ".requests"
                                       if use_cache else None),
                    num_fewshot=num_fewshot,
                    system_instruction=system_instruction,
                    gen_kwargs=gen_kwargs, predict_only=predict_only,
                    write_out=write_out)
