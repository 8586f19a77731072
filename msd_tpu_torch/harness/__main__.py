"""CLI entry point: ``python -m msd_tpu_torch.harness`` — mirrors the
reference's ``python -m lmms_eval`` flag surface
(lmms-eval/lmms_eval/__main__.py:85-300),
including the MSD additions: --msd_model_path, --use_msd, --use_calibration,
--train_ratio, --bottom.

The port of the JAX package's ``harness/__main__.py``, with the same flags
except:
- ``--device`` is the torch device the model runs on (default ``cuda``;
  ``cpu`` off the card), passed to the adapter as a model arg;
- ``--seed`` seeds ``random``, ``numpy`` and ``torch``.
``--config``, ``--include_path`` and ``$MSD_TPU_TASKS`` read YAML with
PyYAML, imported only then.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_model_args(s: str):
    out = {}
    if not s:
        return out
    for kv in s.split(","):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _parse_limit(v: str):
    f = float(v)
    return int(f) if f >= 1 or f <= 0 else f


def main(argv=None):
    ap = argparse.ArgumentParser("msd_tpu_torch.harness")
    ap.add_argument("--model", default="llava_msd_calibrated")
    ap.add_argument("--model_args", default="",
                    help="k=v,... incl. pretrained=<ckpt dir>")
    ap.add_argument("--tasks", required=True, help="comma-separated")
    # int = doc count; float in (0,1) = fraction of the task's docs
    # (lmms-eval/__main__.py:150-153)
    ap.add_argument("--limit", type=_parse_limit, default=None)
    ap.add_argument("--bottom", type=int, default=None,
                    help="evaluate only the LAST N docs")
    ap.add_argument("--msd_model_path", default=None)
    # store_true with default False — exact lmms_eval __main__.py:109-113
    # semantics: MSD is opt-in via the flag (the llava_msd adapters default
    # use_msd=True when constructed directly in python)
    ap.add_argument("--use_msd", action="store_true", default=False,
                    help="If True, use msd for inference")
    ap.add_argument("--no_msd", dest="use_msd", action="store_false",
                    help="(kept for round-1 compat; off is the default)")
    ap.add_argument("--use_calibration", action="store_true")
    ap.add_argument("--train_ratio", type=float, default=0.2)
    ap.add_argument("--use_cache", "-c", default=None, metavar="DIR",
                    help="path to a sqlite db file caching model responses "
                         "(lmms-eval/__main__.py:170-176); None = no cache")
    ap.add_argument("--cache_requests", default=None,
                    choices=["true", "refresh", "delete"],
                    help="cache the building of dataset requests "
                         "(lmms-eval/__main__.py:177-183)")
    ap.add_argument("--config", default=None,
                    help="YAML file with one run config or a LIST of run "
                         "configs; each entry overrides the CLI args and "
                         "runs sequentially (lmms-eval/__main__.py:344-358)")
    ap.add_argument("--output_path", default=None)
    ap.add_argument("--log_samples", action="store_true")
    ap.add_argument("--log_dir", default=None,
                    help="adapter run-output dir (acceptance JSON, "
                         "calibration stats, reliability SVG)")
    # ----- reference long-tail flags (lmms-eval/__main__.py:85-300) -----
    ap.add_argument("--num_fewshot", type=int, default=None,
                    help="number of deterministic fewshot examples "
                         "prepended to each prompt (:98-102)")
    ap.add_argument("--batch_size", "-b", default=1,
                    help="MSD decoding is single-sequence; like the "
                         "reference llava_msd adapter, only 1 is accepted "
                         "(:121-127; llava_msd.py batch_size_per_gpu==1)")
    ap.add_argument("--max_batch_size", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model, e.g. 'cuda' or 'cpu' "
                         "(:137-141): bf16 weights on a CUDA device, fp32 "
                         "elsewhere")
    ap.add_argument("--gen_kwargs", default="",
                    help="k=v,... generation overrides applied to every "
                         "task, e.g. max_new_tokens=64,temperature=0 "
                         "(:245-249)")
    ap.add_argument("--system_instruction", default=None,
                    help="system text prepended to every prompt (:215-219)")
    ap.add_argument("--apply_chat_template", nargs="?", const=True,
                    default=False,
                    help="accepted for parity (:221-225): prompts always "
                         "run through the adapter's conversation template "
                         "(vicuna_v1/qwen), the rebuild's chat template")
    ap.add_argument("--fewshot_as_multiturn", action="store_true",
                    help="render fewshot examples as chat turns (:227-231); "
                         "requires --apply_chat_template and fewshot > 0")
    ap.add_argument("--check_integrity", action="store_true",
                    help="self-test each task before running (:185-188)")
    ap.add_argument("--write_out", "-w", action="store_true",
                    help="print the first built prompt per task (:190-195)")
    ap.add_argument("--predict_only", "-x", action="store_true",
                    help="log responses, skip metrics (:272-278; implies "
                         "--log_samples)")
    ap.add_argument("--show_config", action="store_true",
                    help="print the resolved run config (:233-237)")
    ap.add_argument("--include_path", default=None,
                    help="comma-separated dirs of task YAMLs to register "
                         "in addition to the builtins (:239-243)")
    ap.add_argument("--verbosity", "-v", default=None,
                    help="logging level: DEBUG|INFO|WARNING|ERROR "
                         "(:250-254)")
    ap.add_argument("--judge", default="offline",
                    help="judge backend for GPT-scored tasks (mathvista "
                         "extraction, mmvet grading, llava-bench pairwise "
                         "review): 'offline' (deterministic rule analogs) "
                         "or 'endpoint:URL' (local OpenAI-style chat "
                         "endpoint; reference-parity prompts, "
                         "msd_tpu_torch/harness/judge.py)")
    ap.add_argument("--seed", default="0,1234,1234",
                    help="comma list: python,numpy,fewshot seeds; a single "
                         "int sets all (:280-293)")
    ap.add_argument("--timezone", default="Asia/Singapore",
                    help="timezone for output timestamps (:261-264)")
    ap.add_argument("--wandb_args", default="",
                    help="k=v,... passed to wandb.init; empty = no wandb "
                         "(:256-259)")
    ap.add_argument("--wandb_log_samples", action="store_true",
                    help="also log per-sample tables to wandb (:203-207)")
    ap.add_argument("--hf_hub_log_args", default="",
                    help="accepted for parity (:266-270); this environment "
                         "has no network egress, so hub pushes are skipped "
                         "with a warning")
    ap.add_argument("--trust_remote_code", action="store_true",
                    help="sets HF_DATASETS_TRUST_REMOTE_CODE (:295-300)")
    args = ap.parse_args(argv)

    from msd_tpu_torch.harness.judge import set_judge
    set_judge(args.judge)

    def validate(a):
        # reference validations (lmms-eval/__main__.py:425-437); applied
        # per run config so --config entries cannot bypass them
        if a.fewshot_as_multiturn and not a.apply_chat_template:
            ap.error("When `fewshot_as_multiturn` is selected, "
                     "`apply_chat_template` must be set.")
        if a.fewshot_as_multiturn and not (a.num_fewshot or 0) > 0:
            ap.error("If fewshot_as_multiturn is set, num_fewshot must be "
                     "greater than 0.")
        if str(a.batch_size) not in ("1", "auto"):
            ap.error("MSD decoding is single-sequence (bs=1), like the "
                     "reference's llava_msd adapters.")
        if a.predict_only:
            a.log_samples = True

    # --config sweep: expand into one args namespace per run config
    args_list = []
    if args.config:
        if not os.path.exists(args.config):
            raise ValueError(f"Config file does not exist: {args.config}")
        import yaml
        with open(args.config) as f:
            config_args = yaml.safe_load(f)
        if not isinstance(config_args, list):
            config_args = [config_args]
        for config in config_args:
            args_copy = argparse.Namespace(**vars(args))
            for key, value in config.items():
                setattr(args_copy, key, value)
            args_list.append(args_copy)
    else:
        args_list.append(args)
    for a in args_list:
        validate(a)

    payloads = [_run_one(a) for a in args_list]
    return payloads if args.config else payloads[0]


def _apply_run_env(args):
    """Process-level knobs: seeds (random, numpy, torch), verbosity, extra
    task dirs."""
    import logging
    import random

    import numpy as np

    if getattr(args, "verbosity", None):
        logging.basicConfig(
            level=getattr(logging, args.verbosity.upper(), logging.INFO))
    seeds = [s for s in str(getattr(args, "seed", "") or "").split(",") if s]
    if seeds:
        import torch

        if len(seeds) == 1:
            seeds = seeds * 3
        random.seed(int(seeds[0]))
        np.random.seed(int(seeds[1]) % (2 ** 32))
        torch.manual_seed(int(seeds[1]))
    if getattr(args, "trust_remote_code", False):
        os.environ["HF_DATASETS_TRUST_REMOTE_CODE"] = "1"
    if getattr(args, "hf_hub_log_args", ""):
        import sys
        print("WARNING: --hf_hub_log_args accepted but hub pushes are "
              "skipped (no network egress in this environment)",
              file=sys.stderr)
    if getattr(args, "include_path", None):
        from msd_tpu_torch.harness.tasks import register_builtin_tasks
        from msd_tpu_torch.harness.yaml_task import register_yaml_dir
        register_builtin_tasks()
        for d in args.include_path.split(","):
            if d:
                register_yaml_dir(d)


def _run_one(args):
    from msd_tpu_torch.harness.evaluator import simple_evaluate

    _apply_run_env(args)
    if args.show_config:
        import sys
        print(json.dumps({k: v for k, v in vars(args).items()},
                         indent=2, default=str), file=sys.stderr)
    margs = parse_model_args(args.model_args)
    margs.setdefault("device", args.device)
    if args.log_dir:
        margs.setdefault("log_dir", args.log_dir)
    out = simple_evaluate(
        model=args.model,
        model_args=margs,
        tasks=args.tasks.split(","),
        limit=args.limit, bottom=args.bottom,
        use_msd=args.use_msd, use_calibration=args.use_calibration,
        train_ratio=args.train_ratio,
        msd_model_path=args.msd_model_path,
        use_cache=args.use_cache, cache_requests=args.cache_requests,
        num_fewshot=args.num_fewshot or 0,
        system_instruction=args.system_instruction,
        gen_kwargs=parse_model_args(args.gen_kwargs) or None,
        predict_only=args.predict_only, write_out=args.write_out,
        do_check_integrity=args.check_integrity)

    payload = {"results": out["results"]}
    if "msd_stats" in out:
        payload["msd_stats"] = out["msd_stats"]
    if "synthetic_tasks" in out:
        payload["synthetic_tasks"] = out["synthetic_tasks"]
    # per-task comparability caveats (PARITY.md documented deviations):
    # reported numbers carry their own "not strictly comparable" marker
    devs = {t: v.get("scoring_deviation")
            for t, v in out["details"].items() if v.get("scoring_deviation")}
    if devs:
        payload["scoring_deviations"] = devs
    if args.log_samples:
        payload["details"] = {
            t: {"samples": v["samples"]} for t, v in out["details"].items()}
    text = json.dumps(payload, indent=2, default=str)
    print(text)
    if args.output_path:
        if args.output_path.endswith(".json"):
            with open(args.output_path, "w") as f:
                f.write(text)
        else:
            from msd_tpu_torch.harness.loggers import EvaluationTracker
            tracker = EvaluationTracker(args.output_path,
                                        timezone=args.timezone)
            tracker.save_results_aggregated(payload, args.model)
            if args.log_samples:
                for t, v in out["details"].items():
                    tracker.save_results_samples(t, v["samples"], args.model)
    if args.wandb_args:
        from msd_tpu_torch.harness.loggers import WandbLogger
        wb = WandbLogger(**parse_model_args(args.wandb_args))
        wb.log_results(payload["results"])
        if args.wandb_log_samples:
            for t, v in out["details"].items():
                wb.log_samples(t, v["samples"])
        wb.finish()
    return payload


if __name__ == "__main__":
    main()
