"""Run persistence + experiment logging.

Analogs of lmms-eval/lmms_eval/loggers/evaluation_tracker.py (results/sample
persistence with timestamps) and wandb_logger.py (optional W&B run logging,
degrading to no-op when wandb is unavailable/offline).

The port's own copy of the JAX package's ``harness/loggers.py``.
"""

from __future__ import annotations

import datetime
import json
import os
from typing import Dict, Optional


class EvaluationTracker:
    def __init__(self, output_path: str = "logs",
                 timezone: Optional[str] = None):
        self.output_path = output_path
        now = datetime.datetime.now()
        if timezone:
            try:
                from zoneinfo import ZoneInfo
                now = datetime.datetime.now(ZoneInfo(timezone))
            except Exception:
                pass  # unknown tz: keep local time
        self.date_id = now.strftime("%Y%m%d_%H%M%S")

    def _dir(self, model_name: str) -> str:
        d = os.path.join(self.output_path,
                         model_name.replace("/", "__"))
        os.makedirs(d, exist_ok=True)
        return d

    def save_results_aggregated(self, results: Dict, model_name: str,
                                model_args: Optional[Dict] = None) -> str:
        d = self._dir(model_name)
        path = os.path.join(d, f"results_{self.date_id}.json")
        payload = {"model": model_name, "model_args": model_args or {},
                   "date": self.date_id, **results}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        return path

    def save_results_samples(self, task_name: str, samples, model_name: str
                             ) -> str:
        d = self._dir(model_name)
        path = os.path.join(d, f"samples_{task_name}_{self.date_id}.jsonl")
        with open(path, "w") as f:
            for s in samples:
                f.write(json.dumps(s, default=str) + "\n")
        return path


class WandbLogger:
    """No-op unless wandb is importable AND WANDB_MODE permits running."""

    def __init__(self, project: str = "msd-tpu", name: Optional[str] = None,
                 config: Optional[Dict] = None):
        self.run = None
        try:
            import wandb
            if os.environ.get("WANDB_MODE", "") != "disabled":
                self.run = wandb.init(project=project, name=name,
                                      config=config or {})
        except Exception:
            self.run = None

    def log(self, metrics: Dict, step: Optional[int] = None):
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_results(self, results: Dict):
        """Flatten {task: {metric: value}} into task/metric keys (the
        reference wandb_logger.py log_eval_result analog)."""
        flat = {}
        for task, metrics in (results or {}).items():
            if isinstance(metrics, dict):
                for k, v in metrics.items():
                    if isinstance(v, (int, float)):
                        flat[f"{task}/{k}"] = v
        self.log(flat)

    def log_samples(self, task_name: str, samples):
        """Per-sample table (wandb_logger.py log_eval_samples analog)."""
        if self.run is None:
            return
        try:
            import wandb
            cols = ["doc_id", "response", "scores"]
            table = wandb.Table(columns=cols)
            for s in samples:
                table.add_data(s.get("doc_id"), str(s.get("response")),
                               json.dumps(s.get("scores"), default=str))
            self.run.log({f"{task_name}_samples": table})
        except Exception:
            pass

    def finish(self):
        if self.run is not None:
            self.run.finish()
