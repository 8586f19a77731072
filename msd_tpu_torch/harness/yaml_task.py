"""YAML task configs (the lmms-eval ConfigurableTask file format).

Mirrors the reference's task layer (lmms-eval/lmms_eval/api/task.py +
tasks/*/*.yaml): a task is one YAML file with ``!function module.fn`` hooks
resolved against a python file next to the YAML (the tasks/<name>/utils.py
convention) or any importable module path. Example (tasks/chartqa/
chartqa.yaml:1-30):

    task: "chartqa"
    dataset_path: /datasets/ChartQA
    test_split: test
    output_type: generate_until
    doc_to_visual: !function utils.chartqa_doc_to_visual
    doc_to_text: !function utils.chartqa_doc_to_text
    process_results: !function utils.chartqa_process_results
    generation_kwargs: {max_new_tokens: 128, temperature: 0}
    metric_list:
      - metric: relaxed_overall
        aggregation: mean

``load_yaml_task(path)`` returns a TaskConfig; ``register_yaml_dir(dir)``
registers every ``*.yaml`` beneath a directory.

The port's own copy of the JAX package's ``harness/yaml_task.py``. It reads
YAML with PyYAML, imported only when a YAML task is loaded (as the CLI's
``--config`` does), so the harness imports without it; a ``!function``
that names no file beside the YAML and no importable module resolves in
the port's ``msd_tpu_torch.harness.task_utils``.
"""

from __future__ import annotations

import importlib
import importlib.util
import inspect
import os
import sys
from typing import Callable, Dict, List, Optional

from msd_tpu_torch.harness.registry import register_task
from msd_tpu_torch.harness.tasks import TaskConfig


class _FunctionRef:
    """Deferred ``!function module.fn`` reference."""

    def __init__(self, spec: str):
        self.spec = spec

    def resolve(self, yaml_dir: str) -> Callable:
        mod_name, fn_name = self.spec.rsplit(".", 1)
        # 1) python file next to the YAML (lmms-eval's utils.py convention)
        local = os.path.join(yaml_dir, mod_name + ".py")
        if os.path.exists(local):
            key = f"_msd_yaml_task_{abs(hash(local))}"
            if key not in sys.modules:
                spec = importlib.util.spec_from_file_location(key, local)
                module = importlib.util.module_from_spec(spec)
                sys.modules[key] = module
                spec.loader.exec_module(module)
            return getattr(sys.modules[key], fn_name)
        # 2) importable module path (msd_tpu_torch.harness.task_utils.*)
        try:
            return getattr(importlib.import_module(mod_name), fn_name)
        except ImportError:
            return getattr(importlib.import_module(
                "msd_tpu_torch.harness.task_utils." + mod_name), fn_name)


def _yaml_loader():
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    Loader.add_constructor(
        "!function", lambda loader, node: _FunctionRef(
            loader.construct_scalar(node)))
    return Loader


def _wrap_doc_to_text(fn: Callable, specific_kwargs: Optional[Dict]):
    """lmms-eval doc_to_text hooks take (doc, lmms_eval_specific_kwargs);
    adapt to the TaskConfig's 1-arg signature, passing the YAML's 'default'
    model kwargs — and keep multi-round kwargs flowing through."""
    try:
        params = inspect.signature(fn).parameters
        wants_kwargs = "lmms_eval_specific_kwargs" in params
    except (TypeError, ValueError):
        wants_kwargs = False
    if not wants_kwargs:
        return fn

    def wrapped(doc, **kw):
        return fn(doc, lmms_eval_specific_kwargs=specific_kwargs, **kw)
    return wrapped


def load_yaml_task(path: str,
                   dataset_root: Optional[str] = None) -> TaskConfig:
    yaml_dir = os.path.dirname(os.path.abspath(path))
    import yaml

    with open(path) as f:
        cfg = yaml.load(f, Loader=_yaml_loader())

    def resolve(v):
        return v.resolve(yaml_dir) if isinstance(v, _FunctionRef) else v

    name = cfg.get("task") or os.path.splitext(os.path.basename(path))[0]
    dataset_path = cfg.get("dataset_path")
    if dataset_path and dataset_root and not os.path.isabs(dataset_path):
        dataset_path = os.path.join(dataset_root, dataset_path)

    specific = cfg.get("lmms_eval_specific_kwargs", {})
    specific = specific.get("default", specific) if isinstance(specific,
                                                               dict) else {}

    doc_to_text = _wrap_doc_to_text(resolve(cfg["doc_to_text"]), specific)
    doc_to_visual = resolve(cfg.get("doc_to_visual")) or (lambda d: [])

    gen_kwargs = dict(cfg.get("generation_kwargs",
                              {"max_new_tokens": 128, "temperature": 0.0}))
    gen_kwargs.pop("do_sample", None)  # torch-ism; temperature==0 is greedy

    metric_list = cfg.get("metric_list", [])
    metric_names = tuple(m["metric"] for m in metric_list) or ("accuracy",)

    process_results = resolve(cfg.get("process_results"))
    if process_results is None:
        # default: exact_match of the (string) doc_to_target field
        tgt = cfg.get("doc_to_target", "answer")

        def process_results(doc, results, _tgt=tgt):
            from msd_tpu_torch.harness import metrics as M
            gold = doc[_tgt] if isinstance(_tgt, str) else _tgt(doc)
            return {metric_names[0]: M.exact_match(results[0], gold)}

    doc_to_target = cfg.get("doc_to_target")
    doc_to_target = resolve(doc_to_target) if doc_to_target else None
    if isinstance(doc_to_target, str):
        field_name = doc_to_target
        doc_to_target = lambda d: str(d[field_name])  # noqa: E731

    return TaskConfig(
        name=name,
        doc_to_text=doc_to_text,
        doc_to_visual=doc_to_visual,
        process_results=process_results,
        dataset_path=dataset_path,
        split=cfg.get("test_split", "test"),
        gen_kwargs=gen_kwargs,
        metric_names=metric_names,
        output_type=cfg.get("output_type", "generate_until"),
        doc_to_target=doc_to_target,
        doc_to_choice=resolve(cfg.get("doc_to_choice"))
        if cfg.get("doc_to_choice") else None,
    )


def register_yaml_dir(directory: str,
                      dataset_root: Optional[str] = None) -> List[str]:
    """Register every *.yaml task beneath ``directory``; returns the names."""
    names = []
    for root, _, files in os.walk(directory):
        for fn in sorted(files):
            if fn.endswith((".yaml", ".yml")) and not fn.startswith("_"):
                task = load_yaml_task(os.path.join(root, fn), dataset_root)
                register_task(task.name, task)
                names.append(task.name)
    return names
