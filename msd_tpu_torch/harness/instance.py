"""Request instance (mirror of lmms-eval/lmms_eval/api/instance.py:5-29).

The port's own copy of the JAX package's ``harness/instance.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class Instance:
    request_type: str              # "generate_until" | "loglikelihood" |
    #                                "generate_until_multi_round"
    doc: Dict[str, Any]
    arguments: Tuple
    # generate_until:  (context, gen_kwargs, doc_to_visual, doc_id, task, split)
    # loglikelihood:   (context, doc_to_target, doc_to_visual, doc_id, task, split)
    # multi_round:     (context, gen_kwargs, doc_to_visual, doc_to_text,
    #                   doc_id, task, split)
    idx: int
    task_name: str
    doc_id: int
    resps: List[Any] = field(default_factory=list)
    filtered_resps: Optional[Any] = None
