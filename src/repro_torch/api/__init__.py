"""repro_torch.api — the declarative MergePipe API (v2), ported.

Public surface:

    BudgetSpec    typed expert-read budgets ("30%", "2GiB", bytes, ...)
    OperatorSpec  schema-validated operator + θ
    MergeSpec     composable merge-graph node (inputs may be MergeSpecs)
    MergeService  asynchronous, continuously-scheduling job service:
                  submit(spec, tenant=..., priority=..., deadline=...)
                  with admission control, weighted-fair budget
                  arbitration, and cancellation (docs/SERVICE.md)
    Session       workspace entry point; submit()/run_all() batches are
                  a compatibility wrapper over an embedded MergeService
    JobHandle     future-style handle: wait()/status/progress()/cancel()
    JobState / JobCancelled / AdmissionRejected / DeadlineExceeded
                  job lifecycle vocabulary
    load_spec_file  parse a JSON spec document into MergeSpecs

``Session`` and ``MergeService`` take a ``device``: the CUDA card by
default, ``"cpu"`` for the kernels' plain versions.  The same spec gives
the same ``spec_id`` here and in the JAX package.
"""
from __future__ import annotations

import json
from typing import List

from repro_torch.api.budget import BudgetSpec
from repro_torch.api.jobs import (
    AdmissionRejected,
    DeadlineExceeded,
    JobCancelled,
    JobHandle,
    JobState,
)
from repro_torch.api.service import BudgetArbiter, MergeService
from repro_torch.api.session import Session
from repro_torch.api.spec import MergeSpec, OperatorSpec

__all__ = [
    "BudgetSpec",
    "OperatorSpec",
    "MergeSpec",
    "MergeService",
    "BudgetArbiter",
    "Session",
    "JobHandle",
    "JobState",
    "JobCancelled",
    "AdmissionRejected",
    "DeadlineExceeded",
    "load_spec_file",
]


def load_spec_file(path: str) -> List[MergeSpec]:
    """Load one or many MergeSpecs from a JSON document.

    Accepted shapes: a single spec mapping, a list of spec mappings, or
    ``{"jobs": [...]}``.  YAML documents (``.yaml``/``.yml``), which the
    JAX package reads through PyYAML, are refused: the port does not
    depend on PyYAML.
    """
    if path.endswith((".yaml", ".yml")):
        raise RuntimeError(
            f"{path}: YAML spec files are not supported here (no PyYAML "
            f"dependency); write the same document as JSON"
        )
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "jobs" in doc:
        doc = doc["jobs"]
    if isinstance(doc, dict):
        doc = [doc]
    if not isinstance(doc, list):
        raise ValueError(f"spec document {path} must be a mapping or list")
    return [MergeSpec.from_dict(d) for d in doc]
