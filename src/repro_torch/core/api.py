"""MergePipe — the port's one-shot facade over one workspace.

ANALYZE -> budgeted PLAN -> EXECUTE -> atomic publish, with the operator
applied on ``device``: by default the CUDA card, through the Hopper
kernels (``compute="pipelined"``, ``kernel="torch"``).  ``device="cpu"``
runs the same path with the kernels' plain PyTorch versions; asking for
``"cuda"`` where there is no card raises.  ``compute="stream"`` (or a
pipeline with ``kernel="numpy"``) is the bit-exact numpy host reference.

The workspace format — models, catalog, snapshots, journals — is the JAX
package's: a workspace written by either opens in the other.  As in the
JAX package, :meth:`MergePipe.merge` is a thin shim over the v2 layer:
it builds a :class:`~repro_torch.api.MergeSpec` and runs it through a
:class:`~repro_torch.api.Session` sharing this facade's workspace,
stats and device (the reference also warns that the facade is
deprecated; the port keeps it as its plain one-shot entry point).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence, Union

import numpy as np

from repro_torch.api.budget import BudgetSpec
from repro_torch.core import blocks as blk
from repro_torch.core import cost as cost_model
from repro_torch.core.catalog import Catalog
from repro_torch.core.executor import MergeResult, PipelineConfig, execute_merge
from repro_torch.core.lineage import explain as _explain
from repro_torch.core.lineage import lineage_chain, verify_snapshot
from repro_torch.core.plan import MergePlan
from repro_torch.core.planner import PlannerResult, plan_merge
from repro_torch.core.sketch import analyze_model
from repro_torch.core.transactions import TransactionManager
from repro_torch.store.iostats import IOStats
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.store.tensorstore import load_model_arrays


class MergePipe:
    def __init__(
        self,
        workspace: str,
        block_size: int = blk.DEFAULT_BLOCK_SIZE,
        stats: Optional[IOStats] = None,
        recover: bool = True,
        device: str = "cuda",
    ):
        from repro_torch.kernels.ops import resolve_device  # lazy: torch

        self.device = resolve_device(device)
        self.workspace = workspace
        self.block_size = block_size
        self.stats = stats if stats is not None else IOStats()
        os.makedirs(workspace, exist_ok=True)
        self.snapshots = SnapshotStore(workspace, self.stats)
        self.catalog = Catalog(os.path.join(workspace, "catalog.sqlite"), self.stats)
        self.snapshots.models.add_delete_guard(self.catalog.model_references)
        self.txn = TransactionManager(self.snapshots, self.catalog)
        if recover:
            self.txn.recover()

    # ------------------------------------------------------------ ingestion
    def register_model(
        self,
        model_id: str,
        arrays: Mapping[str, Any],
        kind: str = "full",
        scale: float = 1.0,
        analyze: bool = False,
        base_id: Optional[str] = None,
    ) -> str:
        """Store a checkpoint: numpy arrays (bf16 as uint16 words) or
        torch tensors on any device."""
        meta: Dict[str, Any] = {"kind": kind}
        if kind == "adapter":
            meta["scale"] = scale
        self.snapshots.models.write_model(model_id, arrays, meta=meta)
        if analyze:
            self.analyze(model_id, base_id=base_id)
        return model_id

    # -------------------------------------------------------------- ANALYZE
    def analyze(
        self, model_id: str, base_id: Optional[str] = None, force: bool = False
    ) -> Dict:
        return analyze_model(
            self.catalog,
            self.snapshots.models,
            model_id,
            self.block_size,
            base_id=base_id,
            force=force,
            device=self.device,
        )

    def ensure_analyzed(self, base_id: str, expert_ids: Sequence[str]) -> None:
        self.analyze(base_id)
        for e in expert_ids:
            self.analyze(e, base_id=base_id)

    # ----------------------------------------------------------------- PLAN
    def resolve_budget(
        self, expert_ids: Sequence[str], budget: Union[None, int, float, str]
    ) -> Optional[int]:
        """Resolve a legacy (or typed) budget to a concrete byte cap."""
        spec = BudgetSpec.from_legacy(budget)
        naive = None
        if spec.kind == "fraction":
            naive = cost_model.naive_expert_cost(self.catalog, expert_ids)
        return spec.resolve(naive)

    def plan(
        self,
        base_id: str,
        expert_ids: Sequence[str],
        op: str,
        theta: Optional[Dict] = None,
        budget: Union[None, int, float, str] = None,
        conflict_aware: bool = True,
        reuse: bool = True,
    ) -> PlannerResult:
        budget_b = self.resolve_budget(expert_ids, budget)
        return plan_merge(
            self.catalog,
            base_id,
            expert_ids,
            op,
            theta=theta,
            budget_b=budget_b,
            block_size=self.block_size,
            conflict_aware=conflict_aware,
            reuse=reuse,
        )

    def estimate(
        self,
        base_id: str,
        expert_ids: Sequence[str],
        plan: Optional[MergePlan] = None,
    ) -> cost_model.CostEstimate:
        return cost_model.estimate(
            self.catalog,
            base_id,
            expert_ids,
            c_expert_hat=plan.c_expert_hat if plan else None,
        )

    # ---------------------------------------------------------------- MERGE
    def merge(
        self,
        base_id: str,
        expert_ids: Sequence[str],
        op: str,
        theta: Optional[Dict] = None,
        budget: Union[None, int, float, str] = None,
        sid: Optional[str] = None,
        compute: str = "pipelined",
        coalesce: bool = True,
        analyze: bool = True,
        conflict_aware: bool = True,
        reuse_plan: bool = True,
        pipeline: Optional[PipelineConfig] = None,
        prefer_packed: Union[bool, str] = True,
    ) -> MergeResult:
        """ANALYZE (cached) -> PLAN -> EXECUTE -> COMMIT, through a v2
        :class:`~repro_torch.api.Session` on this workspace."""
        from repro_torch.api.spec import MergeSpec, OperatorSpec

        spec = MergeSpec(
            base=base_id,
            experts=list(expert_ids),
            operator=OperatorSpec(op, dict(theta or {}), strict=False),
            budget=BudgetSpec.from_legacy(budget),
            conflict_aware=conflict_aware,
            reuse_plan=reuse_plan,
        )
        return self.session().run(
            spec, sid=sid, compute=compute, coalesce=coalesce,
            analyze=analyze, pipeline=pipeline, prefer_packed=prefer_packed,
        )

    def session(self):
        """A v2 :class:`~repro_torch.api.Session` sharing this facade's
        catalog, snapshot store, transaction manager, stats and device."""
        from repro_torch.api.session import Session

        return Session._from_parts(
            self.snapshots, self.catalog, self.txn, self.block_size,
            self.stats, device=self.device,
        )

    def execute(
        self,
        plan: MergePlan,
        sid: Optional[str] = None,
        compute: str = "pipelined",
        coalesce: bool = True,
        pipeline: Optional[PipelineConfig] = None,
        **kwargs,
    ) -> MergeResult:
        """Run ``plan`` on this MergePipe's device (extra keyword
        arguments go to :func:`~repro_torch.core.executor.execute_merge`,
        e.g. ``cancel``/``progress``/``resume``)."""
        return execute_merge(
            plan, self.snapshots, self.catalog, sid=sid, txn=self.txn,
            compute=compute, coalesce=coalesce, pipeline=pipeline,
            device=self.device, **kwargs,
        )

    # ---------------------------------------------------------------- audit
    def explain(self, sid: str) -> Dict:
        return _explain(self.catalog, self.snapshots, sid)

    def lineage(self, sid: str):
        return lineage_chain(self.catalog, sid)

    def verify(self, sid: str) -> bool:
        return verify_snapshot(self.snapshots, sid)

    # ----------------------------------------------------------------- data
    def load(self, model_id: str) -> Dict[str, np.ndarray]:
        return load_model_arrays(self.snapshots.models, model_id)

    def list_snapshots(self):
        return self.snapshots.list_snapshots()

    def close(self) -> None:
        self.catalog.close()
