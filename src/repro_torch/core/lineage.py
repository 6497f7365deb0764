"""Lineage & explainability — audit queries over committed snapshots (§2.2).

Every committed merge leaves four durable artifacts: the snapshot manifest
(file + catalog row), the plan, the touch map, and per-block expert
coverage.  ``explain(sid)`` joins them into one audit record answering:
which inputs, which operator/θ, which budget, which blocks were touched,
which experts contributed where, and whether the realized expert I/O
respected the plan.  ``verify_snapshot`` re-hashes published bytes.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional

from repro_torch.core.catalog import Catalog
from repro_torch.store.snapshot import SnapshotStore


def _logical_hat(plan: Optional[Dict]) -> Optional[int]:
    if plan is None:
        return None
    logical = plan.get("payload", {}).get("c_expert_logical_hat", -1)
    return logical if logical is not None and logical >= 0 else plan.get("c_expert_hat")


def explain(catalog: Catalog, snapshots: SnapshotStore, sid: str) -> Dict:
    man = catalog.get_manifest(sid)
    if man is None:
        raise KeyError(f"snapshot {sid!r} not committed")
    plan = catalog.get_plan(man["plan_id"])
    touch = catalog.touch_map(sid)
    coverage = catalog.coverage(sid)

    per_expert_blocks: Dict[str, int] = {}
    for _t, _b, eset in coverage:
        for e in eset.split(","):
            per_expert_blocks[e] = per_expert_blocks.get(e, 0) + 1

    touched_blocks = sum(e - s for ranges in touch.values() for s, e in ranges)
    file_manifest = snapshots.manifest(sid)

    # API v2 merge-graph provenance: DAG edges to inputs that are
    # themselves merge snapshots, and the declarative spec (if any).
    parents = [
        {"sid": p, "role": role} for p, role in catalog.dag_parents(sid)
    ]
    spec_id = (plan or {}).get("payload", {}).get("spec_id")
    spec = catalog.get_spec(spec_id) if spec_id else None
    # MergeService provenance: which job committed this snapshot, under
    # which tenancy/priority, what admission control decided, and which
    # scheduling window ran it (None for pre-service merges).
    job = catalog.job_for_sid(sid)
    job_record = None
    if job is not None:
        job_record = {
            "job_id": job["job_id"],
            "tenant": job["tenant"],
            "priority": job["priority"],
            "deadline": job["deadline"],
            "state": job["state"],
            "admission": job["admission"],
            "window_id": job["window_id"],
            "submitted_at": job["submitted_at"],
            "finished_at": job["finished_at"],
        }
    return {
        "sid": sid,
        "base_id": man["base_id"],
        "expert_ids": man["expert_ids"],
        "op": man["op"],
        "theta": (plan or {}).get("payload", {}).get("theta"),
        "budget_b": man["budget_b"],
        "c_expert_hat": (plan or {}).get("c_expert_hat"),
        # packed physical layout provenance: c_expert_hat is *physical*
        # (post-dedup/elision/compression) when layout_id is set, and
        # c_expert_logical_hat is what a flat store would have moved for
        # the same selection (they coincide on flat plans)
        "layout_id": (plan or {}).get("payload", {}).get("layout_id"),
        "c_expert_logical_hat": _logical_hat(plan),
        "c_expert_run": man["c_expert_run"],
        "budget_respected": (
            man["budget_b"] < 0 or man["c_expert_run"] <= man["budget_b"]
        ),
        "touched_blocks": touched_blocks,
        "touched_tensors": len([t for t, r in touch.items() if r]),
        "per_expert_touched_blocks": per_expert_blocks,
        "plan_id": man["plan_id"],
        "plan_digest": file_manifest.get("plan_digest"),
        "fallback_events": (plan or {}).get("payload", {}).get("fallback_events"),
        "decisions": (plan or {}).get("payload", {}).get("decisions"),
        "parents": parents,
        "spec_id": spec_id,
        "spec": (spec or {}).get("payload") if spec else None,
        "job": job_record,
        "output_root": man["output_root"],
        "created_at": man["created_at"],
    }


def lineage_chain(catalog: Catalog, sid: str) -> List[Dict]:
    """Walk base ancestry: merged snapshots used as bases of later merges
    form a chain; returns [newest .. oldest]."""
    chain: List[Dict] = []
    cur: Optional[str] = sid
    seen = set()
    while cur is not None and cur not in seen:
        seen.add(cur)
        man = catalog.get_manifest(cur)
        if man is None:
            break
        chain.append(man)
        cur = man["base_id"]
    return chain


def merge_graph(catalog: Catalog, sid: str) -> Dict:
    """Recursively expand the merge DAG rooted at ``sid``.

    Returns a nested record ``{sid, op, base_id, expert_ids, parents: [...]}``
    where ``parents`` recurses into inputs that were produced by merges in
    the same graph (dag_edge rows).  Plain model inputs terminate the
    recursion.
    """
    man = catalog.get_manifest(sid)
    if man is None:
        raise KeyError(f"snapshot {sid!r} not committed")
    node = {
        "sid": sid,
        "op": man["op"],
        "base_id": man["base_id"],
        "expert_ids": man["expert_ids"],
        "parents": [],
    }
    for parent_sid, role in catalog.dag_parents(sid):
        child = merge_graph(catalog, parent_sid)
        child["role"] = role
        node["parents"].append(child)
    return node


def verify_snapshot(snapshots: SnapshotStore, sid: str) -> bool:
    """Re-hash published tensor files against MODEL.json (auditability)."""
    man = snapshots.manifest(sid)
    root = man["output_root"]
    import json

    with open(os.path.join(root, "MODEL.json"), "rb") as f:
        doc = json.loads(f.read())
    for tensor_id, spec in doc["tensors"].items():
        h = hashlib.blake2b(digest_size=16)
        with open(os.path.join(root, spec["file"]), "rb") as f:
            while True:
                chunk = f.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
        if h.hexdigest() != spec["hash"]:
            return False
    return True
