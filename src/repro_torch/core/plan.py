"""Merge plans — first-class, inspectable, reusable execution objects (§4).

Definition 4.1:  π = (op, θ, {B_i}_{i=1..K}, order)

A plan declaratively specifies which expert blocks are accessed, which
operator (with which parameters) combines them, and the deterministic
traversal order the engine must follow.  Plans are budget-feasible *by
construction* (Definition 4.2) and are persisted to the catalog so
iterative merges can reuse them without re-planning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import uuid
from typing import Any, Dict, List, Optional, Sequence

# selection: expert_id -> tensor_id -> sorted list of block_idx
Selection = Dict[str, Dict[str, List[int]]]


@dataclasses.dataclass
class MergePlan:
    plan_id: str
    base_id: str
    expert_ids: List[str]
    op: str
    theta: Dict[str, Any]
    budget_b: int
    block_size: int
    selection: Selection
    tensor_order: List[str]
    c_expert_hat: int
    granularity: str = "block"  # "block" | "tensor" (fallback §4.5)
    fallback_events: List[Dict] = dataclasses.field(default_factory=list)
    decisions: List[Dict] = dataclasses.field(default_factory=list)
    #: API v2 provenance: declarative spec this plan was compiled from, and
    #: input snapshots that are themselves merge outputs (merge-graph edges).
    spec_id: Optional[str] = None
    parent_sids: List[str] = dataclasses.field(default_factory=list)
    #: packed physical layout this plan was costed against (store/packed).
    #: When set, ``c_expert_hat`` is the *physical* planned cost — post
    #: dedup/elision/compression, what the budget B actually constrains —
    #: and ``c_expert_logical_hat`` keeps the logical selected-block bytes
    #: (what a flat store would move for the same selection).
    layout_id: Optional[str] = None
    c_expert_logical_hat: int = -1  # -1 => same as c_expert_hat (flat plan)

    # ------------------------------------------------------------- queries
    def blocks_for(self, expert_id: str, tensor_id: str) -> List[int]:
        return self.selection.get(expert_id, {}).get(tensor_id, [])

    def experts_for_block(self, tensor_id: str, block_idx: int) -> List[str]:
        """Sel_π(t, b) — experts contributing to output block (t, b) (§5.1)."""
        out = []
        for e in self.expert_ids:
            sel = self.selection.get(e, {}).get(tensor_id)
            if sel and block_idx in sel:
                out.append(e)
        return out

    def reverse_index(self, tensor_id: str) -> Dict[int, List[str]]:
        """block_idx -> [expert_id] for one tensor (executor hot path)."""
        rev: Dict[int, List[str]] = {}
        for e in self.expert_ids:
            for b in self.selection.get(e, {}).get(tensor_id, []):
                rev.setdefault(b, []).append(e)
        return rev

    def total_selected_blocks(self) -> int:
        return sum(
            len(bs) for per_t in self.selection.values() for bs in per_t.values()
        )

    @property
    def logical_hat(self) -> int:
        """Logical selected expert bytes (== physical on a flat store)."""
        return (
            self.c_expert_logical_hat
            if self.c_expert_logical_hat >= 0
            else self.c_expert_hat
        )

    # -------------------------------------------------------- serialization
    def digest(self) -> str:
        doc = {
            "base": self.base_id,
            "experts": self.expert_ids,
            "op": self.op,
            "theta": self.theta,
            "budget": self.budget_b,
            "block_size": self.block_size,
            "selection": self.selection,
            "order": self.tensor_order,
        }
        if self.layout_id is not None:
            # layout changes the cost model (and hence selection); keep
            # flat-plan digests byte-stable by adding the key only here
            doc["layout"] = self.layout_id
        canon = json.dumps(doc, sort_keys=True)
        return hashlib.blake2b(canon.encode(), digest_size=16).hexdigest()

    def to_payload(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_payload(payload: Dict) -> "MergePlan":
        return MergePlan(**payload)

    @staticmethod
    def new_id() -> str:
        return "plan-" + uuid.uuid4().hex[:12]
