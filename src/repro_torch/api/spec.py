"""MergeSpec — declarative, composable merge graphs (API v2).

An :class:`OperatorSpec` is a merge operator name plus a θ dict validated
against the operator registry's per-operator schema (unknown keys and
out-of-range values fail at *spec construction*, not mid-execution).

A :class:`MergeSpec` is one merge node: base, experts, operator, typed
budget.  Crucially, ``base`` and any expert may be **another MergeSpec**,
which makes specs first-class merge *graphs* — e.g. TIES over two DARE
sub-merges — planned and executed as a DAG with per-node lineage:

    sub = MergeSpec.build("base", ["e1", "e2"], op="dare",
                          theta={"density": 0.5, "seed": 1}, name="sub")
    top = MergeSpec.build("base", [sub, "e0"], op="ties",
                          theta={"trim_frac": 0.2}, budget="30%")

Specs serialize to plain JSON/YAML-able dicts (``to_dict``/``from_dict``)
so merge graphs can live in version control and be submitted via the
CLI.  ``spec_id`` is a content digest: structurally identical sub-graphs
dedupe to a single execution inside a batch session.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterator, List, Optional, Union

from repro_torch.api.budget import BudgetLike, BudgetSpec
from repro_torch.core import operators as ops

Input = Union[str, "MergeSpec"]


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """Validated merge operator reference: ``op`` + schema-checked θ."""

    op: str
    theta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    strict: bool = True

    def __post_init__(self):
        op = self.op.lower()
        object.__setattr__(self, "op", op)
        ops.get_operator(op)  # raises on unknown operator
        object.__setattr__(
            self, "theta", ops.validate_theta(op, self.theta, strict=self.strict)
        )

    def to_dict(self) -> Dict[str, Any]:
        return {"op": self.op, "theta": dict(self.theta)}

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "OperatorSpec":
        return cls(doc["op"], dict(doc.get("theta") or {}))


@dataclasses.dataclass
class MergeSpec:
    """One node of a declarative merge graph."""

    base: Input
    experts: List[Input]
    operator: OperatorSpec
    budget: BudgetSpec = dataclasses.field(default_factory=BudgetSpec.unbounded)
    name: Optional[str] = None
    conflict_aware: bool = True
    reuse_plan: bool = True

    def __post_init__(self):
        if not self.experts:
            raise ValueError("MergeSpec needs at least one expert input")
        for inp in [self.base, *self.experts]:
            if not isinstance(inp, (str, MergeSpec)):
                raise TypeError(
                    f"merge input must be a model id or MergeSpec, got "
                    f"{type(inp).__name__}"
                )

    # ------------------------------------------------------------- builders
    @classmethod
    def build(
        cls,
        base: Input,
        experts: List[Input],
        op: str = "ties",
        theta: Optional[Dict[str, Any]] = None,
        budget: BudgetLike = None,
        name: Optional[str] = None,
        conflict_aware: bool = True,
        reuse_plan: bool = True,
    ) -> "MergeSpec":
        """Convenience constructor with loose inputs (parses the budget)."""
        return cls(
            base=base,
            experts=list(experts),
            operator=OperatorSpec(op, dict(theta or {})),
            budget=BudgetSpec.parse(budget),
            name=name,
            conflict_aware=conflict_aware,
            reuse_plan=reuse_plan,
        )

    # -------------------------------------------------------------- queries
    @property
    def op(self) -> str:
        return self.operator.op

    @property
    def theta(self) -> Dict[str, Any]:
        return dict(self.operator.theta)

    def children(self) -> List["MergeSpec"]:
        """Nested sub-merges among this node's inputs (base first)."""
        return [i for i in [self.base, *self.experts] if isinstance(i, MergeSpec)]

    def walk(self) -> Iterator["MergeSpec"]:
        """Post-order traversal of the spec DAG (children before parents),
        deduplicated by spec_id."""
        seen: Dict[str, bool] = {}

        def _walk(node: "MergeSpec") -> Iterator["MergeSpec"]:
            for child in node.children():
                yield from _walk(child)
            sid = node.spec_id
            if sid not in seen:
                seen[sid] = True
                yield node

        yield from _walk(self)

    def depth(self) -> int:
        """0 for leaf merges (all inputs are model ids)."""
        kids = self.children()
        return 0 if not kids else 1 + max(k.depth() for k in kids)

    # -------------------------------------------------------- serialization
    def to_dict(self) -> Dict[str, Any]:
        def enc(inp: Input):
            return inp.to_dict() if isinstance(inp, MergeSpec) else inp

        doc: Dict[str, Any] = {
            "base": enc(self.base),
            "experts": [enc(e) for e in self.experts],
            "op": self.operator.op,
            "theta": dict(self.operator.theta),
            "budget": self.budget.to_json(),
        }
        if self.name:
            doc["name"] = self.name
        if not self.conflict_aware:
            doc["conflict_aware"] = False
        if not self.reuse_plan:
            doc["reuse_plan"] = False
        return doc

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "MergeSpec":
        def dec(inp) -> Input:
            if isinstance(inp, str):
                return inp
            if isinstance(inp, dict):
                return cls.from_dict(inp)
            raise TypeError(f"bad merge input in spec document: {inp!r}")

        return cls.build(
            base=dec(doc["base"]),
            experts=[dec(e) for e in doc.get("experts") or []],
            op=doc.get("op", "ties"),
            theta=doc.get("theta"),
            budget=doc.get("budget"),
            name=doc.get("name"),
            conflict_aware=bool(doc.get("conflict_aware", True)),
            reuse_plan=bool(doc.get("reuse_plan", True)),
        )

    def canonical(self) -> str:
        """Canonical JSON for content addressing — nested specs collapse
        to their spec_id so structurally equal graphs share digests.
        ``name`` is part of the identity: it names a distinct output
        snapshot, so same-content-different-name specs execute separately."""

        def enc(inp: Input):
            return {"spec": inp.spec_id} if isinstance(inp, MergeSpec) else inp

        return json.dumps(
            {
                "base": enc(self.base),
                "experts": [enc(e) for e in self.experts],
                "op": self.operator.op,
                "theta": self.operator.theta,
                "budget": self.budget.to_json(),
                "conflict_aware": self.conflict_aware,
                "name": self.name,
            },
            sort_keys=True,
        )

    @property
    def spec_id(self) -> str:
        digest = hashlib.blake2b(
            self.canonical().encode(), digest_size=8
        ).hexdigest()
        return f"spec-{digest}"

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"MergeSpec({self.spec_id}, op={self.op!r}, "
            f"base={self.base if isinstance(self.base, str) else self.base.spec_id!r}, "
            f"experts={len(self.experts)}, budget={self.budget})"
        )
