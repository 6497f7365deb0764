"""BudgetSpec — typed expert-read budgets (API v2).

The legacy ``budget`` argument was stringly/numerically ambiguous:
``budget=1`` meant *1 byte* while ``budget=1.0`` meant *100% of the
naive expert cost*.  :class:`BudgetSpec` makes the unit part of the
type:

    BudgetSpec.parse("30%")       -> fraction of the naive expert cost
    BudgetSpec.parse("2GiB")      -> absolute bytes (binary units)
    BudgetSpec.parse("500MB")     -> absolute bytes (decimal units)
    BudgetSpec.parse(123456)      -> absolute bytes
    BudgetSpec.parse(0.3)         -> fraction (floats must be in (0, 1])
    BudgetSpec.parse(None)        -> unbounded (faithful full read)

``resolve(naive_bytes)`` binds a fraction to a concrete byte cap at
planning time; bytes/unbounded budgets resolve without the naive cost.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from typing import Optional, Union

_UNIT_BYTES = {
    "b": 1,
    "kb": 10**3,
    "mb": 10**6,
    "gb": 10**9,
    "tb": 10**12,
    "kib": 2**10,
    "mib": 2**20,
    "gib": 2**30,
    "tib": 2**40,
}

_SIZE_RE = re.compile(
    r"^\s*(?P<num>\d+(?:\.\d+)?)\s*(?P<unit>[kmgt]i?b|b)?\s*$", re.IGNORECASE
)
_PCT_RE = re.compile(r"^\s*(?P<num>\d+(?:\.\d+)?)\s*%\s*$")

BudgetLike = Union[None, int, float, str, "BudgetSpec"]


@dataclasses.dataclass(frozen=True)
class BudgetSpec:
    """Expert-read budget with an explicit unit.

    ``kind`` is one of ``"unbounded"``, ``"bytes"``, ``"fraction"``.
    """

    kind: str
    value: float = 0.0

    def __post_init__(self):
        if self.kind not in ("unbounded", "bytes", "fraction"):
            raise ValueError(f"unknown budget kind {self.kind!r}")
        if self.kind == "bytes" and (self.value < 0 or self.value != int(self.value)):
            raise ValueError(f"byte budget must be a non-negative int, got {self.value}")
        if self.kind == "fraction" and not (0 < self.value <= 1.0):
            raise ValueError(
                f"fraction budget must be in (0, 1], got {self.value}"
            )

    # ------------------------------------------------------------- builders
    @classmethod
    def unbounded(cls) -> "BudgetSpec":
        return cls("unbounded")

    @classmethod
    def bytes(cls, n: int) -> "BudgetSpec":
        return cls("bytes", int(n))

    @classmethod
    def fraction(cls, f: float) -> "BudgetSpec":
        return cls("fraction", float(f))

    @classmethod
    def parse(cls, value: BudgetLike) -> "BudgetSpec":
        """Parse any accepted budget notation into a typed spec."""
        if value is None:
            return cls.unbounded()
        if isinstance(value, BudgetSpec):
            return value
        if isinstance(value, bool):
            raise TypeError("budget cannot be a bool")
        if isinstance(value, int):
            return cls.bytes(value)
        if isinstance(value, float):
            if 0 < value <= 1.0:
                return cls.fraction(value)
            raise ValueError(
                f"float budget {value} is ambiguous; use a fraction in "
                f"(0, 1], a '%' string, or an explicit byte count/unit string"
            )
        if isinstance(value, str):
            s = value.strip().lower()
            if s in ("", "none", "unbounded", "full"):
                return cls.unbounded()
            m = _PCT_RE.match(s)
            if m:
                pct = float(m.group("num"))
                if not (0 < pct <= 100):
                    raise ValueError(f"percentage budget must be in (0, 100], got {value!r}")
                return cls.fraction(pct / 100.0)
            m = _SIZE_RE.match(s)
            if m:
                num = float(m.group("num"))
                unit = m.group("unit")
                if unit is None:
                    if num != int(num):
                        raise ValueError(
                            f"bare numeric string {value!r} is ambiguous; "
                            f"use '30%' for fractions or '123B'/'2GiB' for bytes"
                        )
                    return cls.bytes(int(num))
                return cls.bytes(int(num * _UNIT_BYTES[unit.lower()]))
            raise ValueError(f"unparseable budget {value!r}")
        raise TypeError(f"unsupported budget type {type(value).__name__}")

    @classmethod
    def from_legacy(cls, value: BudgetLike, warn: bool = True) -> "BudgetSpec":
        """Legacy ``MergePipe.merge(budget=...)`` semantics, with the
        int/float footgun surfaced: ``budget=1`` (int) means **1 byte**,
        not 100%."""
        if warn and isinstance(value, int) and not isinstance(value, bool) and value == 1:
            warnings.warn(
                "budget=1 (int) means ONE BYTE, not 100%; pass budget=1.0, "
                "'100%', or a BudgetSpec to request the full naive expert "
                "read budget",
                UserWarning,
                stacklevel=3,
            )
        if isinstance(value, float) and value > 1.0:
            # legacy resolve_budget truncated floats > 1 to bytes
            if warn:
                warnings.warn(
                    f"float budget {value} > 1 interpreted as bytes "
                    f"(legacy); use an int or a unit string like '2GiB'",
                    UserWarning,
                    stacklevel=3,
                )
            return cls.bytes(int(value))
        return cls.parse(value)

    # -------------------------------------------------------------- queries
    @property
    def is_unbounded(self) -> bool:
        return self.kind == "unbounded"

    def resolve(self, naive_bytes: Optional[int] = None) -> Optional[int]:
        """Concrete byte cap (None = unbounded).  Fractions need the
        naive full-read expert cost to bind against."""
        if self.kind == "unbounded":
            return None
        if self.kind == "bytes":
            return int(self.value)
        if naive_bytes is None:
            raise ValueError(
                "fraction budget needs naive_bytes (the full-read expert "
                "cost) to resolve"
            )
        return int(self.value * naive_bytes)

    # -------------------------------------------------------- serialization
    def to_json(self) -> Optional[str]:
        if self.kind == "unbounded":
            return None
        if self.kind == "fraction":
            return f"{self.value * 100:g}%"
        return f"{int(self.value)}B"

    def __str__(self) -> str:
        return self.to_json() or "unbounded"
