"""Merge operators — AVG / Task-Arithmetic / TIES / DARE (paper §2.1, §4.1).

MergePipe is operator-agnostic: the planner only decides *which* expert
blocks are read; operators combine whatever was read without semantic
changes.  Every operator has the signature

    apply(x0f, D, theta) -> out_f32

where ``x0f`` is the base block upcast to float32 with shape (n,), and
``D`` is the stacked selected expert deltas with shape (K_sel, n)
(Δ_i = expert_i - base).  Blocks with zero selected experts short-circuit
to the base block in the executor and never reach an operator.

Blockwise adaptation note (recorded per DESIGN.md §2): reference TIES
trims per-*tensor* top-ρ; the streaming engine applies the same rule
per-*block* so the operator can run in O(block) memory.  With the default
128 KiB blocks this is a 32k-element sample per decision; deviation is
measured in benchmarks/bench_quality.py (Table 7) and stays at the 1e-3
level, matching the paper's budgeted-deviation observations.

DARE determinism: drop masks are derived from a counter-based Philox
generator keyed on (seed, expert_index) with a per-(tensor, block)
counter, so re-executing a plan reproduces the output bit-for-bit
(paper §6.7 repeatability) independent of traversal order.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np

from repro_torch.store.dtypes import from_float32, to_float32

OperatorFn = Callable[[np.ndarray, np.ndarray, Dict], np.ndarray]

_REGISTRY: Dict[str, OperatorFn] = {}


@dataclasses.dataclass(frozen=True)
class ThetaParam:
    """Schema entry for one θ key: type plus an optional range (lower
    bound exclusive by default; ``lo_inclusive=True`` allows == lo)."""

    type: type
    lo: Optional[float] = None
    hi: Optional[float] = None
    lo_inclusive: bool = False

    def check(self, key: str, value: Any) -> Any:
        if self.type is float:
            if not isinstance(value, (int, float)) or isinstance(value, bool):
                raise ValueError(f"theta[{key!r}] must be a number, got {value!r}")
            value = float(value)
        elif self.type is int:
            if not isinstance(value, int) or isinstance(value, bool):
                raise ValueError(f"theta[{key!r}] must be an int, got {value!r}")
        if self.lo is not None:
            ok = value >= self.lo if self.lo_inclusive else value > self.lo
            if not ok:
                op = ">=" if self.lo_inclusive else ">"
                raise ValueError(
                    f"theta[{key!r}]={value} must be {op} {self.lo}"
                )
        if self.hi is not None and not (value <= self.hi):
            raise ValueError(f"theta[{key!r}]={value} must be <= {self.hi}")
        return value


#: θ keys accepted by every operator (seed drives DARE-style determinism
#: and is harmless elsewhere; lam is the common scaling knob).
_COMMON_THETA: Dict[str, ThetaParam] = {
    "lam": ThetaParam(float),
    "seed": ThetaParam(int),
}

_THETA_SCHEMAS: Dict[str, Dict[str, ThetaParam]] = {}


def register_theta_schema(name: str, schema: Dict[str, ThetaParam]) -> None:
    _THETA_SCHEMAS[name.lower()] = {**_COMMON_THETA, **schema}


def theta_schema(op: str) -> Dict[str, ThetaParam]:
    try:
        return _THETA_SCHEMAS[op.lower()]
    except KeyError:
        raise KeyError(
            f"unknown merge operator {op!r}; known: {sorted(_THETA_SCHEMAS)}"
        ) from None


def validate_theta(
    op: str, theta: Optional[Dict[str, Any]], strict: bool = True
) -> Dict[str, Any]:
    """Validate θ against the operator's schema.

    ``strict=True`` raises on unknown keys / out-of-range values (API v2);
    ``strict=False`` only warns and passes values through unchanged
    (legacy facade compatibility).
    """
    schema = theta_schema(op)
    out: Dict[str, Any] = {}
    for key, value in (theta or {}).items():
        if key.startswith("_"):
            raise ValueError(f"theta key {key!r} is reserved for the executor")
        param = schema.get(key)
        if param is None:
            msg = (
                f"operator {op!r} does not accept theta key {key!r}; "
                f"known: {sorted(schema)}"
            )
            if strict:
                raise ValueError(msg)
            warnings.warn(msg, stacklevel=3)
            out[key] = value
            continue
        try:
            out[key] = param.check(key, value)
        except ValueError:
            if strict:
                raise
            warnings.warn(
                f"theta[{key!r}]={value!r} is outside the schema for {op!r}",
                stacklevel=3,
            )
            out[key] = value
    return out


def register(name: str, theta: Optional[Dict[str, ThetaParam]] = None):
    def deco(fn: OperatorFn) -> OperatorFn:
        _REGISTRY[name.lower()] = fn
        register_theta_schema(name, theta or {})
        return fn

    return deco


def get_operator(name: str) -> OperatorFn:
    try:
        return _REGISTRY[name.lower()]
    except KeyError:
        raise KeyError(
            f"unknown merge operator {name!r}; known: {sorted(_REGISTRY)}"
        ) from None


def operator_names():
    return sorted(_REGISTRY)


# --------------------------------------------------------------------------- AVG
@register("avg")
def avg_merge(x0f: np.ndarray, D: np.ndarray, theta: Dict) -> np.ndarray:
    """Model-soup average over {base} ∪ selected experts:
    mean(x0, x1..xk) = x0 + Σ Δi / (k+1)."""
    k = D.shape[0]
    return x0f + D.sum(axis=0) / (k + 1)


# ---------------------------------------------------------------------------- TA
@register("ta")
def task_arithmetic(x0f: np.ndarray, D: np.ndarray, theta: Dict) -> np.ndarray:
    """Task Arithmetic: x0 + λ Σ Δi."""
    lam = float(theta.get("lam", 1.0))
    return x0f + lam * D.sum(axis=0)


# -------------------------------------------------------------------------- TIES
def _ties_trim_mask(D: np.ndarray, trim_frac: float) -> np.ndarray:
    """Keep the top-``trim_frac`` fraction of entries per expert by |Δ|."""
    k_exp, n = D.shape
    keep = max(1, int(round(trim_frac * n)))
    if keep >= n:
        return np.ones_like(D, dtype=bool)
    absd = np.abs(D)
    # threshold = keep-th largest per row
    thresh = np.partition(absd, n - keep, axis=1)[:, n - keep]
    return absd >= thresh[:, None]


@register("ties", theta={"trim_frac": ThetaParam(
    float, lo=0.0, hi=1.0, lo_inclusive=True)})
def ties_merge(x0f: np.ndarray, D: np.ndarray, theta: Dict) -> np.ndarray:
    """TIES: trim -> elect sign -> disjoint (sign-matched) mean -> scale."""
    trim_frac = float(theta.get("trim_frac", 0.2))
    lam = float(theta.get("lam", 1.0))
    mask = _ties_trim_mask(D, trim_frac)
    Dt = np.where(mask, D, 0.0)
    elected = np.sign(Dt.sum(axis=0))  # γ per parameter
    agree = (np.sign(Dt) == elected[None, :]) & mask & (elected != 0)[None, :]
    num = np.where(agree, Dt, 0.0).sum(axis=0)
    cnt = agree.sum(axis=0)
    merged = num / np.maximum(cnt, 1)
    return x0f + lam * merged


# -------------------------------------------------------------------------- DARE
@functools.lru_cache(maxsize=65536)
def _tensor_counter(tensor_id: str) -> int:
    """Philox counter word derived from the tensor name (cached — the
    hash is recomputed millions of times on the executor hot path)."""
    return int.from_bytes(
        hashlib.blake2b(tensor_id.encode(), digest_size=8).digest(), "little"
    )


def dare_mask(
    seed: int, expert_idx: int, tensor_id: str, block_idx: int, n: int, density: float
) -> np.ndarray:
    """Deterministic keep-mask via counter-based Philox (see module doc)."""
    bitgen = np.random.Philox(
        key=(seed & 0xFFFFFFFFFFFFFFFF) ^ (expert_idx * 0x9E3779B97F4A7C15),
        counter=[0, 0, block_idx, _tensor_counter(tensor_id)],
    )
    rng = np.random.Generator(bitgen)
    return rng.random(n) < density


def dare_mask_batch(
    seed: int,
    expert_idxs: Sequence[int],
    tensor_id: str,
    block_idx: int,
    n: int,
    density: float,
) -> np.ndarray:
    """Keep-mask stack (K_sel, n) for one block — bit-identical to stacking
    :func:`dare_mask` per expert, but one call: the tensor-name hash is
    computed once and the rows are generated into a preallocated stack
    (each expert keeps its own Philox stream, so determinism is unchanged).
    """
    th = _tensor_counter(tensor_id)
    out = np.empty((len(expert_idxs), n), dtype=bool)
    for j, ei in enumerate(expert_idxs):
        bitgen = np.random.Philox(
            key=(seed & 0xFFFFFFFFFFFFFFFF) ^ (ei * 0x9E3779B97F4A7C15),
            counter=[0, 0, block_idx, th],
        )
        out[j] = np.random.Generator(bitgen).random(n) < density
    return out


@register("dare", theta={"density": ThetaParam(float, lo=0.0, hi=1.0)})
def dare_merge(x0f: np.ndarray, D: np.ndarray, theta: Dict) -> np.ndarray:
    """DARE: random-drop deltas at rate (1-density), rescale 1/density, sum.

    ``theta['_masks']`` must carry the per-expert keep masks (K_sel, n),
    injected by the executor from :func:`dare_mask` so the randomness is
    plan-seeded and reproducible.
    """
    density = float(theta.get("density", 0.5))
    lam = float(theta.get("lam", 1.0))
    masks = theta.get("_masks")
    if masks is None:
        raise ValueError("dare requires executor-provided '_masks'")
    rescaled = np.where(masks, D, 0.0) / density
    return x0f + lam * rescaled.sum(axis=0)


def apply_operator(
    x0: np.ndarray,
    deltas: Optional[np.ndarray],
    op: str,
    theta: Dict,
) -> np.ndarray:
    """ApplyOperator(x0, {Δi}, π.Op) — Algorithm 2 inner step.

    Upcasts to float32 for math, returns the base dtype.  ``deltas=None``
    or empty => unreachable base passthrough handled by caller; kept here
    defensively so the operator layer is total.
    """
    if deltas is None or deltas.shape[0] == 0:
        return x0
    x0f = to_float32(x0)
    Df = np.asarray(deltas, dtype=np.float32)
    out = get_operator(op)(x0f, Df, theta)
    return from_float32(out, x0.dtype)
