"""Cost model for model merging (paper §3).

    C_merge = C_base + C_expert + C_out + C_meta

``C_base`` and ``C_out`` are semantic necessities (every merge reads the
full base and writes a complete output checkpoint).  ``C_expert`` is the
only term that grows with K under naive execution and the only term the
planner optimizes; the budget constraint is ``C_expert <= B``.

All estimates here are *metadata-only*: they read the catalog, never
parameter bytes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.core.catalog import Catalog


@dataclasses.dataclass
class CostEstimate:
    c_base: int
    c_expert_hat: int
    c_out: int
    c_meta_hat: int

    @property
    def c_total_hat(self) -> int:
        return self.c_base + self.c_expert_hat + self.c_out + self.c_meta_hat

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self) | {"c_total_hat": self.c_total_hat}


@dataclasses.dataclass(frozen=True)
class TierCostModel:
    """Per-tier billing weights and latency shape for tiered storage
    (repro_torch.store.tiered).

    The planner multiplies each candidate block's physical bytes by the
    weight of the tier that would serve it *right now*: RAM-resident
    blocks are free (re-reading them moves nothing — same rule the
    budget-soundness check applies), local-disk extent-cache hits cost a
    token fraction (seek + page-cache traffic, no network), and cold
    remote blocks bill at full weight.  A fixed budget therefore admits
    strictly more blocks as the warm tiers fill — the §3.2 budget keeps
    governing *cold moved bytes*, which is what object storage charges
    for.

    ``remote_latency_s`` / ``remote_mbps`` describe the endpoint for
    wall-time estimation (``seconds``); they do not affect billing.
    """

    ram_weight: float = 0.0
    disk_weight: float = 0.05
    remote_weight: float = 1.0
    remote_latency_s: float = 0.0
    remote_mbps: float = 0.0

    def seconds(self, nbytes: int, requests: int, tier: str = "remote") -> float:
        """Estimated wall time to move ``nbytes`` in ``requests`` round
        trips from one tier (metadata-only; disk/RAM modeled as free)."""
        if tier != "remote":
            return 0.0
        t = requests * self.remote_latency_s
        if self.remote_mbps:
            t += nbytes / (self.remote_mbps * 1e6)
        return t


def model_nbytes(catalog: Catalog, model_id: str) -> int:
    """Total parameter bytes of a cataloged model (Σ size(T))."""
    rows = catalog.tensor_metas(model_id)
    if not rows:
        raise KeyError(f"model {model_id!r} has no tensor metadata in catalog")
    return sum(r[3] for r in rows)


def naive_expert_cost(catalog: Catalog, expert_ids: Sequence[str]) -> int:
    """C_expert^naive = Σ_i Σ_{T∈M_i} size(T) — the O(K) term (§3.2).

    Always *logical* bytes: fractional budgets resolve against this even
    on a packed store, which is precisely how the same budget buys more
    selected blocks there (the physical cost of each block shrank).
    """
    return sum(model_nbytes(catalog, e) for e in expert_ids)


def packed_expert_cost(
    catalog: Catalog, layout_id: str, expert_ids: Sequence[str]
) -> int:
    """Physical full-read expert cost on a packed layout: Σ per-block
    post-dedup/elision/compression bytes, each shared extent charged
    once.  Metadata-only (packed_block/packed_extent tables)."""
    seen: set = set()
    total = 0
    for e in expert_ids:
        for (phys, ehash, kind) in catalog.packed_block_costs(
            layout_id, e
        ).values():
            if kind == "extent":
                if ehash in seen:
                    continue
                seen.add(ehash)
            total += phys
    return total


def estimate(
    catalog: Catalog,
    base_id: str,
    expert_ids: Sequence[str],
    c_expert_hat: Optional[int] = None,
    meta_fraction: float = 0.002,
) -> CostEstimate:
    """Bind the cost model to a candidate plan (§4.2).

    ``c_expert_hat`` is the planned expert read cost (Σ selected block
    sizes); if None, the naive full-read cost is used.  ``C_meta`` is
    bounded and weakly strategy-dependent; we budget it as a small fixed
    fraction of moved bytes (validated against measurements in
    benchmarks/bench_overheads.py).
    """
    c_base = model_nbytes(catalog, base_id)
    c_out = c_base  # merged model preserves the base tensor structure
    if c_expert_hat is None:
        c_expert_hat = naive_expert_cost(catalog, expert_ids)
    c_meta = int(meta_fraction * (c_base + c_out + c_expert_hat))
    return CostEstimate(c_base, c_expert_hat, c_out, c_meta)
