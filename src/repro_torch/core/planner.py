"""PlanGen — greedy budget-aware plan generation (paper §4, Algorithm 1).

Pipeline:
  1. Enumerate candidate expert blocks from catalog BlockMeta (metadata
     only — zero parameter I/O).
  2. Score each candidate with conflict-aware signals (§4.3):
       salience density  = l2_delta / size(b)      (task-vector magnitude)
       sign agreement    = 1 - disagreement with the cross-expert majority
                           signature (TIES-style conflict hint)
     Signals rank candidates; they never alter operator semantics.
  3. Sort descending, admit while cost + size(b) <= B (budget-feasible by
     construction, Definition 4.2).  When a candidate would overflow the
     budget it is skipped; for TIES/DARE the planner may record a bounded
     θ adjustment instead (decisions are persisted for reproducibility).
  4. Fallback (§4.5): experts with missing/unreliable block metadata fall
     back to tensor-level selection; events recorded in the plan.

Complexity: O(N_b log N_b) in the number of candidate blocks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.plan import MergePlan

#: operators whose θ the planner may adjust under budget pressure (§4.4)
_THETA_ADJUSTABLE = {"ties", "dare"}


def _majority_sign_signature(sigs: np.ndarray) -> int:
    """Bitwise majority vote over uint64 sign signatures."""
    if sigs.size == 0:
        return 0
    bits = np.unpackbits(sigs.view(np.uint8).reshape(sigs.size, 8), axis=1)
    maj = (bits.sum(axis=0) * 2 >= sigs.size).astype(np.uint8)
    return int(np.packbits(maj).view(np.uint64)[0])


def _popcount64(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x.view(np.uint8).reshape(x.size, 8), axis=1).sum(axis=1)


class PlannerResult:
    def __init__(self, plan: MergePlan, stats: Dict[str, Any]):
        self.plan = plan
        self.stats = stats


def plan_merge(
    catalog: Catalog,
    base_id: str,
    expert_ids: Sequence[str],
    op: str,
    theta: Optional[Dict[str, Any]] = None,
    budget_b: Optional[int] = None,
    block_size: int = blk.DEFAULT_BLOCK_SIZE,
    conflict_aware: bool = True,
    reuse: bool = True,
    spec_id: Optional[str] = None,
    parent_sids: Optional[Sequence[str]] = None,
    layout_id: Optional[str] = None,
    tier_probe=None,
) -> PlannerResult:
    """Generate (or reuse) a budget-feasible merge plan.

    ``budget_b=None`` means unbounded (full-read plan — the faithful
    "budget = 100%" configuration).  ``spec_id`` / ``parent_sids`` stamp
    API v2 provenance (declarative spec + merge-graph inputs) into the
    plan; a reused plan with different provenance is re-recorded under a
    fresh plan_id so lineage never aliases across specs.

    ``layout_id`` costs the selection against a packed physical layout
    (store/packed): candidates are charged their **physical** bytes —
    zero for elided blocks, the (possibly compressed) extent size for
    the *first* selected consumer of each content-addressed extent and
    zero for every further one (the executor reads each unique extent
    once and fans it out).  The same byte budget therefore buys strictly
    more selected blocks on a packed store; ``plan.c_expert_hat`` becomes
    the physical planned cost and ``plan.c_expert_logical_hat`` keeps the
    flat-store equivalent.

    ``tier_probe`` (see ``repro_torch.store.tiered.make_tier_probe``) bills
    candidates by storage tier: ``probe(expert, tensor, block, nbytes)``
    returns a weight in [0, 1] and the candidate is charged
    ``nbytes * weight`` — free for RAM-resident blocks, a token fraction
    for local-disk cache hits, full price for cold remote fetches.  The
    budget then governs *cold moved bytes*, so warm tiers let the same B
    admit more blocks.  Applied only to flat-costed candidates (packed
    layouts carry their own physical costing); note that plan *reuse*
    short-circuits re-billing — pass ``reuse=False`` to re-plan against
    the current cache state.
    """
    t0 = time.time()
    theta = dict(theta or {})
    expert_ids = list(expert_ids)
    parent_sids = list(parent_sids or [])

    packed_costs: Dict[str, Dict] = {}
    if layout_id is not None:
        layout_row = catalog.get_packed_layout(layout_id)
        if layout_row is None:
            raise KeyError(f"packed layout {layout_id!r} not in catalog")
        if layout_row["block_size"] != block_size:
            raise ValueError(
                f"layout {layout_id!r} is packed at block_size="
                f"{layout_row['block_size']}, planner wants {block_size}"
            )
        if layout_row["base_id"] != base_id:
            # elision is defined relative to the layout's base: an elided
            # block's delta is zero vs *that* base only — planning this
            # merge against it would silently corrupt the output
            raise ValueError(
                f"layout {layout_id!r} was packed against base "
                f"{layout_row['base_id']!r}; cannot plan a merge with "
                f"base {base_id!r} from it"
            )
        members = set(catalog.packed_layout_members(layout_id))
        missing_members = [e for e in expert_ids if e not in members]
        if missing_members:
            raise KeyError(
                f"experts {missing_members} are not members of packed "
                f"layout {layout_id!r}"
            )
        packed_costs = {
            e: catalog.packed_block_costs(layout_id, e) for e in expert_ids
        }

    base_rows = catalog.tensor_metas(base_id)
    if not base_rows:
        raise KeyError(f"base model {base_id!r} not analyzed — run ANALYZE first")
    tensor_order = [r[0] for r in base_rows]  # already sorted by tensor_id
    base_nbytes = {r[0]: r[3] for r in base_rows}

    naive_cost = 0
    effective_budget = budget_b
    # -- plan reuse across iterative merges (§2.2) ------------------------
    if reuse and budget_b is not None:
        cached = catalog.find_reusable_plan(
            base_id, expert_ids, op, budget_b, layout_id=layout_id
        )
        if cached is not None:
            plan = MergePlan.from_payload(cached["payload"])
            # Reuse is only sound at the same block granularity and with
            # the same requested θ (the stored θ may carry bounded
            # budget-pressure adjustments — revert those before comparing).
            cached_theta = dict(plan.theta)
            for d in plan.decisions:
                if "theta_adjust" in d:
                    cached_theta[d["theta_adjust"]] = d["from"]
            if (
                plan.block_size != block_size
                or cached_theta != theta
                # physical-vs-logical costing differs: a flat plan is not
                # a packed plan even with identical inputs and budget
                or plan.layout_id != layout_id
            ):
                cached = None
        if cached is not None:
            if plan.spec_id != spec_id or plan.parent_sids != parent_sids:
                # same selection, new provenance: fork under a fresh id so
                # each spec's lineage stays distinct in the catalog.
                plan = dataclasses.replace(
                    plan,
                    plan_id=MergePlan.new_id(),
                    spec_id=spec_id,
                    parent_sids=parent_sids,
                )
                catalog.record_plan(
                    plan.plan_id, base_id, expert_ids, op, plan.budget_b,
                    plan.digest(), plan.c_expert_hat, plan.to_payload(),
                )
            return PlannerResult(
                plan,
                {
                    "reused": True,
                    "plan_seconds": time.time() - t0,
                    "c_expert_hat": plan.c_expert_hat,
                },
            )

    # -- candidate enumeration (metadata only) ---------------------------
    cand_expert: List[int] = []  # index into expert_ids
    cand_tensor: List[str] = []
    cand_block: List[int] = []
    cand_bytes: List[int] = []
    cand_phys: List[int] = []  # physical cost (== logical on flat stores)
    cand_hash: List[Optional[str]] = []  # packed extent key (dedup sharing)
    cand_salience: List[float] = []
    cand_sig: List[int] = []
    fallback_events: List[Dict] = []
    tensor_fallback: List[Tuple[int, str, int, float]] = []  # (ei, tensor, nbytes, score)
    tier_discount = 0  # logical-minus-billed bytes granted by tier_probe

    for ei, e in enumerate(expert_ids):
        rows = catalog.block_metas(e, block_size)
        pcosts = packed_costs.get(e)
        if rows:
            for (tensor_id, block_idx, nbytes, _h, l2, _amax, _mean, sig,
                 l2_delta, _cos) in rows:
                naive_cost += nbytes
                sal = l2_delta if l2_delta is not None else l2
                cand_expert.append(ei)
                cand_tensor.append(tensor_id)
                cand_block.append(block_idx)
                cand_bytes.append(nbytes)
                if pcosts is not None:
                    phys, ehash, kind = pcosts.get(
                        (tensor_id, block_idx), (nbytes, None, "flat")
                    )
                    cand_phys.append(int(phys))
                    cand_hash.append(ehash if kind == "extent" else None)
                elif tier_probe is not None:
                    w = float(tier_probe(e, tensor_id, block_idx, nbytes))
                    billed = int(round(nbytes * w))
                    tier_discount += nbytes - billed
                    cand_phys.append(billed)
                    cand_hash.append(None)
                else:
                    cand_phys.append(nbytes)
                    cand_hash.append(None)
                cand_salience.append(float(sal))
                cand_sig.append(int(sig))
        else:
            # §4.5 tensor-level fallback: no block metadata for this expert
            trows = catalog.tensor_metas(e)
            if not trows:
                raise KeyError(f"expert {e!r} has no catalog metadata at all")
            fallback_events.append(
                {"expert": e, "cause": "missing BlockMeta", "granularity": "tensor"}
            )
            for tensor_id, _shape, _dtype, nbytes in trows:
                naive_cost += nbytes
                tensor_fallback.append((ei, tensor_id, nbytes, 1.0))

    # -- scoring (§4.3) ----------------------------------------------------
    n = len(cand_expert)
    sizes = np.asarray(cand_bytes, dtype=np.int64)
    scores = np.zeros(n, dtype=np.float64)
    if n:
        sal = np.asarray(cand_salience, dtype=np.float64)
        scores = sal / np.maximum(sizes, 1)  # salience density (knapsack greedy)
        if conflict_aware and op.lower() == "ties" and len(expert_ids) > 1:
            # group candidates by (tensor, block) and compute cross-expert
            # majority sign signatures; agreement boosts priority.
            keys = {}
            for i in range(n):
                keys.setdefault((cand_tensor[i], cand_block[i]), []).append(i)
            # signatures are stored signed in SQLite; view back as uint64
            sig_arr = np.asarray(cand_sig, dtype=np.int64).view(np.uint64)
            agree = np.ones(n, dtype=np.float64)
            for _, idxs in keys.items():
                if len(idxs) < 2:
                    continue
                group = sig_arr[np.asarray(idxs)]
                maj = _majority_sign_signature(group)
                dis = _popcount64(group ^ np.uint64(maj)) / 64.0
                agree[np.asarray(idxs)] = 1.0 - dis
            scores = scores * (0.5 + 0.5 * agree)

    # -- greedy selection under budget (Algorithm 1) -----------------------
    # ``cost`` is the planned C_expert_hat — *physical* bytes when costing
    # against a packed layout (elided blocks are free; each content-
    # addressed extent is charged to its first admitted consumer only,
    # mirroring the executor's read-once fan-out), logical bytes otherwise.
    selection: Dict[str, Dict[str, List[int]]] = {e: {} for e in expert_ids}
    cost = 0
    logical_cost = 0
    admitted = 0
    skipped_budget = 0
    decisions: List[Dict] = []
    admitted_extents: set = set()
    if n:
        # deterministic order: score desc, then (expert, tensor, block) asc
        order = np.lexsort(
            (np.asarray(cand_block), np.asarray(cand_tensor, dtype=object),
             np.asarray(cand_expert), -scores)
        )
        for i in order:
            b_bytes = int(sizes[i])
            marginal = int(cand_phys[i])
            ehash = cand_hash[i]
            if ehash is not None and ehash in admitted_extents:
                marginal = 0  # extent already paid for by an earlier admit
            if effective_budget is not None and cost + marginal > effective_budget:
                skipped_budget += 1
                continue
            e = expert_ids[cand_expert[i]]
            selection[e].setdefault(cand_tensor[i], []).append(int(cand_block[i]))
            if ehash is not None:
                admitted_extents.add(ehash)
            cost += marginal
            logical_cost += b_bytes
            admitted += 1

    # tensor-level fallback candidates compete at whole-tensor granularity
    granularity = "block"
    if tensor_fallback:
        granularity = "mixed" if n else "tensor"
        for ei, tensor_id, nbytes, _score in sorted(
            tensor_fallback, key=lambda r: (r[0], r[1])
        ):
            if effective_budget is not None and cost + nbytes > effective_budget:
                skipped_budget += 1
                continue
            e = expert_ids[ei]
            nblocks = blk.num_blocks(nbytes, block_size)
            selection[e].setdefault(tensor_id, []).extend(range(nblocks))
            cost += nbytes
            logical_cost += nbytes
            admitted += nblocks

    # θ adjustment under budget pressure (§4.4): bounded, recorded.
    if (
        skipped_budget > 0
        and op.lower() in _THETA_ADJUSTABLE
        and effective_budget is not None
        and naive_cost > 0
    ):
        # operator sparsity tracks the *coverage* fraction (logical bytes
        # accessed), not physical I/O — dedup/compression change the cost
        # of a block, not how much of the model the merge touches
        realized_frac = logical_cost / naive_cost
        key = "density" if op.lower() == "dare" else "trim_frac"
        if key in theta:
            old = theta[key]
            # keep operator sparsity consistent with the accessed fraction,
            # bounded to ±20% of the original setting.
            new = float(np.clip(old * (0.8 + 0.4 * realized_frac), 0.8 * old, old))
            if new != old:
                theta[key] = new
                decisions.append(
                    {"theta_adjust": key, "from": old, "to": new,
                     "cause": "budget pressure", "realized_frac": realized_frac}
                )

    for e in selection:
        for t in selection[e]:
            selection[e][t] = sorted(selection[e][t])

    plan = MergePlan(
        plan_id=MergePlan.new_id(),
        base_id=base_id,
        expert_ids=expert_ids,
        op=op,
        theta=theta,
        budget_b=effective_budget if effective_budget is not None else -1,
        block_size=block_size,
        selection=selection,
        tensor_order=tensor_order,
        c_expert_hat=cost,
        granularity=granularity,
        fallback_events=fallback_events,
        decisions=decisions,
        spec_id=spec_id,
        parent_sids=parent_sids,
        layout_id=layout_id,
        c_expert_logical_hat=logical_cost,
    )
    # Feasibility (Definition 4.2) holds by construction; assert anyway.
    assert effective_budget is None or plan.c_expert_hat <= effective_budget, (
        plan.c_expert_hat,
        effective_budget,
    )

    catalog.record_plan(
        plan.plan_id,
        base_id,
        expert_ids,
        op,
        plan.budget_b,
        plan.digest(),
        plan.c_expert_hat,
        plan.to_payload(),
    )
    stats = {
        "reused": False,
        "plan_seconds": time.time() - t0,
        "candidates": n + len(tensor_fallback),
        "admitted": admitted,
        "skipped_budget": skipped_budget,
        "c_expert_hat": cost,
        "c_expert_logical_hat": logical_cost,
        "c_expert_naive": naive_cost,
        "layout_id": layout_id,
        "fallbacks": len(fallback_events),
        "tier_billed": tier_probe is not None,
        "tier_discount_bytes": tier_discount,
    }
    return PlannerResult(plan, stats)


# ===================================================================== batch
@dataclasses.dataclass
class BatchJob:
    """One merge job in a multi-job planning request (API v2 session)."""

    base_id: str
    expert_ids: List[str]
    op: str
    theta: Optional[Dict[str, Any]] = None
    budget_b: Optional[int] = None
    conflict_aware: bool = True
    reuse: bool = True
    spec_id: Optional[str] = None
    parent_sids: List[str] = dataclasses.field(default_factory=list)
    #: packed layout to cost (and execute) this job against, if any
    layout_id: Optional[str] = None
    #: arbitration group (e.g. MergeService tenant) — jobs sharing a
    #: group are jointly capped by that group's entry in
    #: ``plan_batch(group_budgets=...)``
    group: Optional[str] = None


class BatchPlannerResult:
    def __init__(self, results: List[PlannerResult], stats: Dict[str, Any]):
        self.results = results
        self.stats = stats


def _selection_bytes(
    catalog: Catalog,
    plan: MergePlan,
    block_bytes_cache: Dict[str, Dict[Tuple[str, int], Tuple[int, Optional[str]]]],
) -> Dict[Tuple[str, str, int], Tuple[int, Optional[str]]]:
    """Expand a plan's selection into
    ``{(expert, tensor, block): (nbytes, extent_key)}``.

    Sizes come from the same BlockMeta rows the planner enumerated (this
    also covers adapter experts, whose selection indexes base-shaped
    delta blocks rather than their own factor tensors); experts planned
    via the §4.5 tensor-level fallback derive sizes from TensorMeta.
    Plans costed against a packed layout report *physical* bytes (elided
    blocks 0, extents their compressed size) plus the content-addressed
    extent key, so the batch pool can charge each shared extent once —
    the same marginal model the planner budgets and the executor
    realizes.  Flat plans carry ``extent_key=None``.
    """
    out: Dict[Tuple[str, str, int], Tuple[int, Optional[str]]] = {}
    layout = plan.layout_id
    for e, per_t in plan.selection.items():
        cache_key = e if layout is None else f"{layout}\x00{e}"
        sizes = block_bytes_cache.get(cache_key)
        if sizes is None:
            sizes = {
                (r[0], r[1]): (r[2], None)
                for r in catalog.block_metas(e, plan.block_size)
            }
            if layout is not None:
                for key, (phys, ehash, kind) in catalog.packed_block_costs(
                    layout, e
                ).items():
                    if key in sizes:
                        # layout-qualified: identical content in two
                        # different layouts is still two physical extents
                        sizes[key] = (
                            phys,
                            f"{layout}\x00{ehash}" if kind == "extent" else None,
                        )
            block_bytes_cache[cache_key] = sizes
        tensor_sizes: Optional[Dict[str, int]] = None
        for t, bs in per_t.items():
            for b in bs:
                entry = sizes.get((t, b))
                if entry is None:
                    # tensor-level fallback expert (no BlockMeta rows)
                    if tensor_sizes is None:
                        tensor_sizes = {
                            r[0]: r[3] for r in catalog.tensor_metas(e)
                        }
                    total = tensor_sizes.get(t)
                    if total is None or b >= blk.num_blocks(total, plan.block_size):
                        continue
                    entry = (
                        blk.block_range(total, b, plan.block_size).nbytes,
                        None,
                    )
                out[(e, t, b)] = entry
    return out


def _union_physical_bytes(
    union: Dict[Tuple[str, str, int], Tuple[int, Optional[str]]],
) -> int:
    """Physical bytes of a shared read schedule: each content-addressed
    extent charged once however many (expert, block) consumers share it
    (extent keys arrive layout-qualified, so identical content living in
    two layouts is still two physical extents)."""
    total = 0
    seen: set = set()
    for nbytes, ehash in union.values():
        if ehash is not None:
            if ehash in seen:
                continue
            seen.add(ehash)
        total += nbytes
    return total


def plan_batch(
    catalog: Catalog,
    jobs: Sequence[BatchJob],
    block_size: int = blk.DEFAULT_BLOCK_SIZE,
    shared_budget_b: Optional[int] = None,
    max_pool_iters: int = 4,
    group_budgets: Optional[Dict[str, Optional[int]]] = None,
    tier_probe=None,
) -> BatchPlannerResult:
    """Plan a *set* of merge jobs together (API v2 batch entry point).

    Each job is planned with :func:`plan_merge` under its own budget; the
    batch layer then computes the **shared read schedule**: the union of
    selected ``(expert, tensor, block)`` keys across jobs, which is the
    expert I/O a shared-cache execution actually pays (one scan of each
    selected block feeds every job that selected it).

    ``shared_budget_b`` is a pool constraint on that *union*: if the
    union overflows the pool, every job's budget is scaled down
    proportionally and the batch is re-planned (bounded fixed-point
    iteration; decisions recorded in the stats).

    ``group_budgets`` adds per-group caps on the same model: the union of
    the selections of all jobs whose :attr:`BatchJob.group` is ``g`` must
    fit ``group_budgets[g]``.  This is the MergeService's weighted-fair
    tenant arbitration: each scheduling window plans with the tenants'
    *remaining* pool shares as group caps, so realized physical expert
    bytes per tenant track the configured weights while the global pool
    bounds the whole window.  Both constraints converge through the same
    fixed-point iteration, with the same guaranteed proportional-split
    fallback (group caps applied first, then the global pool).

    ``tier_probe`` is forwarded to every per-job :func:`plan_merge` for
    tier-aware billing of remote-backed experts.  The *union pool* keeps
    charging full block bytes (conservative: a warm block still counts
    against the shared pool), so pool arbitration never over-admits when
    the cache turns out colder than probed.
    """
    t0 = time.time()
    jobs = list(jobs)
    budgets: List[Optional[int]] = [j.budget_b for j in jobs]
    decisions: List[Dict[str, Any]] = []
    block_bytes_cache: Dict[str, Dict[Tuple[str, int], Tuple[int, Optional[str]]]] = {}
    group_budgets = {
        g: cap for g, cap in (group_budgets or {}).items() if cap is not None
    }

    results: List[PlannerResult] = []
    union_bytes = 0
    sum_bytes = 0
    group_union: Dict[str, int] = {}

    def _plan_round(first: bool) -> None:
        nonlocal results, union_bytes, sum_bytes, group_union
        results = [
            plan_merge(
                catalog,
                j.base_id,
                j.expert_ids,
                j.op,
                theta=j.theta,
                budget_b=budgets[i],
                block_size=block_size,
                conflict_aware=j.conflict_aware,
                reuse=j.reuse and first,
                spec_id=j.spec_id,
                parent_sids=j.parent_sids,
                layout_id=j.layout_id,
                tier_probe=tier_probe,
            )
            for i, j in enumerate(jobs)
        ]
        union: Dict[Tuple[str, str, int], Tuple[int, Optional[str]]] = {}
        per_group: Dict[str, Dict] = {}
        sum_bytes = 0
        for j, pr in zip(jobs, results):
            sel = _selection_bytes(catalog, pr.plan, block_bytes_cache)
            union.update(sel)
            if j.group is not None:
                per_group.setdefault(j.group, {}).update(sel)
            sum_bytes += pr.plan.c_expert_hat
        union_bytes = _union_physical_bytes(union)
        group_union = {
            g: _union_physical_bytes(u) for g, u in per_group.items()
        }

    def _overflowed_groups() -> Dict[str, int]:
        return {
            g: cap
            for g, cap in group_budgets.items()
            if group_union.get(g, 0) > cap
        }

    for it in range(max(1, max_pool_iters)):
        _plan_round(first=it == 0)
        over_global = shared_budget_b is not None and union_bytes > shared_budget_b
        over_groups = _overflowed_groups()
        if not over_global and not over_groups:
            break
        if it == max(1, max_pool_iters) - 1:
            break  # no further round would apply a scaling decision
        # pool overflow: shrink each offending job's budget proportionally
        # and replan; a job constrained both by its group and the global
        # pool takes the tighter factor
        gscale = (
            shared_budget_b / max(union_bytes, 1) if over_global else 1.0
        )
        new_budgets: List[Optional[int]] = []
        for i, (j, pr) in enumerate(zip(jobs, results)):
            f = gscale
            if j.group in over_groups:
                f = min(
                    f, over_groups[j.group] / max(group_union[j.group], 1)
                )
            if f >= 1.0:
                new_budgets.append(budgets[i])
                continue
            cur = budgets[i] if budgets[i] is not None else pr.plan.c_expert_hat
            new_budgets.append(max(0, int(cur * f)))
        decisions.append(
            {
                "pool_iteration": it,
                "union_bytes": union_bytes,
                "shared_budget_b": shared_budget_b,
                "group_union_bytes": dict(group_union),
                "over_groups": sorted(over_groups),
                "scale": gscale,
                "budgets": list(new_budgets),
            }
        )
        budgets = new_budgets

    if (shared_budget_b is not None and union_bytes > shared_budget_b) or (
        _overflowed_groups()
    ):
        # Fixed point not reached (jobs select disjoint-ish blocks, so the
        # union shrinks sublinearly).  Guaranteed fallback: split each
        # over-cap group's budget across its jobs proportionally to their
        # current demand, then the global pool across all jobs — then
        # per group union <= Σ_{i∈g} Ĉ_i <= cap_g and globally
        # union <= Σ Ĉ_i <= Σ budget_i <= pool, by construction.
        hats = [pr.plan.c_expert_hat for pr in results]
        alloc = list(hats)
        for g, cap in group_budgets.items():
            idxs = [i for i, j in enumerate(jobs) if j.group == g]
            g_total = max(sum(hats[i] for i in idxs), 1)
            if sum(hats[i] for i in idxs) > cap:
                for i in idxs:
                    alloc[i] = cap * hats[i] // g_total
        if shared_budget_b is not None and sum(alloc) > shared_budget_b:
            total = max(sum(alloc), 1)
            alloc = [shared_budget_b * a // total for a in alloc]
        budgets = alloc
        decisions.append(
            {
                "pool_final_split": True,
                "union_bytes": union_bytes,
                "shared_budget_b": shared_budget_b,
                "group_union_bytes": dict(group_union),
                "budgets": list(budgets),
            }
        )
        _plan_round(first=False)

    stats = {
        "jobs": len(jobs),
        "plan_seconds": time.time() - t0,
        "c_expert_hat_sum": sum_bytes,
        "c_expert_hat_union": union_bytes,
        "sharing_factor": (sum_bytes / union_bytes) if union_bytes else 1.0,
        "shared_budget_b": shared_budget_b,
        "pool_decisions": decisions,
        "pool_respected": shared_budget_b is None
        or union_bytes <= shared_budget_b,
        "group_union_bytes": dict(group_union),
        "group_budgets": dict(group_budgets),
        "groups_respected": not _overflowed_groups(),
    }
    return BatchPlannerResult(results, stats)
