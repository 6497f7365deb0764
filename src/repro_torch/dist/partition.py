"""Byte-balanced shard partitioning over a plan's realized read set.

The unit of partitioning is the OUTPUT block: every expert block that
contributes to output block ``(tensor, b)`` must be read by whichever
worker owns that block, so shards are contiguous prefixes of the global
output-block order (``plan.tensor_order`` x block index).  Contiguity
keeps each shard a set of per-tensor half-open spans — the shape the
pipelined engine's ``spans`` parameter and the region splice both want —
and preserves the strict in-order streaming discipline of
:class:`~repro_torch.store.snapshot.StagingWriter` within a shard.

Costing mirrors the planner's marginal-byte accounting
(``planner._selection_bytes``): flat blocks bill their physical (ragged
tail) size, elided packed blocks bill zero, and a packed extent bills
once per shard that touches it.  An extent whose covered blocks straddle
a cut is physically re-read by every later shard that needs it; those
duplicate bytes are reported per shard (they widen that shard's budget)
and in total (they widen the coordinator's budget slack).

Cuts are chosen by greedy prefix sums over pure expert cost — the term
the paper budgets — giving the classic bound ``E_i <= E/n + max_unit``
where ``max_unit`` is one output block's expert bytes.  A second pass
respaces any cuts that landed inside a maximal run of zero-expert-cost
blocks evenly by block count: moving a cut within such a run cannot
change any shard's expert bytes, but it balances the base-read/output-
write work that pure expert costing is blind to (and yields an even
split when the plan selects nothing at all).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.plan import MergePlan
from repro_torch.core.planner import _selection_bytes


@dataclasses.dataclass
class Shard:
    """One worker's slice of the output-block space."""

    shard: int
    #: tensor -> (lo, hi) half-open GLOBAL block spans, plan tensor order
    spans: Dict[str, Tuple[int, int]]
    #: physical expert bytes this shard reads (each extent charged once)
    expert_bytes: int
    #: expert_bytes including cross-shard extent re-reads — the lease's
    #: per-shard byte budget before executor-style honesty widenings
    budget: int
    n_blocks: int

    @property
    def empty(self) -> bool:
        return self.n_blocks == 0


@dataclasses.dataclass
class Partition:
    shards: List[Shard]
    #: extent-once global total — equals the planner's marginal
    #: accounting of the realized read set (C^_expert physical)
    total_expert_bytes: int
    #: extra bytes moved because shared extents straddle cuts
    duplicate_extent_bytes: int
    #: (tensor, n_blocks) in plan.tensor_order — the global block order
    order: List[Tuple[str, int]]

    @property
    def n_shards(self) -> int:
        return len(self.shards)


def _tensor_blocks(plan: MergePlan, catalog: Catalog) -> List[Tuple[str, int]]:
    sizes = {r[0]: int(r[3]) for r in catalog.tensor_metas(plan.base_id)}
    order = []
    for t in plan.tensor_order:
        if t not in sizes:
            raise KeyError(
                "tensor %r in plan order but not analyzed for base %r"
                % (t, plan.base_id))
        order.append((t, blk.num_blocks(sizes[t], plan.block_size)))
    return order


def _spans_from_range(
    order: List[Tuple[str, int]], offsets: Dict[str, int], lo: int, hi: int
) -> Dict[str, Tuple[int, int]]:
    spans: Dict[str, Tuple[int, int]] = {}
    for t, n in order:
        off = offsets[t]
        s_lo, s_hi = max(lo, off), min(hi, off + n)
        if s_hi > s_lo:
            spans[t] = (s_lo - off, s_hi - off)
    return spans


def partition_plan(
    plan: MergePlan,
    catalog: Catalog,
    n_shards: int,
    align: str = "block",
) -> Partition:
    """Cut the global output-block order into ``n_shards`` contiguous
    ranges balanced on physical expert bytes.

    ``align="tensor"`` snaps every cut to a tensor boundary (required by
    the mesh kernel, which packs whole tensors); the expert-byte bound
    then loosens from one block to one tensor of slack.
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if align not in ("block", "tensor"):
        raise ValueError("align must be 'block' or 'tensor'")
    order = _tensor_blocks(plan, catalog)
    offsets: Dict[str, int] = {}
    total = 0
    for t, n in order:
        offsets[t] = total
        total += n

    # per-global-block expert cost; extents attributed to their first
    # covering block for the prefix sums, then re-costed per shard below
    cost = [0] * total
    extent_size: Dict[str, int] = {}
    extent_blocks: Dict[str, set] = {}
    for (e, t, b), (nbytes, extent_key) in _selection_bytes(
            catalog, plan, {}).items():
        if t not in offsets:
            continue
        g = offsets[t] + b
        if extent_key is None:
            cost[g] += nbytes
        else:
            extent_size[extent_key] = max(
                extent_size.get(extent_key, 0), nbytes)
            extent_blocks.setdefault(extent_key, set()).add(g)
    for key, gs in extent_blocks.items():
        cost[min(gs)] += extent_size[key]

    cuts = _prefix_cuts(cost, total, n_shards)
    if align == "tensor":
        cuts = _snap_to_tensor_boundaries(cuts, order, offsets, total)

    bounds = [0] + cuts + [total]
    shards: List[Shard] = []
    duplicate = 0
    extent_once_total = sum(cost)
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        flat = sum(
            c for g, c in enumerate(cost) if lo <= g < hi
        )
        # cost[] already charges each extent once globally (at its first
        # block); a shard whose span contains only LATER blocks of an
        # extent still physically reads it — add that re-read here
        reread = 0
        for key, gs in extent_blocks.items():
            first = min(gs)
            if not (lo <= first < hi) and any(lo <= g < hi for g in gs):
                reread += extent_size[key]
        duplicate += reread
        shards.append(Shard(
            shard=k,
            spans=_spans_from_range(order, offsets, lo, hi),
            expert_bytes=flat + reread,
            budget=flat + reread,
            n_blocks=hi - lo,
        ))
    return Partition(
        shards=shards,
        total_expert_bytes=extent_once_total,
        duplicate_extent_bytes=duplicate,
        order=order,
    )


def _prefix_cuts(cost: List[int], total: int, n_shards: int) -> List[int]:
    """n_shards-1 cut indices: greedy prefix targets over expert cost,
    then zero-run respacing for block-count balance where expert cost
    cannot discriminate."""
    E = sum(cost)
    cuts: List[int] = []
    if E > 0:
        cum = 0
        targets = [E * (k + 1) / n_shards for k in range(n_shards - 1)]
        ti = 0
        for g in range(total):
            cum += cost[g]
            while ti < len(targets) and cum >= targets[ti]:
                cuts.append(g + 1)
                ti += 1
        while len(cuts) < n_shards - 1:
            cuts.append(total)
    else:
        cuts = [0] * (n_shards - 1)

    # respace cuts stuck inside (or at the edge of) a zero-cost run —
    # moving them within the run is free in expert bytes
    out: List[int] = []
    i = 0
    while i < len(cuts):
        c = cuts[i]
        run_lo, run_hi = _zero_run(cost, total, c)
        j = i
        while j < len(cuts) and run_lo <= cuts[j] <= run_hi:
            j += 1
        n_in_run = j - i
        if n_in_run > 0 and run_hi > run_lo:
            prev = out[-1] if out else 0
            span_lo = max(run_lo, prev)
            width = run_hi - span_lo
            for m in range(n_in_run):
                out.append(span_lo + (width * (m + 1)) // (n_in_run + 1)
                           if width > 0 else span_lo)
            i = j
        else:
            out.append(c)
            i += 1
    # monotonic, clamped
    fixed: List[int] = []
    prev = 0
    for c in out:
        c = max(prev, min(c, total))
        fixed.append(c)
        prev = c
    return fixed


def _zero_run(cost: List[int], total: int, c: int) -> Tuple[int, int]:
    """Maximal [lo, hi] index range such that every cut position in it
    splits only zero-cost blocks around position ``c``."""
    lo = c
    while lo > 0 and cost[lo - 1] == 0:
        lo -= 1
    hi = c
    while hi < total and cost[hi] == 0:
        hi += 1
    return lo, hi


def _snap_to_tensor_boundaries(
    cuts: List[int], order: List[Tuple[str, int]],
    offsets: Dict[str, int], total: int,
) -> List[int]:
    boundaries = sorted({offsets[t] for t, _n in order} | {total})
    snapped: List[int] = []
    prev = 0
    for c in cuts:
        best = min(boundaries, key=lambda b: (abs(b - c), b))
        best = max(best, prev)
        snapped.append(best)
        prev = best
    return snapped
