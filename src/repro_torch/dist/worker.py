"""Shard worker — one lease in, one staged region + result doc out.

A worker is the distributed analogue of one ``execute_merge`` call,
minus the transaction: it opens the workspace substrate read-only-ish
(fresh :class:`IOStats`, no recovery, no TransactionManager), rebuilds
the exact plan from the lease payload, and runs the UNMODIFIED pipelined
engine over its global block spans — flat, packed, and tiered/remote
readers all compose with selection slicing, verify-on-read attaches per
reader exactly as in single-process execution, and per-block progress
journals into the shard's own :class:`ProgressJournal` namespace.

Crash semantics mirror the single-process engine: a
:class:`SimulatedCrash` (or a real worker death) leaves the staged
region and shard journal on disk; a successor worker holding the
re-issued lease validates the journaled prefix with the standard
``parse_journal``/``build_resume_state`` machinery (shard journals are
local-indexed, so they parse verbatim) and resumes at the high-water
block, billing the skipped volume as refunded residuals.

The worker enforces its per-shard byte budget the way ``execute_merge``
enforces the plan budget: lease budget plus two blocks of accounting
granularity plus honestly-recorded widenings (packed extent re-reads
under memory caps, disk-cache evict refetches, read-repair traffic).

Port notes: the worker computes on ``lease.device``, resolved before any
I/O (a lease naming a card that is not there raises; it never runs on
the CPU).  ``kernel="torch"`` hands the engine the port's
``merge_blocks`` on that device; ``"mesh"`` packs the shard and runs
:func:`repro_torch.core.distributed.build_merge_step` there, at the
stored block's element count (``block_size // itemsize``; the reference
packs at ``block_size // 4``, which no bf16 block fits).  The result doc
adds the device, the worker's kernel launches (the delta of
``merge_block.LAUNCHES`` over the run) and the wall-clock times of its
start and first staged block.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.delta_iterator import DeltaIterator
from repro_torch.core.executor import (
    PipelineConfig,
    _is_mergeable,
    _PipelineEngine,
    _packed_layouts_behind,
    _tiered_readers_behind,
    _torch_kernel_ops,
)
from repro_torch.core.plan import MergePlan
from repro_torch.dist.lease import ShardLease
from repro_torch.dist.region import ShardRegionWriter
from repro_torch.store import dtypes
from repro_torch.store.integrity import VerifyPolicy, attach_verifier
from repro_torch.store.iostats import IOStats
from repro_torch.store.journal import (
    ProgressJournal,
    ResumeState,
    build_resume_state,
    parse_journal,
)
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.testing import chaos
from repro_torch.testing.chaos import chaos_point


class _GlobalResumeView:
    """Adapter presenting a shard journal's LOCAL-indexed resume state
    to the engine, which thinks in GLOBAL block indices.  The engine
    only reads ``.completed`` and ``.coverage()`` — the region writer
    consumes the underlying local state directly."""

    def __init__(self, rs: ResumeState, spans: Dict[str, Tuple[int, int]]):
        self._rs = rs
        self._spans = spans
        self.completed = {
            t: spans[t][0] + n
            for t, n in rs.completed.items()
            if t in spans
        }

    def coverage(self, tensor_id: str) -> List[Tuple[int, str]]:
        lo = self._spans[tensor_id][0]
        return [(lo + b, experts) for b, experts in self._rs.coverage(tensor_id)]


def _coerce_verify(verify) -> object:
    if isinstance(verify, dict):
        return VerifyPolicy(**verify)
    return verify


def run_worker(
    workspace: str,
    lease: ShardLease,
    result_path: Optional[str] = None,
    stats: Optional[IOStats] = None,
) -> Dict:
    """Execute one shard lease; returns (and optionally writes) the
    result doc the coordinator splices from.  Raises
    :class:`~repro_torch.testing.chaos.SimulatedCrash` straight through —
    staged region + shard journal survive for the successor."""
    armed = False
    if lease.chaos:
        chaos.arm(lease.chaos["point"], int(lease.chaos.get("skip", 0)))
        armed = True
    try:
        chaos_point("worker:lease")
        doc = _run(workspace, lease, stats if stats is not None else IOStats())
        # the "commit" of a worker is its result doc becoming visible —
        # a death here loses the attempt exactly like a mid-block death
        chaos_point("worker:commit")
        if result_path is not None:
            _write_json(result_path, doc)
        return doc
    finally:
        if armed:
            chaos.disarm()


def _write_json(path: str, doc: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # chaos-ok: worker:commit fires before this write


def _run(workspace: str, lease: ShardLease, stats: IOStats) -> Dict:
    t0 = time.time()
    from repro_torch.kernels import merge_block as mb  # lazy: torch import
    from repro_torch.kernels.ops import resolve_device

    # before any I/O: a lease naming a missing card raises here
    device = resolve_device(lease.device)
    launches_before = dict(mb.LAUNCHES)
    snapshots = SnapshotStore(workspace, stats)
    catalog = Catalog(os.path.join(workspace, "catalog.sqlite"), stats)
    plan = MergePlan.from_payload(lease.plan)
    spans = lease.span_map()
    expert_read_before = stats.c_expert

    # -- shard-journal resume (predecessor's high-water mark) -----------
    resume = None
    parsed = parse_journal(lease.journal_path, stats)
    if parsed is not None:
        if parsed.plan_digest != plan.digest() or lease.kernel == "mesh":
            # plan drift (worthless blocks) or the whole-tensor mesh
            # path (recomputes its spans wholesale) — start fresh
            shutil.rmtree(parsed.staging_dir, ignore_errors=True)
            try:
                os.unlink(lease.journal_path)
            except FileNotFoundError:
                pass
        else:
            resume = build_resume_state(parsed, stats)

    os.makedirs(os.path.dirname(lease.journal_path), exist_ok=True)
    journal = ProgressJournal(
        lease.journal_path, stats,
        sync_every=(lease.journal_sync_every
                    if lease.journal_sync_every is not None
                    else SnapshotStore.journal_sync_every),
    )
    journal.begin(
        "%s#shard%d" % (lease.sid, lease.shard), plan.plan_id, plan.digest(),
        lease.shard_dir, lease.block_size, attempt=lease.attempt,
    )
    writer = ShardRegionWriter(
        lease.shard_dir, spans, stats, journal=journal, resume=resume,
    )

    resume_view = None
    resumed_blocks = 0
    if resume is not None:
        resume_view = _GlobalResumeView(resume, spans)
        # refunded residuals: the predecessor already paid for the
        # validated prefix — record the skipped logical volume so crash
        # + resume provably covers each selected byte once
        for t, tr in resume.tensors.items():
            if t not in spans or not tr.n_validated:
                continue
            lo, _hi = spans[t]
            resumed_blocks += tr.n_validated
            stats.record_skip("base", tr.validated_nbytes)
            stats.record_skip("out", tr.validated_nbytes)
            rev = plan.reverse_index(t)
            skipped = 0
            for bl in range(tr.n_validated):
                skipped += len(rev.get(lo + bl, ())) * tr.block_nbytes[bl]
            stats.record_skip("expert", skipped)

    # -- readers: exactly the owned path of execute_merge ---------------
    base_reader = snapshots.models.open_model(plan.base_id)
    packed_layout = None
    if getattr(plan, "layout_id", None):
        packed_layout = snapshots.packed.open_layout(plan.layout_id)
        expert_readers = {
            e: packed_layout.open_member(e) for e in plan.expert_ids
        }
    else:
        expert_readers = {
            e: snapshots.models.open_model(e) for e in plan.expert_ids
        }
    merge_layouts = (
        [packed_layout] if packed_layout is not None
        else _packed_layouts_behind(expert_readers)
    )
    reread_before = sum(l.reread_bytes for l in merge_layouts)
    tiered_readers = _tiered_readers_behind(
        [base_reader, *expert_readers.values()]
    )
    evict_refetch_before = sum(r.evict_refetch_bytes for r in tiered_readers)
    verify_policy = VerifyPolicy.coerce(_coerce_verify(lease.verify))
    verifiers = []
    for mid, r in [(plan.base_id, base_reader), *expert_readers.items()]:
        v = attach_verifier(r, catalog, mid, plan.block_size, verify_policy)
        if v is not None:
            verifiers.append(v)
    repair_before = sum(
        getattr(r, "repair_bytes", 0) for r in tiered_readers
    ) + sum(getattr(l, "repair_bytes", 0) for l in merge_layouts)

    cfg = (
        PipelineConfig(**lease.pipeline) if lease.pipeline is not None
        else (PipelineConfig.for_remote()
              if any(getattr(r, "prefers_deep_prefetch", False)
                     for r in tiered_readers)
              else PipelineConfig())
    )
    kernel_ops = None
    if lease.kernel == "torch":
        kernel_ops = _torch_kernel_ops(device)
    else:
        cfg = dataclasses.replace(cfg, kernel="numpy")
    cfg.validate()

    theta = dict(plan.theta)
    seed = int(theta.get("seed", 0))
    is_dare = plan.op.lower() == "dare"
    touch: Dict[str, List[int]] = {}
    coverage_rows: List[Tuple[str, int, str]] = []

    try:
        if lease.kernel == "mesh":
            realized_expert_blocks, pipe_stats = _run_mesh(
                plan, spans, writer, base_reader, expert_readers, theta,
                lease, touch, coverage_rows, device,
            )
        else:
            engine = _PipelineEngine(
                plan, writer, base_reader, expert_readers, theta, seed,
                is_dare, cfg, kernel_ops, lease.coalesce, touch,
                coverage_rows, resume=resume_view, spans=spans,
            )
            realized_expert_blocks, pipe_stats = engine.run()

        # -- per-shard budget soundness (lease contract) ----------------
        realized_expert_bytes = stats.c_expert - expert_read_before
        slack = 2 * lease.block_size
        slack += sum(l.reread_bytes for l in merge_layouts) - reread_before
        slack += (
            sum(r.evict_refetch_bytes for r in tiered_readers)
            - evict_refetch_before
        )
        repair_bytes = (
            sum(getattr(r, "repair_bytes", 0) for r in tiered_readers)
            + sum(getattr(l, "repair_bytes", 0) for l in merge_layouts)
            - repair_before
        )
        slack += repair_bytes
        if lease.budget >= 0 and realized_expert_bytes > lease.budget + slack:
            raise RuntimeError(
                "shard %d budget violated: realized expert bytes %d > "
                "leased %d (+%d slack)"
                % (lease.shard, realized_expert_bytes, lease.budget, slack)
            )
        # detach, not abort: region + journal stay until the coordinator
        # splices, commits, and sweeps the shard artifacts
        writer.detach()
    except BaseException as e:
        # SimulatedCrash (BaseException) falls through the Exception arm:
        # region + journal survive, open handles are released — the same
        # on-disk state a kill -9 leaves.  Real errors discard the shard.
        if isinstance(e, Exception):
            writer.abort()
        else:
            writer.detach()
        raise
    finally:
        base_reader.close()
        for r in expert_readers.values():
            r.close()
        if packed_layout is not None:
            packed_layout.close()

    doc = {
        "shard": lease.shard,
        "sid": lease.sid,
        "attempt": lease.attempt,
        "kernel": lease.kernel,
        "shard_dir": lease.shard_dir,
        "regions": writer.region_manifest(),
        "touch": {t: [int(b) for b in bs] for t, bs in touch.items()},
        "coverage": [[t, int(b), csv] for t, b, csv in coverage_rows],
        "realized_expert_bytes": realized_expert_bytes,
        "realized_expert_blocks": realized_expert_blocks,
        "resumed_blocks": resumed_blocks,
        "slack_bytes": slack - 2 * lease.block_size,
        "seconds": time.time() - t0,
        "device": str(device),
        "launches": {k: v - launches_before.get(k, 0)
                     for k, v in mb.LAUNCHES.items()},
        "started_at": t0,
        "first_block_at": writer.first_block_at,
        "stats": stats.snapshot(),
        "pipeline": pipe_stats,
    }
    if verify_policy is not None:
        doc["verify"] = {
            "verified_blocks": sum(v.verified_blocks for v in verifiers),
            "repaired_blocks": sum(v.repaired_blocks for v in verifiers),
            "corrupt_blocks": sum(v.corrupt_blocks for v in verifiers),
            "repair_bytes": repair_bytes,
        }
    return doc


def _run_mesh(
    plan: MergePlan,
    spans: Dict[str, Tuple[int, int]],
    writer: ShardRegionWriter,
    base_reader,
    expert_readers: Dict[str, object],
    theta: Dict,
    lease: ShardLease,
    touch: Dict[str, List[int]],
    coverage_rows: List[Tuple[str, int, str]],
    device,
) -> Tuple[int, Dict]:
    """Device-compute path: pack this shard's (whole) tensors into the
    (NB, W) block matrix and apply ``core.distributed.build_merge_step``
    once on ``device``.  Requires tensor-aligned spans (the partitioner
    enforces this for ``kernel="mesh"``).  Tolerance-level on TIES tail
    blocks — see the pack_arrays docstring and tests.

    W is the stored block's element count, ``block_size // itemsize`` of
    the shard's mergeable tensors, which must share one item size (the
    reference packs at ``block_size // 4``: a bf16 block holds twice
    that and does not fit)."""
    from repro_torch.core.distributed import (
        build_merge_step,
        dare_masks_packed,
        pack_arrays,
        selection_mask,
        unpack_arrays,
    )

    merge_tensors: List[str] = []
    pass_through: Dict[str, List[np.ndarray]] = {}
    base_arrays: Dict[str, np.ndarray] = {}
    specs: Dict[str, object] = {}
    base_blocks: Dict[str, List[np.ndarray]] = {}
    realized = 0

    for t in plan.tensor_order:
        if t not in spans:
            continue
        spec = base_reader.spec(t)
        n_blocks = blk.num_blocks(spec.nbytes, plan.block_size)
        lo, hi = spans[t]
        if (lo, hi) != (0, n_blocks):
            raise RuntimeError(
                "mesh kernel requires tensor-aligned shard spans; got "
                "[%d, %d) of %d blocks for %r" % (lo, hi, n_blocks, t))
        specs[t] = spec
        blocks = [
            base_reader.read_block(t, b, plan.block_size, "base")
            for b in range(n_blocks)
        ]
        base_blocks[t] = blocks
        rev = plan.reverse_index(t)
        if _is_mergeable(spec) and rev:
            merge_tensors.append(t)
            base_arrays[t] = np.concatenate(
                [dtypes.to_float32(b).reshape(-1) for b in blocks]
            ).reshape(spec.shape)
        else:
            pass_through[t] = blocks

    itemsizes = sorted({specs[t].dtype.itemsize for t in merge_tensors})
    if len(itemsizes) > 1:
        raise ValueError(
            "mesh kernel packs one block width a shard; its mergeable "
            "tensors have item sizes %s (%s)" % (itemsizes, ", ".join(
                "%s: %s" % (t, specs[t]["dtype"]) for t in merge_tensors)))
    W = lease.block_size // (itemsizes[0] if itemsizes else 4)
    pipe_stats = {"kernel": "mesh", "windows": 0, "device": str(device)}
    out_arrays: Dict[str, np.ndarray] = {}
    if merge_tensors:
        arrays = {t: base_arrays[t] for t in merge_tensors}
        packed, metas = pack_arrays(arrays, W)
        n_packed = packed.shape[0]
        offsets = {name: off for name, _s, _n, off in metas}
        experts = np.zeros(
            (len(plan.expert_ids), n_packed, W), np.float32)
        for t in merge_tensors:
            D = DeltaIterator(t, plan, base_reader, expert_readers,
                              coalesce=lease.coalesce)
            rev = plan.reverse_index(t)
            for b in sorted(rev):
                x0 = base_blocks[t][b]
                deltas, eidxs, eids = D.pull(b, x0)
                realized += len(eids)
                if eids:
                    touch.setdefault(t, []).append(b)
                    coverage_rows.append((t, b, ",".join(eids)))
                for row, ei in enumerate(eidxs):
                    d = np.asarray(deltas[row], np.float32).reshape(-1)
                    experts[ei, offsets[t] + b, : d.size] = d
        select = selection_mask(plan, metas, W, n_packed)
        masks = None
        if plan.op.lower() == "dare":
            masks = dare_masks_packed(plan, metas, W, n_packed)
        kind = "delta"  # DeltaIterator already materialized deltas
        step = build_merge_step(plan.op.lower(), theta, kind=kind,
                                device=device)
        args = [packed, experts, select]
        if masks is not None:
            args.append(masks)
        out = step(*args).cpu().numpy()
        del experts, masks
        out_arrays = unpack_arrays(out, metas)
        pipe_stats["packed_blocks"] = int(n_packed)
        pipe_stats["block_elems"] = int(W)

    for t in plan.tensor_order:
        if t not in spans:
            continue
        spec = specs[t]
        n_blocks = blk.num_blocks(spec.nbytes, plan.block_size)
        writer.begin_tensor(t, spec.shape, spec.dtype)
        covered = {b: csv for tt, b, csv in coverage_rows if tt == t}
        if t in out_arrays:
            flat = np.asarray(out_arrays[t], np.float32).reshape(-1)
            elems = W
            for b in range(n_blocks):
                chunk = flat[b * elems: (b + 1) * elems]
                src = base_blocks[t][b]
                blockv = (
                    dtypes.from_float32(chunk, np.asarray(src).dtype)
                    if b in covered else src
                )
                writer.write_block(t, b, blockv, experts=covered.get(b))
        else:
            for b in range(n_blocks):
                writer.write_block(t, b, pass_through[t][b])
        writer.finish_tensor(t)
        touch.setdefault(t, [])
    return realized, pipe_stats
