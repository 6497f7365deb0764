"""Coordinator — scatter one plan across shard workers, commit once.

``run_sharded_merge`` is the distributed twin of
:func:`repro_torch.core.executor.execute_merge`: same inputs, same manifest,
same transactional guarantees, same return shape.  It partitions the
plan's realized read set into byte-balanced shards
(:mod:`repro_torch.dist.partition`), issues a :class:`ShardLease` per shard
over a transport (:mod:`repro_torch.dist.transport`), and watches for exits:

* a clean exit yields a result doc — staged region manifest, global
  touch/coverage, per-shard IOStats snapshot;
* a resumable death (chaos crash, killed process) expires the lease and
  the shard is re-issued at ``attempt + 1`` — the successor resumes
  from the shard journal's high-water mark, so crash + resume reads
  each residual byte once and total expert spend stays inside the
  ``[hat, 2*hat)`` requeue bound;
* anything else aborts the whole window (all-shards-or-nothing).

Once every shard lands, the coordinator splices the regions — in plan
tensor order, verifying each region's streaming hash as it reads — into
ONE real :class:`StagingWriter` under the job's
:class:`TransactionManager`, then publishes exactly the way
``execute_merge`` does: one atomic rename, one commit record, one
coverage/touch/DAG write-back.  Worker stats roll up into the job's
:class:`IOStats` under a per-shard dimension; canonical ``out`` bytes
are billed once (at splice), region and journal overhead land in
``other``/``journal`` — see docs/DISTRIBUTED.md for the parity story.

Port notes: ``device`` (the caller's, as ``execute_merge`` takes it)
goes into each lease unless ``DistOptions.device`` names another, and
each shard's entry in the run stats carries the device its worker
named, the worker's kernel launches (its ``merge_block.LAUNCHES``
delta) and the wall-clock times of its start and first staged block.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.executor import (
    MergeResult,
    PipelineConfig,
    _check_cancel,
    _ranges_from_indices,
)
from repro_torch.core.plan import MergePlan
from repro_torch.core.transactions import TransactionManager
from repro_torch.dist.lease import DistOptions, ShardLease
from repro_torch.dist.partition import Partition, partition_plan
from repro_torch.dist.transport import make_transport
from repro_torch.store.journal import journal_path
from repro_torch.store.snapshot import SnapshotStore


def shard_journal_root(snapshots: SnapshotStore) -> str:
    """Shard journals live one directory below the service journal root
    so ``TransactionManager.recover()`` (which lists only top-level
    ``*.journal`` files) never mistakes a shard journal for a dead
    service-level run — shard recovery is the coordinator's job."""
    return os.path.join(snapshots.journal_root, "shards")


def _shard_journal_path(snapshots: SnapshotStore, sid: str, shard: int) -> str:
    return journal_path(
        shard_journal_root(snapshots), "%s.shard%d" % (sid, shard))


def run_sharded_merge(
    plan: MergePlan,
    snapshots: SnapshotStore,
    catalog: Catalog,
    sid: Optional[str] = None,
    txn: Optional[TransactionManager] = None,
    options: Optional[DistOptions] = None,
    coalesce: bool = True,
    verify=True,
    pipeline: Optional[PipelineConfig] = None,
    cancel=None,
    progress=None,
    resume=None,
    device="cuda",
) -> MergeResult:
    t0 = time.time()
    options = options or DistOptions()
    options.validate()
    stats = snapshots.stats
    expert_read_before = stats.c_expert
    txn = txn or TransactionManager(snapshots, catalog)
    sid = sid or TransactionManager.new_sid()
    workspace = os.path.dirname(snapshots.staging_root)

    if resume is not None:
        if resume.sid != sid:
            raise ValueError(
                "resume state is for sid %r, not %r" % (resume.sid, sid))
        if resume.plan_digest != plan.digest():
            resume.discard()
            resume = None

    align = "tensor" if options.kernel == "mesh" else "block"
    part = partition_plan(plan, catalog, options.n_workers, align=align)
    live = [s for s in part.shards if not s.empty]
    shard_root = os.path.join(snapshots.staging_root, "shards", sid)
    ctl_dir = os.path.join(shard_root, "ctl")
    os.makedirs(shard_root, exist_ok=True)
    os.makedirs(shard_journal_root(snapshots), exist_ok=True)
    transport = make_transport(options.transport)

    verify_doc = (
        dataclasses.asdict(verify) if dataclasses.is_dataclass(verify)
        else bool(verify)
    )
    pipeline_doc = (
        dataclasses.asdict(pipeline) if pipeline is not None else None
    )
    lease_device = str(options.device if options.device is not None
                       else device)

    def _lease(shard, attempt: int, with_chaos: bool) -> ShardLease:
        chaos = None
        if (with_chaos and options.chaos
                and int(options.chaos.get("shard", 0)) == shard.shard):
            chaos = {k: v for k, v in options.chaos.items() if k != "shard"}
        return ShardLease(
            shard=shard.shard,
            sid=sid,
            attempt=attempt,
            budget=shard.budget,
            spans=[(t, lo, hi) for t, (lo, hi) in shard.spans.items()],
            plan=plan.to_payload(),
            block_size=plan.block_size,
            shard_dir=os.path.join(shard_root, "shard%d" % shard.shard),
            journal_path=_shard_journal_path(snapshots, sid, shard.shard),
            coalesce=coalesce,
            verify=verify_doc,
            kernel=options.kernel,
            pipeline=pipeline_doc,
            journal_sync_every=options.journal_sync_every,
            chaos=chaos,
            device=lease_device,
        )

    by_shard = {s.shard: s for s in live}
    pending: Dict[int, object] = {}
    attempts: Dict[int, int] = {}
    docs: Dict[int, Dict] = {}
    crashed_stats: List[Tuple[int, Dict]] = []
    reissued = 0
    total_blocks = sum(s.n_blocks for s in live)
    done_blocks = 0

    try:
        _check_cancel(cancel, sid)
        for s in live:
            attempts[s.shard] = 1
            pending[s.shard] = transport.launch(
                workspace, _lease(s, 1, with_chaos=True), ctl_dir)

        # -- watch the fleet; expire + re-issue dead leases -------------
        while pending:
            _check_cancel(cancel, sid)
            moved = False
            for k in sorted(pending):
                ex = pending[k].poll()
                if ex is None:
                    continue
                moved = True
                del pending[k]
                if ex.ok:
                    docs[k] = ex.result
                    done_blocks += by_shard[k].n_blocks
                    if progress is not None:
                        progress(done_blocks, total_blocks)
                    continue
                if ex.partial_stats is not None:
                    crashed_stats.append((k, ex.partial_stats))
                if not ex.crashed or attempts[k] >= options.max_lease_attempts:
                    raise RuntimeError(
                        "shard %d failed%s: %s"
                        % (k, "" if ex.crashed is False else
                           " after %d attempts" % attempts[k], ex.detail))
                # lease expired: re-issue to a survivor slot; the chaos
                # armed on attempt 1 is NOT re-armed, so the successor
                # resumes from the shard journal and completes
                attempts[k] += 1
                reissued += 1
                pending[k] = transport.launch(
                    workspace, _lease(by_shard[k], attempts[k],
                                      with_chaos=False), ctl_dir)
            if pending and not moved:
                time.sleep(options.heartbeat_s)

        # -- roll up worker stats under the shard dimension -------------
        for k, doc in sorted(docs.items()):
            stats.absorb(doc["stats"], shard=str(k))
        for k, snap in crashed_stats:
            stats.absorb(snap, shard=str(k))

        # -- budget soundness across the fleet --------------------------
        realized_expert_bytes = stats.c_expert - expert_read_before
        if plan.budget_b >= 0:
            slack = 2 * plan.block_size * max(1, len(live))
            # extents straddling shard cuts move once per shard (priced
            # by the partitioner, not the planner)
            slack += part.duplicate_extent_bytes
            # per-worker honesty widenings (cap rereads, evict refetch,
            # read repair) — already itemized in each result doc
            slack += sum(doc.get("slack_bytes", 0) for doc in docs.values())
            # each expired lease may have spent up to its shard budget
            # before dying: the [hat, 2*hat) requeue allowance
            slack += sum(
                (attempts[k] - 1) * (by_shard[k].budget + 2 * plan.block_size)
                for k in attempts
            )
            if realized_expert_bytes > plan.c_expert_hat + slack:
                raise RuntimeError(
                    "budget soundness violated: realized expert bytes "
                    "%d > planned %d (+%d distributed slack)"
                    % (realized_expert_bytes, plan.c_expert_hat, slack))

        # -- splice regions into the real staged snapshot ----------------
        touch, coverage_rows, realized_expert_blocks = _merge_docs(docs)
        if resume is not None:
            writer = txn.begin(resume=resume)
        else:
            writer = txn.begin(sid=sid, plan=plan)
        base_reader = snapshots.models.open_model(plan.base_id)
        try:
            _splice(plan, writer, base_reader, docs, stats,
                    coverage_rows, resume)
        finally:
            base_reader.close()
        writer.validate_hashes()

        theta = {k: v for k, v in plan.theta.items()
                 if not str(k).startswith("_")}
        manifest = {
            "sid": sid,
            "plan_id": plan.plan_id,
            "base_id": plan.base_id,
            "expert_ids": plan.expert_ids,
            "op": plan.op,
            "theta": theta,
            "budget_b": plan.budget_b,
            "c_expert_hat": plan.c_expert_hat,
            "c_expert_logical_hat": plan.logical_hat,
            "c_expert_run": realized_expert_bytes,
            "plan_digest": plan.digest(),
            "block_size": plan.block_size,
            "layout_id": plan.layout_id,
            "execution": "sharded",
            "n_workers": options.n_workers,
        }
        sid = txn.atomic_publish(writer, manifest)
        manifest["output_root"] = snapshots.manifest(sid)["output_root"]
        txn.commit_record(sid, manifest)
        catalog.record_touch_map(
            sid, {t: _ranges_from_indices(ix) for t, ix in touch.items()}
        )
        catalog.record_coverage(sid, coverage_rows)
        if plan.parent_sids:
            catalog.record_dag_edges(
                sid,
                [
                    (p, "base" if p == plan.base_id else "expert")
                    for p in plan.parent_sids
                ],
            )
        if writer.journal is not None:
            writer.journal.remove()
        txn.commit()
        # all-shards-or-nothing landed: sweep every shard artifact so a
        # committed window leaves zero staging residue
        _cleanup_shards(snapshots, shard_root, sid, live)
    except Exception:
        for h in pending.values():
            h.terminate()
        _cleanup_shards(snapshots, shard_root, sid, live)
        txn.abort()
        raise

    run_stats = {
        "seconds": time.time() - t0,
        "c_expert_run": realized_expert_bytes,
        "c_expert_hat": plan.c_expert_hat,
        "realized_expert_blocks": realized_expert_blocks,
        "compute": "sharded",
        "coalesce": coalesce,
        "resumed_blocks": sum(
            doc.get("resumed_blocks", 0) for doc in docs.values()),
        "execution": "sharded",
        "n_workers": options.n_workers,
        "transport": options.transport,
        "kernel": options.kernel,
        "reissued": reissued,
        "partition": {
            "total_expert_bytes": part.total_expert_bytes,
            "duplicate_extent_bytes": part.duplicate_extent_bytes,
            "shards": [
                {
                    "shard": s.shard,
                    "n_blocks": s.n_blocks,
                    "expert_bytes": s.expert_bytes,
                    "budget": s.budget,
                }
                for s in part.shards
            ],
        },
        "shards": [
            {
                "shard": k,
                "attempts": attempts[k],
                "realized_expert_bytes": doc["realized_expert_bytes"],
                "realized_expert_blocks": doc["realized_expert_blocks"],
                "resumed_blocks": doc.get("resumed_blocks", 0),
                "seconds": doc["seconds"],
                "device": doc["device"],
                "launches": doc["launches"],
                "started_at": doc["started_at"],
                "first_block_at": doc["first_block_at"],
            }
            for k, doc in sorted(docs.items())
        ],
    }
    verify_docs = [doc["verify"] for doc in docs.values() if "verify" in doc]
    if verify_docs:
        run_stats["verify"] = {
            key: sum(v[key] for v in verify_docs)
            for key in ("verified_blocks", "repaired_blocks",
                        "corrupt_blocks", "repair_bytes")
        }
    return MergeResult(sid, manifest, run_stats)


def _merge_docs(docs: Dict[int, Dict]):
    """Merge worker touch/coverage (already GLOBAL-indexed) in shard
    order — spans are disjoint, so concatenation is exact."""
    touch: Dict[str, List[int]] = {}
    coverage_rows: List[Tuple[str, int, str]] = []
    realized_blocks = 0
    for k in sorted(docs):
        doc = docs[k]
        realized_blocks += doc["realized_expert_blocks"]
        for t, bs in doc["touch"].items():
            touch.setdefault(t, []).extend(int(b) for b in bs)
        for t, b, csv in doc["coverage"]:
            coverage_rows.append((t, int(b), csv))
    for t in touch:
        touch[t] = sorted(touch[t])
    coverage_rows.sort(key=lambda r: (r[0], r[1]))
    return touch, coverage_rows, realized_blocks


def _splice(plan, writer, base_reader, docs, stats, coverage_rows, resume):
    """Stream every region file through the real StagingWriter in plan
    order, verifying each region's blake2b-16 against the worker's
    streaming hash.  Output bytes are billed here, once, to ``out``
    (inside write_block); region reads land in ``other``."""
    regions_by_tensor: Dict[str, List[Tuple[Dict, str]]] = {}
    for k in sorted(docs):
        doc = docs[k]
        shard_dir = _shard_dir_of(doc)
        for region in doc["regions"]:
            regions_by_tensor.setdefault(region["tensor"], []).append(
                (region, shard_dir))
    csv_by_block = {(t, b): csv for t, b, csv in coverage_rows}
    for tensor_id in plan.tensor_order:
        spec = base_reader.spec(tensor_id)
        n_blocks = blk.num_blocks(spec.nbytes, plan.block_size)
        regions = sorted(
            regions_by_tensor.get(tensor_id, []),
            key=lambda rs: rs[0]["lo"])
        covered = sum(r["hi"] - r["lo"] for r, _d in regions)
        if covered != n_blocks or (regions and regions[0][0]["lo"] != 0):
            raise IOError(
                "shard regions do not tile tensor %r: %d of %d blocks"
                % (tensor_id, covered, n_blocks))
        skip = 0
        if resume is not None:
            tr = resume.tensors.get(tensor_id)
            if tr is not None:
                skip = tr.n_validated
        writer.begin_tensor(tensor_id, spec.shape, spec.dtype)
        for region, shard_dir in regions:
            path = os.path.join(shard_dir, region["file"])
            h = hashlib.blake2b(digest_size=16)
            with open(path, "rb") as f:
                for b in range(region["lo"], region["hi"]):
                    nb = blk.block_range(
                        spec.nbytes, b, plan.block_size).nbytes
                    raw = f.read(nb)
                    if len(raw) != nb:
                        raise IOError(
                            "short region read for %r block %d"
                            % (tensor_id, b))
                    h.update(raw)
                    stats.record_read("other", nb)
                    if b < skip:
                        continue  # coordinator resume: already staged
                    writer.write_block(
                        tensor_id, b, np.frombuffer(raw, np.uint8),
                        experts=csv_by_block.get((tensor_id, b)),
                    )
            if h.hexdigest() != region["hash"]:
                raise IOError(
                    "region hash mismatch for %r [%d, %d) from shard "
                    "staging %r" % (tensor_id, region["lo"], region["hi"],
                                    shard_dir))
        writer.finish_tensor(tensor_id)


def _shard_dir_of(doc: Dict) -> str:
    # the lease pinned the shard dir; workers echo regions relative to it
    return doc["shard_dir"]


def _cleanup_shards(snapshots, shard_root, sid, live) -> None:
    shutil.rmtree(shard_root, ignore_errors=True)
    for s in live:
        try:
            os.unlink(_shard_journal_path(snapshots, sid, s.shard))
        except OSError:
            pass
