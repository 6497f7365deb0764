"""ExecuteMerge — budget-enforced streaming execution (paper §5, Algorithm 2).

The engine enforces a planner-produced plan π:

  * every base block is read and every output block is written — the
    output is always a *complete checkpoint* (C_base, C_out intrinsic);
  * expert blocks are read **iff** selected by π (budget soundness:
    realized expert I/O <= Ĉ_expert(π) <= B);
  * writes are staged, hash-validated, and atomically published as an
    immutable snapshot with full lineage (touch maps + per-block expert
    coverage).

Three compute paths apply the operator:
  ``stream``    — per-block numpy apply (paper-faithful CPU streaming);
  ``batched``   — stacks same-width blocks and calls
                  :func:`repro_torch.kernels.ops.merge_blocks` on the
                  merge's ``device`` (the Hopper kernels on a CUDA device,
                  their plain PyTorch versions on the CPU);
  ``pipelined`` — the overlapped streaming engine (default for the v2
                  Session/CLI): a prefetch stage reads base + plan-selected
                  expert blocks ahead of compute over a small thread pool,
                  a compute stage drains bounded windows and applies the
                  operator vectorized per (K_sel, width) group, and a
                  write-behind stage streams finished blocks into the
                  staging writer — so wall-time approaches
                  max(read, compute, write) instead of their sum, with
                  resident memory bounded by the window (no whole-tensor
                  buffering).  Outputs are **bit-identical** to ``stream``
                  and expert I/O follows the plan's realized read set
                  exactly, so budget soundness accounting is unchanged.
                  See docs/EXECUTION.md.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Tuple

import functools
import types

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.delta_iterator import DeltaIterator
from repro_torch.core.operators import apply_operator, dare_mask_batch
from repro_torch.core.plan import MergePlan
from repro_torch.core.transactions import TransactionManager
from repro_torch.store.integrity import VerifyPolicy, attach_verifier
from repro_torch.store.iostats import IOStats
from repro_torch.store.journal import ResumeState
from repro_torch.store.snapshot import SnapshotStore, WriteBehindWriter
from repro_torch.testing.chaos import chaos_point


class MergeCancelled(RuntimeError):
    """Cooperative cancellation: raised at an executor checkpoint when
    the caller's cancel event fires.  The in-flight transaction aborts
    (staged output discarded, nothing published) before this propagates."""


#: progress callback signature: (blocks_done, blocks_total)
ProgressFn = Callable[[int, int], None]


def _check_cancel(cancel: Optional[threading.Event], sid: str) -> None:
    if cancel is not None and cancel.is_set():
        raise MergeCancelled(f"merge {sid} cancelled at executor checkpoint")


def _ranges_from_indices(idxs: List[int]) -> List[Tuple[int, int]]:
    """Compress sorted block indexes into [start, end) ranges (TouchMap)."""
    if not idxs:
        return []
    runs = []
    start = prev = idxs[0]
    for i in idxs[1:]:
        if i == prev + 1:
            prev = i
            continue
        runs.append((start, prev + 1))
        start = prev = i
    runs.append((start, prev + 1))
    return runs


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Tuning knobs for the overlapped (``compute="pipelined"``) engine.

    window_blocks     — blocks per compute window (vectorization batch and
                        the unit of bounded buffering).
    prefetch_windows  — max fully-read windows queued ahead of compute
                        (prefetch depth; back-pressure beyond this).
    read_threads      — thread-pool size for base/expert block reads
                        (pread-based readers, safe under concurrency).
    write_queue_blocks — bound on output blocks queued behind compute.
    coalesce_gap_bytes — tolerated unselected bytes between two selected
                        ranges before a coalesced read is split (0 =
                        merge only strictly adjacent ranges).  On
                        high-latency shared storage a slightly larger
                        sequential read beats an extra round trip; gap
                        bytes are accounted as ``other``, never against
                        the expert budget (see
                        ``ModelReader.read_blocks_coalesced``).
    kernel            — "torch" (default): each window's blocks grouped by
                        (K_sel, width) go through
                        :func:`repro_torch.kernels.ops.merge_blocks` on the
                        merge's device — the Hopper kernels on a CUDA
                        device, their plain versions on the CPU.  Both
                        repeat the numpy operators' float operations in
                        order.  "numpy": per-block numpy apply,
                        bit-identical to the stream path (the golden-test
                        invariant).
    """

    window_blocks: int = 32
    prefetch_windows: int = 2
    read_threads: int = 4
    write_queue_blocks: int = 64
    kernel: str = "torch"
    coalesce_gap_bytes: int = 0

    @classmethod
    def for_remote(cls) -> "PipelineConfig":
        """Deeper defaults for remote-backed readers: more read threads
        and more windows in flight so per-request remote latency is
        hidden behind compute, plus gap-tolerant coalescing (a slightly
        larger sequential GET beats an extra round trip)."""
        return cls(
            prefetch_windows=4,
            read_threads=8,
            coalesce_gap_bytes=1 << 14,
        )

    # NOTE on the numpy kernel: blocks are *prepared* (expert deltas
    # pulled, upcast, DARE masks generated) window-at-a-time on the
    # prefetch pool, but the operator applies per block — profiling shows
    # per-block working sets stay L2-resident while (NB, K, w) stacks are
    # memory-bandwidth-bound and *slower* on CPU.  The torch kernel groups
    # whole windows by (K_sel, width) and calls merge_blocks, where
    # batching does pay (one staging copy and launch per group).

    def validate(self) -> None:
        if self.window_blocks < 1:
            raise ValueError(f"window_blocks must be >= 1, got {self.window_blocks}")
        if self.prefetch_windows < 1:
            raise ValueError(
                f"prefetch_windows must be >= 1, got {self.prefetch_windows}"
            )
        if self.read_threads < 1:
            raise ValueError(f"read_threads must be >= 1, got {self.read_threads}")
        if self.write_queue_blocks < 1:
            raise ValueError(
                f"write_queue_blocks must be >= 1, got {self.write_queue_blocks}"
            )
        if self.kernel not in ("numpy", "torch"):
            raise ValueError(f"unknown pipeline kernel {self.kernel!r}")
        if self.coalesce_gap_bytes < 0:
            raise ValueError(
                f"coalesce_gap_bytes must be >= 0, got {self.coalesce_gap_bytes}"
            )

    def max_resident_blocks(self, n_experts: int) -> int:
        """Bound on simultaneously resident input block slots: up to
        ``prefetch_windows + 1`` windows staging on the pool, plus one
        staged window in the producer's hand while it blocks on the full
        window queue, plus ``prefetch_windows`` queued, plus one in
        compute; each window may transiently hold, per block, the base
        block, K expert cache blocks, and the K pulled delta rows
        materialized from them (write-behind output is bounded separately
        by ``write_queue_blocks``)."""
        windows_in_flight = 2 * self.prefetch_windows + 3
        return windows_in_flight * self.window_blocks * (1 + 2 * n_experts)


class MergeResult:
    def __init__(self, sid: str, manifest: Dict, stats: Dict):
        self.sid = sid
        self.manifest = manifest
        self.stats = stats

    def __repr__(self) -> str:  # pragma: no cover
        return f"MergeResult(sid={self.sid!r}, stats={self.stats})"


def _is_mergeable(spec) -> bool:
    """Float tensors are merged; ints/bools pass through as base."""
    return np.issubdtype(
        np.asarray([], dtype=spec.dtype).dtype, np.floating
    ) or spec["dtype"] in ("bfloat16", "float16", "float32", "float64")


def _tiered_readers_behind(readers) -> List[object]:
    """Distinct TieredReader objects behind the given readers (direct or
    wrapped in a CachingModelReader).  Used to (a) auto-deepen the
    pipelined prefetch for remote-latency hiding and (b) widen budget
    slack by honestly-recorded eviction re-fetches."""
    out: List[object] = []
    for r in readers:
        inner = getattr(r, "_reader", r)
        if hasattr(inner, "evict_refetch_bytes") and all(
            inner is not x for x in out
        ):
            out.append(inner)
    return out


def _packed_layouts_behind(expert_readers: Dict[str, object]) -> List[object]:
    """Distinct PackedLayout objects serving the given readers — direct
    members or members wrapped in a CachingModelReader (the Session's
    shared-read injection).  Needed so budget enforcement can widen its
    slack by honestly-recorded extent re-reads when the caller opened
    the layout with a ``max_pinned_bytes`` cap."""
    out: List[object] = []
    for r in expert_readers.values():
        inner = getattr(r, "_reader", r)
        layout = getattr(inner, "layout", None)
        if layout is not None and all(layout is not x for x in out):
            out.append(layout)
    return out


def execute_merge(
    plan: MergePlan,
    snapshots: SnapshotStore,
    catalog: Catalog,
    sid: Optional[str] = None,
    txn: Optional[TransactionManager] = None,
    coalesce: bool = True,
    compute: str = "stream",
    validate: bool = True,
    enforce_budget: bool = True,
    verify=True,
    expert_readers: Optional[Dict[str, object]] = None,
    pipeline: Optional[PipelineConfig] = None,
    cancel: Optional[threading.Event] = None,
    progress: Optional[ProgressFn] = None,
    resume: Optional[ResumeState] = None,
    device="cuda",
) -> MergeResult:
    """Run Algorithm 2 for plan π and return the committed snapshot.

    ``device`` is where the ``batched`` engine and the pipelined engine's
    ``kernel="torch"`` apply the operator: a CUDA device (the default)
    launches the Hopper kernels and raises when there is none; ``"cpu"``
    runs their plain PyTorch versions.

    ``expert_readers`` optionally injects pre-opened (possibly caching)
    readers keyed by expert id — the API v2 batch session passes shared
    :class:`~repro_torch.store.blockcache.CachingModelReader` instances here so
    one physical scan of an expert block fans out to every job in the
    batch that selected it.  Injected readers are owned by the caller
    and are NOT closed on return.

    ``pipeline`` tunes the overlapped engine when ``compute="pipelined"``
    (ignored otherwise); ``None`` uses :class:`PipelineConfig` defaults.

    ``cancel`` is a cooperative cancellation flag (any object with a
    boolean ``is_set()``): the engines poll it at block/window
    checkpoints and raise :class:`MergeCancelled` when it fires — the
    transaction aborts crash-safely, staged output is discarded, and no
    snapshot is published.  ``progress`` is called as
    ``progress(blocks_done, blocks_total)`` as output blocks retire (per
    tensor on the synchronous engines, per window on the pipelined one).

    ``verify`` enables verify-on-read (:mod:`repro_torch.store.integrity`):
    every block read during the merge is checked against the catalog's
    ANALYZE block hash (packed extents against their content-hash keys),
    with read-repair on the tiered/packed paths and a typed
    :class:`~repro_torch.store.integrity.CorruptBlockError` when repair is
    impossible.  ``True`` (default) verifies every tier; pass a
    :class:`~repro_torch.store.integrity.VerifyPolicy` to opt flat-local reads
    out of hashing on trusted hot paths; ``False`` disables entirely.
    Models without catalog analysis at this block size are served
    unverified (no contract exists for them).

    ``resume`` is a validated :class:`~repro_torch.store.journal.ResumeState`
    (from ``TransactionManager.recover()`` / ``prepare_resume``): the
    engines skip every block below its per-tensor high-water marks —
    no base read, no expert read, no write — and the budget accounting
    only sees the residual set.  The resumed snapshot is bit-identical
    to an uninterrupted run.  A resume state whose plan digest does not
    match ``plan`` is discarded and the merge restarts from scratch
    (staged blocks computed under a different plan are worthless).
    """
    t0 = time.time()
    stats: IOStats = snapshots.stats
    expert_read_before = stats.c_expert
    txn = txn or TransactionManager(snapshots, catalog)
    sid = sid or TransactionManager.new_sid()

    resumed_from: Dict[str, int] = {}
    if resume is not None:
        if resume.sid != sid:
            raise ValueError(
                f"resume state is for sid {resume.sid!r}, not {sid!r}"
            )
        if resume.plan_digest != plan.digest():
            # the plan changed under the journal (different budget /
            # selection): staged blocks were computed under the old plan
            # and can never validate against the new one — start fresh
            resume.discard()
            resume = None
        else:
            resumed_from = {
                t: n for t, n in resume.completed.items() if n > 0
            }
            # residual accounting: the skipped logical volume is recorded
            # (never into any C_* term) so tests can assert that crashed +
            # resumed reads cover each selected byte exactly once
            for t, tr in resume.tensors.items():
                if tr.n_validated:
                    stats.record_skip("base", tr.validated_nbytes)
                    stats.record_skip(
                        "expert",
                        resume.skipped_expert_bytes(plan.reverse_index(t), t),
                    )
                    stats.record_skip("out", tr.validated_nbytes)

    if getattr(plan, "layout_id", None):
        raise NotImplementedError("packed-layout execution is not ported yet")
    kernel_ops = None
    if compute == "batched":
        kernel_ops = _torch_kernel_ops(device)
    elif compute == "pipelined":
        # default PipelineConfig is resolved *after* readers are open, so
        # remote-backed readers can deepen the prefetch (see below); an
        # explicit config is validated here, before any txn state exists
        if pipeline is not None:
            pipeline.validate()
        if pipeline is None or pipeline.kernel == "torch":
            kernel_ops = _torch_kernel_ops(device)
    elif compute != "stream":
        raise ValueError(f"unknown compute mode {compute!r}")
    owns_expert_readers = expert_readers is None
    if expert_readers is not None:
        # validate before any transaction/reader state exists
        missing = [e for e in plan.expert_ids if e not in expert_readers]
        if missing:
            raise KeyError(f"injected expert_readers missing {missing}")

    # -- Transaction and staging -----------------------------------------
    if resume is not None:
        writer = txn.begin(resume=resume)
    else:
        writer = txn.begin(sid=sid, plan=plan)
    touch: Dict[str, List[int]] = {}
    coverage_rows: List[Tuple[str, int, str]] = []

    base_reader = snapshots.models.open_model(plan.base_id)
    if expert_readers is None:
        expert_readers = {
            e: snapshots.models.open_model(e) for e in plan.expert_ids
        }
    # layouts serving this merge (owned or injected): extent re-reads they
    # record under memory-cap pressure widen the budget slack below
    merge_layouts = _packed_layouts_behind(expert_readers)
    reread_before = sum(l.reread_bytes for l in merge_layouts)
    # tiered (remote-backed) readers serving this merge: a disk-cache
    # extent evicted between plan and read is honestly re-fetched from
    # remote — those bytes widen the budget slack, mirroring packed
    # extent re-reads under memory-cap pressure
    tiered_readers = _tiered_readers_behind(
        [base_reader, *expert_readers.values()]
    )
    evict_refetch_before = sum(r.evict_refetch_bytes for r in tiered_readers)
    # -- verify-on-read (repro_torch.store.integrity) --------------------------
    # attach a catalog-hash verifier per reader (packed members instead
    # toggle their layout's extent self-check); a disabled policy
    # explicitly detaches, so injected readers reused across windows
    # honor this window's knob
    verify_policy = VerifyPolicy.coerce(verify)
    verifiers = []
    for mid, r in [(plan.base_id, base_reader), *expert_readers.items()]:
        v = attach_verifier(r, catalog, mid, plan.block_size, verify_policy)
        if v is not None:
            verifiers.append(v)
    # read-repair traffic (corrupt cache extents refilled, corrupt packed
    # extents served from flat sources) widens budget slack below — the
    # plan could not have priced corruption in
    repair_before = sum(
        getattr(r, "repair_bytes", 0) for r in tiered_readers
    ) + sum(getattr(l, "repair_bytes", 0) for l in merge_layouts)
    if compute == "pipelined" and pipeline is None:
        pipeline = (
            PipelineConfig.for_remote()
            if any(
                getattr(r, "prefers_deep_prefetch", False)
                for r in tiered_readers
            )
            else PipelineConfig()
        )
    theta = dict(plan.theta)
    seed = int(theta.get("seed", 0))
    is_dare = plan.op.lower() == "dare"

    realized_expert_blocks = 0
    pipe_stats: Optional[Dict] = None
    progress_total = 0
    progress_done = 0
    if progress is not None:
        progress_total = sum(
            blk.num_blocks(base_reader.spec(t).nbytes, plan.block_size)
            for t in plan.tensor_order
        )
    try:
        # -- (1) Stream selected blocks under plan π -----------------------
        _check_cancel(cancel, sid)
        if compute == "pipelined":
            engine = _PipelineEngine(
                plan, writer, base_reader, expert_readers, theta, seed,
                is_dare, pipeline, kernel_ops, coalesce, touch, coverage_rows,
                cancel=cancel, progress=progress,
                progress_total=progress_total,
                resume=resume,
            )
            realized_expert_blocks, pipe_stats = engine.run()
        else:
            for tensor_id in plan.tensor_order:
                _check_cancel(cancel, sid)
                chaos_point("executor:tensor")
                spec = base_reader.spec(tensor_id)
                writer.begin_tensor(tensor_id, spec.shape, spec.dtype)
                rev = plan.reverse_index(tensor_id)
                mergeable = _is_mergeable(spec)
                n_blocks = blk.num_blocks(spec.nbytes, plan.block_size)
                skip = min(resumed_from.get(tensor_id, 0), n_blocks)
                D = DeltaIterator(
                    tensor_id, plan, base_reader, expert_readers,
                    coalesce=coalesce, read_from=skip,
                )
                touched: List[int] = []
                if skip:
                    # lineage already earned by the dead run, re-seeded
                    # straight from the journal — zero I/O
                    for b, experts in resume.coverage(tensor_id):
                        touched.append(b)
                        coverage_rows.append((tensor_id, b, experts))

                if compute == "batched" and mergeable:
                    _run_tensor_batched(
                        kernel_ops, plan, writer, base_reader, D, rev,
                        tensor_id, spec, n_blocks, theta, seed, is_dare,
                        touched, coverage_rows, cancel=cancel, sid=sid,
                        skip=skip,
                    )
                    realized_expert_blocks += sum(
                        len(v) for b, v in rev.items() if b >= skip
                    )
                else:
                    for b in range(skip, n_blocks):
                        _check_cancel(cancel, sid)
                        chaos_point("executor:block")
                        x0 = base_reader.read_block(
                            tensor_id, b, plan.block_size, "base"
                        )
                        experts_csv = None
                        if mergeable and b in rev:
                            deltas, eidxs, eids = D.pull(b, x0)
                            realized_expert_blocks += len(eids)
                            if is_dare and len(eids):
                                theta["_masks"] = dare_mask_batch(
                                    seed, eidxs, tensor_id, b, x0.size,
                                    float(theta.get("density", 0.5)),
                                )
                            x = apply_operator(x0, deltas, plan.op, theta)
                            theta.pop("_masks", None)
                            if len(eids):
                                touched.append(b)
                                experts_csv = ",".join(eids)
                                coverage_rows.append(
                                    (tensor_id, b, experts_csv)
                                )
                        else:
                            x = x0  # base passthrough (no expert selected)
                        writer.write_block(tensor_id, b, x, experts=experts_csv)
                writer.finish_tensor(tensor_id)
                touch[tensor_id] = touched
                if progress is not None:
                    progress_done += n_blocks
                    progress(progress_done, progress_total)

        # -- (2) Validate and atomically publish --------------------------
        if validate:
            writer.validate_hashes()

        realized_expert_bytes = stats.c_expert - expert_read_before
        if enforce_budget and plan.budget_b >= 0:
            # Budget soundness (§5.1): realized <= planned <= B, up to the
            # storage layer's accounting granularity (adapters read factor
            # tensors, which are far below the planned block bytes).
            slack = 2 * plan.block_size
            if merge_layouts:
                # the planner charges each shared extent once; when a
                # max_pinned_bytes cap forced an extent to be re-read for
                # a later consumer, those honestly-recorded bytes are a
                # memory-cap tradeoff, not a plan violation
                slack += (
                    sum(l.reread_bytes for l in merge_layouts) - reread_before
                )
            if tiered_readers:
                # disk-cache extents evicted mid-run are re-fetched from
                # remote at full price — a cache-pressure tradeoff the
                # plan could not have foreseen, not a plan violation
                slack += (
                    sum(r.evict_refetch_bytes for r in tiered_readers)
                    - evict_refetch_before
                )
            if tiered_readers or merge_layouts:
                # read-repair refetches (expert_repair) are honest extra
                # bytes forced by detected corruption, never plannable
                slack += (
                    sum(getattr(r, "repair_bytes", 0) for r in tiered_readers)
                    + sum(getattr(l, "repair_bytes", 0) for l in merge_layouts)
                    - repair_before
                )
            if realized_expert_bytes > plan.c_expert_hat + slack:
                raise RuntimeError(
                    f"budget soundness violated: realized expert bytes "
                    f"{realized_expert_bytes} > planned {plan.c_expert_hat}"
                )

        manifest = {
            "sid": sid,
            "plan_id": plan.plan_id,
            "base_id": plan.base_id,
            "expert_ids": plan.expert_ids,
            "op": plan.op,
            "theta": {k: v for k, v in theta.items() if not k.startswith("_")},
            "budget_b": plan.budget_b,
            "c_expert_hat": plan.c_expert_hat,
            "c_expert_logical_hat": plan.logical_hat,
            "c_expert_run": realized_expert_bytes,
            "plan_digest": plan.digest(),
            "block_size": plan.block_size,
            "layout_id": plan.layout_id,
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
        # lineage is in the catalog — only now is the journal obsolete
        # (a crash since publish replays coverage from it at recovery)
        if writer.journal is not None:
            writer.journal.remove()
        txn.commit()
    except Exception:
        txn.abort()
        raise
    finally:
        base_reader.close()
        if owns_expert_readers:
            for r in expert_readers.values():
                r.close()

    run_stats = {
        "seconds": time.time() - t0,
        "c_expert_run": realized_expert_bytes,
        "c_expert_hat": plan.c_expert_hat,
        "realized_expert_blocks": realized_expert_blocks,
        "compute": compute,
        "coalesce": coalesce,
        "resumed_blocks": sum(resumed_from.values()),
    }
    if verify_policy is not None:
        run_stats["verify"] = {
            "verified_blocks": sum(v.verified_blocks for v in verifiers),
            "repaired_blocks": sum(v.repaired_blocks for v in verifiers),
            "corrupt_blocks": sum(v.corrupt_blocks for v in verifiers),
            "repair_bytes": (
                sum(getattr(r, "repair_bytes", 0) for r in tiered_readers)
                + sum(getattr(l, "repair_bytes", 0) for l in merge_layouts)
                - repair_before
            ),
        }
    if pipe_stats is not None:
        run_stats["pipeline"] = pipe_stats
    return MergeResult(sid, manifest, run_stats)


def _torch_kernel_ops(device):
    """The port's ``kernel_ops``: ``merge_blocks`` bound to one device
    (resolved now, so a missing card fails before any transaction)."""
    from repro_torch.kernels import ops  # lazy: torch import

    return types.SimpleNamespace(
        merge_blocks=functools.partial(
            ops.merge_blocks, device=ops.resolve_device(device)
        )
    )


def _run_tensor_batched(
    kernel_ops,
    plan: MergePlan,
    writer,
    base_reader,
    D: DeltaIterator,
    rev: Dict[int, List[str]],
    tensor_id: str,
    spec,
    n_blocks: int,
    theta: Dict,
    seed: int,
    is_dare: bool,
    touched: List[int],
    coverage_rows: List[Tuple[str, int, str]],
    cancel: Optional[threading.Event] = None,
    sid: str = "",
    skip: int = 0,
) -> None:
    """Batched compute path: group blocks by (K_sel, width) and apply the
    kernel once per group.  Physical I/O identical to the stream
    path; only operator application is vectorized.  ``skip`` is the
    resume high-water mark: blocks below it are already staged and are
    neither read nor written again."""
    # gather the residual blocks first (they stream block-by-block for I/O
    # accounting, then math runs in grouped batches)
    base_blocks: Dict[int, np.ndarray] = {}
    deltas_per_block: Dict[int, Optional[np.ndarray]] = {}
    eidxs_per_block: Dict[int, List[int]] = {}
    experts_per_block: Dict[int, Optional[str]] = {}
    for b in range(skip, n_blocks):
        _check_cancel(cancel, sid)
        chaos_point("executor:block")
        x0 = base_reader.read_block(tensor_id, b, plan.block_size, "base")
        base_blocks[b] = x0
        experts_per_block[b] = None
        if b in rev:
            deltas, eidxs, eids = D.pull(b, x0)
            deltas_per_block[b] = deltas
            eidxs_per_block[b] = eidxs
            if len(eids):
                touched.append(b)
                experts_per_block[b] = ",".join(eids)
                coverage_rows.append((tensor_id, b, experts_per_block[b]))
        else:
            deltas_per_block[b] = None
            eidxs_per_block[b] = []

    out_blocks: Dict[int, np.ndarray] = {}
    groups: Dict[Tuple[int, int], List[int]] = {}
    for b in range(skip, n_blocks):
        d = deltas_per_block[b]
        if d is None or d.shape[0] == 0:
            out_blocks[b] = base_blocks[b]
            continue
        groups.setdefault((d.shape[0], base_blocks[b].size), []).append(b)

    for (k_sel, width), idxs in groups.items():
        x0s = np.stack([base_blocks[b] for b in idxs])
        Ds = np.stack([deltas_per_block[b] for b in idxs])  # (nb, k, w)
        masks = None
        if is_dare:
            masks = np.stack(
                [
                    dare_mask_batch(
                        seed, eidxs_per_block[b], tensor_id, b, width,
                        float(theta.get("density", 0.5)),
                    )
                    for b in idxs
                ]
            )
        # upcast and downcast happen on the device: base blocks travel in
        # their storage dtype and results come back in it
        outs = kernel_ops.merge_blocks(
            plan.op, x0s, Ds, theta, masks=masks, out_dtype=x0s.dtype
        )
        for j, b in enumerate(idxs):
            out_blocks[b] = outs[j]

    for b in range(skip, n_blocks):
        writer.write_block(
            tensor_id, b, out_blocks[b], experts=experts_per_block[b]
        )


# ======================================================================
# Pipelined streaming engine (compute="pipelined")
# ======================================================================

class _TensorTask:
    """Per-tensor state shared between the prefetch and compute stages."""

    __slots__ = ("tensor_id", "spec", "n_blocks", "mergeable", "rev", "D",
                 "touched")

    def __init__(self, tensor_id, spec, n_blocks, mergeable, rev, D):
        self.tensor_id = tensor_id
        self.spec = spec
        self.n_blocks = n_blocks
        self.mergeable = mergeable
        self.rev = rev
        self.D = D
        self.touched: List[int] = []


class _ResidencyGauge:
    """Counts in-flight input block slots (base + expert) across stages —
    the bounded-memory invariant is asserted against its peak."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.current = 0  # guarded-by: _lock
        self.peak = 0  # guarded-by: _lock

    def add(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.current += n
            if self.current > self.peak:
                self.peak = self.current

    def sub(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.current -= n


class _PipelineEngine:
    """Three overlapped stages over bounded queues (Algorithm 2, split):

        prefetch (thread + pool) --> [window queue] --> compute (caller
        thread) --> [write queue] --> write-behind (thread)

    The prefetch stage performs *all* physical input I/O: base blocks and
    the plan-selected expert blocks of each window (via the windowed
    :class:`DeltaIterator` hooks), over thread-safe pread readers.  The
    compute stage pulls deltas from the prefetched window cache (zero
    I/O), groups blocks by (K_sel, width) like the batched path — but
    windowed, so memory stays bounded — and applies the operator
    vectorized.  Finished blocks stream to the
    :class:`~repro_torch.store.snapshot.WriteBehindWriter` so output writes
    overlap the next window's reads and compute.
    """

    _DONE = ("done", None, None, None)

    def __init__(
        self,
        plan: MergePlan,
        writer,
        base_reader,
        expert_readers: Dict[str, object],
        theta: Dict,
        seed: int,
        is_dare: bool,
        cfg: PipelineConfig,
        kernel_ops,
        coalesce: bool,
        touch: Dict[str, List[int]],
        coverage_rows: List[Tuple[str, int, str]],
        cancel: Optional[threading.Event] = None,
        progress: Optional[ProgressFn] = None,
        progress_total: int = 0,
        resume: Optional[ResumeState] = None,
        spans: Optional[Dict[str, Tuple[int, int]]] = None,
    ):
        self.plan = plan
        self.base_reader = base_reader
        self.expert_readers = expert_readers
        self.theta = theta
        self.seed = seed
        self.is_dare = is_dare
        self.cfg = cfg
        self.kernel_ops = kernel_ops  # None => per-block numpy kernel
        self.coalesce = coalesce
        self.touch = touch
        self.coverage_rows = coverage_rows
        self.cancel = cancel
        self.progress = progress
        self.progress_total = progress_total
        self.resume = resume
        # shard-worker mode: restrict the sweep to ``{tensor: (lo, hi)}``
        # half-open block spans.  Block indices stay GLOBAL (DARE masks,
        # coverage, and touch maps must match the single-process run
        # bit-for-bit); tensors absent from the map are skipped entirely.
        self.spans = spans
        self.resumed_from: Dict[str, int] = (
            {t: n for t, n in resume.completed.items() if n > 0}
            if resume is not None else {}
        )
        self.progress_done = sum(self.resumed_from.values())
        self.realized_expert_blocks = 0
        self.gauge = _ResidencyGauge()
        self.windows = 0
        self.wb = WriteBehindWriter(writer, cfg.write_queue_blocks)
        self.pool = ThreadPoolExecutor(
            max_workers=cfg.read_threads, thread_name_prefix="mergepipe-read"
        )
        self.q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch_windows)
        self.stop = threading.Event()

    # ------------------------------------------------------------- stage 1
    def _read_base_window(self, tensor_id: str, window: List[int]) -> Dict:
        if self.coalesce:
            out = self.base_reader.read_blocks_coalesced(
                tensor_id, window, self.plan.block_size, "base",
                gap_bytes=self.cfg.coalesce_gap_bytes,
            )
        else:
            out = {
                b: self.base_reader.read_block(
                    tensor_id, b, self.plan.block_size, "base"
                )
                for b in window
            }
        self.gauge.add(len(window))
        return out

    def _stage_window(self, task: _TensorTask, window: List[int]) -> Tuple:
        """One pool task = the full input side of one window: read the
        base run, read the plan-selected expert blocks, then pull/upcast
        the delta stacks and generate DARE masks — so the compute thread
        receives ready-to-apply inputs and only does operator math.
        Multiple windows stage concurrently on the pool (pread readers
        are offset-explicit, block sets are disjoint)."""
        # prompt failure propagation: a doomed merge (writer thread died)
        # must stop pouring expert reads into staging it will never keep
        self.wb.raise_if_failed()
        chaos_point("executor:prefetch")
        base_blocks = self._read_base_window(task.tensor_id, window)
        pulled: Dict[int, Tuple] = {}
        if task.D is not None:
            for si in range(task.D.n_sources):
                self.gauge.add(task.D.prefetch_source(si, window))
            density = float(self.theta.get("density", 0.5))
            for b in window:
                if b not in task.rev:
                    continue
                deltas, eidxs, eids = task.D.pull(b, base_blocks[b])
                masks = None
                if self.is_dare and eidxs:
                    masks = dare_mask_batch(
                        self.seed, eidxs, task.tensor_id, b,
                        base_blocks[b].size, density,
                    )
                pulled[b] = (deltas, eidxs, eids, masks)
                self.gauge.add(deltas.shape[0])
            # expert cache slots are now materialized into delta stacks
            self.gauge.sub(task.D.release_blocks(window))
        return base_blocks, pulled

    def _produce(self) -> None:
        try:
            # how many windows may be staging on the pool at once, beyond
            # the queued ones (the window queue itself is the main bound)
            lookahead = self.cfg.prefetch_windows + 1
            pending: List[Tuple] = []  # (kind, task, window, future|None)
            outstanding = 0

            def flush_one() -> None:
                nonlocal outstanding
                kind, task, window, fut = pending.pop(0)
                payload = None
                if fut is not None:
                    payload = fut.result()  # propagates staging errors
                    outstanding -= 1
                self._put((kind, task, window, payload))

            for tensor_id in self.plan.tensor_order:
                if self.spans is not None and tensor_id not in self.spans:
                    continue
                spec = self.base_reader.spec(tensor_id)
                n_blocks = blk.num_blocks(spec.nbytes, self.plan.block_size)
                mergeable = _is_mergeable(spec)
                rev = self.plan.reverse_index(tensor_id) if mergeable else {}
                lo, hi = 0, n_blocks
                if self.spans is not None:
                    lo, hi = self.spans[tensor_id]
                    lo, hi = max(0, lo), min(hi, n_blocks)
                skip = min(self.resumed_from.get(tensor_id, 0), n_blocks)
                skip = max(lo, skip)
                D = None
                if mergeable and rev:
                    D = DeltaIterator(
                        tensor_id, self.plan, self.base_reader,
                        self.expert_readers, coalesce=self.coalesce,
                        windowed=True,
                        coalesce_gap=self.cfg.coalesce_gap_bytes,
                        read_from=skip,
                    )
                task = _TensorTask(tensor_id, spec, n_blocks, mergeable, rev, D)
                if skip and self.resume is not None:
                    # lineage from the dead run, re-seeded from the journal
                    for b, experts in self.resume.coverage(tensor_id):
                        task.touched.append(b)
                        self.coverage_rows.append((tensor_id, b, experts))
                pending.append(("tensor", task, None, None))
                W = self.cfg.window_blocks
                for ws in range(skip, hi, W):
                    if self.stop.is_set():
                        return
                    # cancellation checkpoint: stop issuing new windows;
                    # the error propagates to the consumer, whose abort
                    # path discards everything staged so far
                    _check_cancel(self.cancel, self.plan.plan_id)
                    # prompt failure propagation (see _stage_window)
                    self.wb.raise_if_failed()
                    window = list(range(ws, min(hi, ws + W)))
                    pending.append(
                        ("window", task, window,
                         self.pool.submit(self._stage_window, task, window))
                    )
                    outstanding += 1
                    while outstanding > lookahead:
                        flush_one()
            while pending:
                if self.stop.is_set():
                    return
                flush_one()
            self._put(_PipelineEngine._DONE)
        # broad-except-ok: nothing is swallowed — the error (incl.
        # SimulatedCrash) rides the window queue as an ("error", e) item
        # and is re-raised on the consumer thread, preserving the
        # BaseException-invisibility of simulated crashes to abort paths
        except BaseException as e:  # noqa: BLE001
            self._put(("error", e, None, None))

    def _put(self, item) -> None:
        while not self.stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    # ------------------------------------------------------------- stage 2
    def _compute_window(
        self, task: _TensorTask, window: List[int], base_blocks: Dict,
        pulled: Dict[int, Tuple],
    ) -> None:
        chaos_point("executor:window")
        out: Dict[int, np.ndarray] = {}
        retired: Dict[int, int] = {}
        merged: List[int] = []
        experts_csv: Dict[int, str] = {}
        for b in window:
            got = pulled.get(b)
            if got is None:
                out[b] = base_blocks[b]
                retired[b] = 1
                continue
            deltas, eidxs, eids, _masks = got
            self.realized_expert_blocks += len(eids)
            if eids:
                task.touched.append(b)
                experts_csv[b] = ",".join(eids)
                self.coverage_rows.append((task.tensor_id, b, experts_csv[b]))
            retired[b] = 1 + deltas.shape[0]
            if deltas.shape[0] == 0:
                out[b] = base_blocks[b]
            else:
                merged.append(b)

        if self.kernel_ops is None:
            # per-block numpy apply — bit-identical to the stream path and
            # cache-resident (see the PipelineConfig note)
            for b in merged:
                deltas, eidxs, eids, masks = pulled[b]
                if masks is not None:
                    self.theta["_masks"] = masks
                out[b] = apply_operator(
                    base_blocks[b], deltas, self.plan.op, self.theta
                )
                self.theta.pop("_masks", None)
        elif merged:
            # device kernels: group by (K_sel, width) like the batched
            # path — but windowed, so stacks stay bounded
            groups: Dict[Tuple[int, int], List[int]] = {}
            for b in merged:
                k_sel = pulled[b][0].shape[0]
                groups.setdefault((k_sel, base_blocks[b].size), []).append(b)
            for (k_sel, width), idxs in groups.items():
                x0s = np.stack([base_blocks[b] for b in idxs])
                Ds = np.stack([pulled[b][0] for b in idxs])
                masks = None
                if self.is_dare:
                    masks = np.stack([pulled[b][3] for b in idxs])
                outs = self.kernel_ops.merge_blocks(
                    self.plan.op, x0s, Ds, self.theta, masks=masks,
                    out_dtype=x0s.dtype,
                )
                for j, b in enumerate(idxs):
                    out[b] = outs[j]

        for b in window:
            self.wb.write_block(task.tensor_id, b, out[b],
                                experts=experts_csv.get(b))
            self.gauge.sub(retired[b])  # base + delta slots retired
        self.windows += 1
        if self.progress is not None:
            self.progress_done += len(window)
            self.progress(self.progress_done, self.progress_total)

    def _finish_tensor(self, task: _TensorTask) -> None:
        self.wb.finish_tensor(task.tensor_id)
        self.touch[task.tensor_id] = task.touched
        if task.D is not None:
            # all of this tensor's windows are computed by the time its
            # finish marker is consumed — retire the adapter Δ-tensors so
            # the residency gauge balances (and the memory is freed)
            self.gauge.sub(task.D.release_adapters())

    def _consume(self) -> None:
        current: Optional[_TensorTask] = None
        while True:
            kind, a, window, payload = self.q.get()
            if kind == "error":
                raise a
            if kind == "done":
                if current is not None:
                    self._finish_tensor(current)
                return
            if kind == "tensor":
                if current is not None:
                    self._finish_tensor(current)
                chaos_point("executor:tensor")
                current = a
                self.wb.begin_tensor(
                    current.tensor_id, current.spec.shape, current.spec.dtype
                )
                continue
            # consumer-side cancellation checkpoint: a cancel that fires
            # while the producer is already drained still aborts here
            _check_cancel(self.cancel, self.plan.plan_id)
            base_blocks, pulled = payload
            self._compute_window(a, window, base_blocks, pulled)

    # ------------------------------------------------------------ lifecycle
    def run(self) -> Tuple[int, Dict]:
        producer = threading.Thread(
            target=self._produce, name="mergepipe-prefetch", daemon=True
        )
        producer.start()
        ok = False
        try:
            self._consume()
            self.wb.flush()
            ok = True
        finally:
            self.stop.set()
            try:  # unblock a producer stuck on a full window queue
                while True:
                    self.q.get_nowait()
            except queue.Empty:
                pass
            producer.join()
            self.pool.shutdown(wait=True)
            self.wb.close(discard=not ok)
        n_experts = len(self.plan.expert_ids)
        return self.realized_expert_blocks, {
            "windows": self.windows,
            "window_blocks": self.cfg.window_blocks,
            "prefetch_windows": self.cfg.prefetch_windows,
            "read_threads": self.cfg.read_threads,
            "kernel": self.cfg.kernel,
            "coalesce_gap_bytes": self.cfg.coalesce_gap_bytes,
            "peak_resident_blocks": self.gauge.peak,
            "resident_bound": self.cfg.max_resident_blocks(n_experts),
            "peak_write_queue_blocks": self.wb.peak_queued,
            "write_queue_bound": self.cfg.write_queue_blocks,
        }
