"""Session — batched multi-merge planning and execution (API v2).

A :class:`Session` owns one workspace (snapshot store + catalog +
transaction manager) and accepts declarative :class:`~repro_torch.api.spec.MergeSpec`
jobs:

    with Session(workspace) as sess:
        sess.submit(spec_a)
        sess.submit(spec_b)
        results = sess.run_all()

``run_all`` is a compatibility wrapper over the asynchronous
:class:`~repro_torch.api.service.MergeService`: the queued jobs are submitted
to an embedded (inline, unthreaded) service as one atomic scheduling
window and waited on — golden-tested bit-identical, with identical
per-category IOStats, to the former blocking batch barrier.  The window
plans the whole job set together (:func:`repro_torch.core.planner.plan_batch`)
and executes it with a **cross-job read schedule**: every expert model is
opened once behind a :class:`~repro_torch.store.blockcache.CachingModelReader`,
so one physical scan of each selected expert block feeds every job that
selected it.  A J-job sweep over the same K experts thus pays ``O(K)``
expert reads instead of the legacy one-shot path's ``O(K·J)``.

Merge *graphs* (specs whose inputs are themselves specs) execute as a
DAG in depth order; intermediate snapshots are analyzed and fed forward,
and every node records its spec and parent edges in the catalog so
``explain()``/``merge_graph()`` can reconstruct the full lineage.

For an always-on service surface — concurrent tenants, admission
control, budget arbitration, cancellation — construct a
:class:`~repro_torch.api.service.MergeService` directly (docs/SERVICE.md).

I/O accounting is session-scoped: a Session (or MergeService) built
without an explicit ``stats`` gets its **own** :class:`IOStats`, so two
concurrent sessions never cross-pollute counters.  Pass
``stats=GLOBAL_STATS`` to opt into the legacy process-global instance.

Port notes: a Session runs ANALYZE and its merges on ``device`` — the
CUDA card by default, ``"cpu"`` for the kernels' plain versions; asking
for the card where there is none raises.  Sharded execution
(``n_workers``/``dist``) is not ported yet.
"""
from __future__ import annotations

import os
import uuid
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.api.budget import BudgetLike
from repro_torch.api.jobs import JobHandle, JobState
from repro_torch.api.service import MergeService, WindowOptions
from repro_torch.api.spec import MergeSpec
from repro_torch.api.workspace import WorkspaceOps
from repro_torch.core import blocks as blk
from repro_torch.core.catalog import Catalog
from repro_torch.core.executor import MergeResult, PipelineConfig
from repro_torch.core.transactions import TransactionManager
from repro_torch.store.iostats import IOStats
from repro_torch.store.snapshot import SnapshotStore

#: re-exported for backward compatibility (the bound moved to service.py)
from repro_torch.api.service import DEFAULT_CACHE_MAX_BYTES  # noqa: F401


class Session(WorkspaceOps):
    """Workspace-scoped entry point for the declarative v2 API."""

    def __init__(
        self,
        workspace: str,
        block_size: int = blk.DEFAULT_BLOCK_SIZE,
        stats: Optional[IOStats] = None,
        recover: bool = True,
        disk_cache_max_bytes: Optional[int] = None,
        device="cuda",
    ):
        from repro_torch.kernels.ops import resolve_device  # lazy: torch

        #: where ANALYZE's sketch and the merge kernels run
        self.device = resolve_device(device)
        self.workspace = workspace
        self.block_size = block_size
        # session-scoped accounting by default; GLOBAL_STATS is opt-in
        self.stats = stats if stats is not None else IOStats()
        os.makedirs(workspace, exist_ok=True)
        self.snapshots = SnapshotStore(
            workspace, self.stats, disk_cache_max_bytes=disk_cache_max_bytes
        )
        self.catalog = Catalog(os.path.join(workspace, "catalog.sqlite"), self.stats)
        # referential integrity: deleting a model that snapshots' lineage
        # or a packed layout still references needs an explicit force=True
        self.snapshots.models.add_delete_guard(self.catalog.model_references)
        self.txn = TransactionManager(self.snapshots, self.catalog)
        if recover:
            self.txn.recover()
        self._queue: List[JobHandle] = []
        self._svc: Optional[MergeService] = None
        self._closed = False

    @classmethod
    def _from_parts(
        cls,
        snapshots: SnapshotStore,
        catalog: Catalog,
        txn: TransactionManager,
        block_size: int,
        stats: IOStats,
        device="cuda",
    ) -> "Session":
        """Internal: wrap an existing substrate (legacy facade delegation)
        without re-opening stores or re-running recovery."""
        from repro_torch.kernels.ops import resolve_device  # lazy: torch

        sess = cls.__new__(cls)
        sess.device = resolve_device(device)
        sess.workspace = snapshots.workspace
        sess.block_size = block_size
        sess.stats = stats
        sess.snapshots = snapshots
        sess.catalog = catalog
        sess.txn = txn
        sess._queue = []
        sess._svc = None
        sess._closed = False
        return sess

    # ------------------------------------------------------------- service
    def _service(self) -> MergeService:
        """The embedded inline MergeService run_all delegates to: shares
        this session's substrate and stats, runs windows on the calling
        thread (no scheduler thread), and keeps the legacy per-window
        reader lifecycle so I/O accounting is bit-identical."""
        if self._closed:
            raise RuntimeError("Session already closed")
        if self._svc is None:
            self._svc = MergeService._from_parts(
                self.snapshots, self.catalog, self.txn,
                self.block_size, self.stats,
                persistent_cache=False, device=self.device,
            )
        return self._svc

    # ---------------------------------------------------------------- batch
    def submit(
        self, spec: Union[MergeSpec, Dict], sid: Optional[str] = None
    ) -> JobHandle:
        """Queue a merge job (spec object or its dict form) for run_all."""
        if isinstance(spec, dict):
            spec = MergeSpec.from_dict(spec)
        handle = JobHandle(spec, sid=sid)
        self._queue.append(handle)
        return handle

    def run_all(
        self,
        shared_reads: bool = True,
        shared_budget: BudgetLike = None,
        compute: str = "pipelined",
        coalesce: bool = True,
        analyze: bool = True,
        cache_max_bytes: Union[int, None, str] = "auto",
        pipeline: Optional[PipelineConfig] = None,
        prefer_packed: Union[bool, str] = True,
        tier_billing: bool = False,
        verify: Any = True,
        execution: str = "local",
        n_workers: Optional[int] = None,
        dist: Any = None,
    ) -> List[MergeResult]:
        """Plan and execute every queued job, sharing expert block reads.

        Compatibility wrapper (see docs/API.md): submits the queued jobs
        to the embedded :class:`~repro_torch.api.service.MergeService` as one
        atomic scheduling window and waits for all of them — the same
        plan-together/share-reads semantics the blocking barrier had,
        now expressed as submit-all/wait-all.

        ``shared_budget`` optionally pools the *union* expert-read bytes
        of each DAG level (see :func:`repro_torch.core.planner.plan_batch`);
        fractions resolve against the naive cost of the level's distinct
        expert set.  ``cache_max_bytes`` bounds the per-level shared-read
        cache (``"auto"`` = 1 GiB, ``None`` = unbounded); blocks beyond
        the cap stream uncached, trading sharing for bounded memory.

        ``compute`` defaults to the overlapped ``"pipelined"`` engine
        (prefetch → windowed vectorized compute → write-behind,
        bit-identical to ``"stream"``; see docs/EXECUTION.md); ``pipeline``
        optionally tunes its window/queue-depth knobs.

        ``prefer_packed=True`` (default) plans and reads each level from
        the most recent **lossless** packed layout covering all of the
        level's experts, when one exists (see docs/STORAGE.md — elision,
        dedup and compression make the same budget buy strictly more
        selected blocks).  Pass a layout id to force a specific layout
        (including lossy ones — an explicit opt-in), or ``False`` to
        always read flat checkpoints.

        ``tier_billing=True`` bills candidate blocks of remote-backed
        experts at their *tier* cost (RAM free, disk cheap, remote full
        price; see docs/STORAGE.md), so a warm cache buys more blocks
        per budget.  Opt-in because the discounted bill changes block
        selection — outputs can differ from an all-local run of the
        same spec (the default keeps selections, and therefore bytes,
        identical to flat local reads).

        ``verify`` controls block verify-on-read against the catalog's
        content hashes (docs/STORAGE.md): ``True`` (default) verifies
        remote/disk-cache and packed reads with read-repair, ``False``
        disables verification, or pass a
        :class:`~repro_torch.store.integrity.VerifyPolicy` to pick tiers
        (e.g. ``VerifyPolicy(flat=True)`` to also check local flat
        reads).

        ``execution="sharded"``, ``n_workers`` and ``dist`` select the
        JAX package's shard workers (docs/DISTRIBUTED.md), which are not
        ported yet: they raise :class:`NotImplementedError`.
        Returns results in submission order; handles cancelled while
        still queued are dropped from the batch (and from the results).
        """
        queued = list(self._queue)
        # a handle cancelled while still session-queued must never
        # execute: it is dropped from the batch (and from the results)
        jobs = [h for h in queued if h.status not in JobState.TERMINAL]
        if not jobs:
            self._queue = self._queue[len(queued):]
            return []
        svc = self._service()
        if n_workers is not None or dist is not None:
            raise NotImplementedError(
                "sharded execution (shard workers) is not ported yet")
        opts = WindowOptions(
            shared_reads=shared_reads,
            shared_budget=shared_budget,
            compute=compute,
            coalesce=coalesce,
            analyze=analyze,
            cache_max_bytes=cache_max_bytes,
            pipeline=pipeline,
            prefer_packed=prefer_packed,
            tier_billing=tier_billing,
            verify=verify,
            execution=execution,
            dist=dist,
        )
        # one atomic group: the whole batch is a single scheduling window
        # (plan-together semantics, batch-wide sid validation)
        token = "batch-" + uuid.uuid4().hex[:8]
        shandles = [
            svc.submit(h.spec, sid=h.requested_sid, _opts=opts, _group=token)
            for h in jobs
        ]
        svc.drain()

        # a failed/never-run job leaves the session queue intact so the
        # batch can be fixed and rerun (completed named nodes are adopted,
        # not re-executed, on the retry)
        for sh in shandles:
            if sh.status != JobState.DONE:
                sh.wait(0)  # re-raises the recorded error
        results: List[MergeResult] = []
        for handle, sh in zip(jobs, shandles):
            handle._finish(sh.result)
            results.append(sh.result)
        self._queue = self._queue[len(queued):]
        return results

    # ---------------------------------------------------------------- packed
    def repack(
        self,
        model_ids: Sequence[str],
        base_id: str,
        layout_id: Optional[str] = None,
        options: Optional["Any"] = None,
    ) -> Dict:
        """Rewrite checkpoints into a content-addressed packed layout
        (store/packed): cross-model dedup, zero-delta elision, optional
        downcast/compression.  Returns the repack report; subsequent
        ``run``/``run_all`` calls auto-prefer the layout when lossless.
        """
        return self.snapshots.packed.repack(
            base_id,
            list(model_ids),
            self.block_size,
            layout_id=layout_id,
            options=options,
            catalog=self.catalog,
        )

    def list_layouts(self) -> List[str]:
        return self.catalog.list_packed_layouts()

    def _select_layout(
        self,
        prefer_packed: Union[bool, str],
        expert_ids: List[str],
        base_ids: List[str],
    ) -> Optional[str]:
        """Compatibility delegate — layout selection lives on the
        embedded MergeService now."""
        return self._service()._select_layout(
            prefer_packed, expert_ids, base_ids
        )

    # ------------------------------------------------------------- one-shot
    def run(
        self,
        spec: Union[MergeSpec, Dict],
        sid: Optional[str] = None,
        compute: str = "pipelined",
        coalesce: bool = True,
        analyze: bool = True,
        pipeline: Optional[PipelineConfig] = None,
        prefer_packed: Union[bool, str] = True,
    ) -> MergeResult:
        """Submit one spec (possibly a whole merge graph) and execute it."""
        handle = self.submit(spec, sid=sid)
        self.run_all(
            shared_reads=True, compute=compute, coalesce=coalesce,
            analyze=analyze, pipeline=pipeline, prefer_packed=prefer_packed,
        )
        assert handle.result is not None
        return handle.result

    # ------------------------------------------------------------ lifecycle
    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def close(self) -> None:
        """Release the session (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._svc is not None:
            self._svc.close()
            self._svc = None
        self.catalog.close()
