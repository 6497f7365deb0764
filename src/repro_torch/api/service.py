"""MergeService — the asynchronous, continuously-scheduling job API.

The v2 :class:`~repro_torch.api.session.Session` arbitrates the expert-read
budget only inside a single blocking ``run_all()`` barrier: jobs that
arrive after planning starts wait for the whole batch, and nothing
bounds or shares budget across concurrent callers.  ``MergeService``
replaces that barrier with a long-lived scheduler:

* ``submit(spec, tenant=..., priority=..., deadline=...)`` returns a
  future-style :class:`~repro_torch.api.jobs.JobHandle` immediately;
* **admission control** decides *before any parameter I/O* whether a
  job's hard byte demand fits the global + per-tenant budget pool
  (reject or hold queued — never abort mid-execution for budget);
* the scheduler drains arrivals into **rolling scheduling windows**:
  jobs whose expert access sets overlap land in one window, are planned
  together (:func:`repro_torch.core.planner.plan_batch`), and share one
  :class:`~repro_torch.store.blockcache.CachingModelReader` scan and one
  opened packed layout — each selected expert block is physically read
  once per window (and, with the service's persistent cache, once per
  service lifetime);
* a global physical-byte pool is split across tenants by
  **weighted-fair arbitration** (per-tenant group caps in
  ``plan_batch``), with unused budget carried over to later windows;
* ``handle.cancel()`` aborts crash-safely through the transaction
  manager: the executor stops at its next checkpoint, staged output is
  discarded, and the transaction log stays clean — a subsequent
  identical submit commits bit-identically.

``Session.run_all`` is now a thin submit-all/wait-all wrapper over an
embedded (inline, unthreaded) service, golden-tested bit-identical with
identical per-category IOStats.  See docs/SERVICE.md.

Port notes: a service runs ANALYZE and its merges on ``device`` — the
CUDA card by default (the sketch and merge kernels), ``"cpu"`` for their
plain versions; asking for the card where there is none raises.  Sharded
execution belongs to the shard workers, not ported yet, and raises
:class:`NotImplementedError`.
"""
from __future__ import annotations

import os
import threading
import time
import warnings
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from repro_torch.api.budget import BudgetLike, BudgetSpec
from repro_torch.api.jobs import (
    AdmissionRejected,
    DeadlineExceeded,
    JobCancelled,
    JobHandle,
    JobState,
)
from repro_torch.api.spec import MergeSpec
from repro_torch.core import blocks as blk
from repro_torch.core import cost as cost_model
from repro_torch.core.catalog import Catalog
from repro_torch.api.workspace import WorkspaceOps
from repro_torch.core.executor import (
    MergeCancelled,
    MergeResult,
    PipelineConfig,
    execute_merge,
)
from repro_torch.core.plan import MergePlan
from repro_torch.core.planner import BatchJob, plan_batch
from repro_torch.core.transactions import TransactionManager
from repro_torch.store.blockcache import CacheBudget, CachingModelReader
from repro_torch.store.iostats import IOStats
from repro_torch.store.journal import ResumeState
from repro_torch.store.retry import RetryPolicy, is_transient
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.testing.chaos import SimulatedCrash

#: default bound on the shared-read block cache (per window, or service-
#: wide in persistent-cache mode); misses beyond the cap stream uncached
DEFAULT_CACHE_MAX_BYTES = 1 << 30

#: retention bounds for an always-on service: terminal job records and
#: window-log entries beyond these are pruned (the catalog merge_job
#: table keeps the durable history; handles already returned stay valid)
RETAIN_TERMINAL_JOBS = 1024
RETAIN_WINDOW_LOG = 256


class _Node:
    """One DAG node scheduled for execution (deduped by spec_id)."""

    def __init__(self, spec: MergeSpec, sid_hint: Optional[str]):
        self.spec = spec
        self.sid_hint = sid_hint
        self.sid: Optional[str] = None
        self.result: Optional[MergeResult] = None


class _NodeCancel:
    """Composite cancel flag for a shared DAG node: fires only when no
    interested job still wants it (duck-types ``threading.Event.is_set``
    for the executor's checkpoints)."""

    __slots__ = ("_handles",)

    def __init__(self, handles: List[JobHandle]):
        self._handles = handles

    def is_set(self) -> bool:
        return not any(
            h.status not in JobState.TERMINAL and not h.cancel_requested
            for h in self._handles
        )


class WindowOptions:
    """Execution options shared by every job of one scheduling window
    (the former ``Session.run_all`` keyword surface)."""

    def __init__(
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
        verify=True,
        execution: str = "local",
        dist=None,
    ):
        self.shared_reads = shared_reads
        self.shared_budget = shared_budget
        self.compute = compute
        self.coalesce = coalesce
        self.analyze = analyze
        self.cache_max_bytes = (
            DEFAULT_CACHE_MAX_BYTES if cache_max_bytes == "auto" else cache_max_bytes
        )
        self.pipeline = pipeline
        self.prefer_packed = prefer_packed
        #: verify-on-read knob forwarded to execute_merge: True (default)
        #: enforces the block-integrity contract on every tier, a
        #: repro_torch.store.integrity.VerifyPolicy opts tiers out selectively,
        #: False disables (trusted-local benchmarking only)
        self.verify = verify
        # tier-aware planner billing for remote-backed experts: warm-tier
        # blocks bill below full price, so a fixed budget admits more
        # blocks as caches fill.  Opt-in because it intentionally changes
        # block *selection* (better coverage per cold byte) — the default
        # keeps selections identical to the flat local path, which is
        # what bit-identity guarantees rely on.
        self.tier_billing = tier_billing
        #: "local" runs execute_merge in-process; "sharded" (shard workers,
        #: the JAX package's repro.dist) is not ported yet
        if execution not in ("local", "sharded"):
            raise ValueError(
                "execution must be 'local' or 'sharded', got %r" % execution)
        if execution == "sharded" or dist is not None:
            raise NotImplementedError(
                "sharded execution (shard workers) is not ported yet")
        self.execution = execution
        self.dist = dist


#: default cap on executions per job before it is quarantined as poison
DEFAULT_MAX_JOB_ATTEMPTS = 3


class BudgetArbiter:
    """Global + per-tenant physical expert-byte pool (weighted fair).

    ``pool_b=None`` disables enforcement but keeps per-tenant usage
    accounting.  A tenant's share is ``pool * w_t / Σ w``; declare all
    tenants up front (``weights``) for stable shares — an undeclared
    tenant joins lazily at ``default_weight``, which re-divides the pool.
    ``reserve`` holds a hard byte demand from admission until the job's
    window realizes (or releases) it; ``charge`` records planned union
    bytes per tenant, which is exactly the physical I/O a shared-read
    window pays for that tenant (realized <= planned, §5.1).  Unused
    budget is never forfeited: remaining shares carry over to every
    later scheduling window.
    """

    def __init__(
        self,
        pool_b: Optional[int],
        weights: Optional[Mapping[str, float]] = None,
        default_weight: float = 1.0,
    ):
        self.pool_b = pool_b
        self.default_weight = float(default_weight)
        self._weights: Dict[str, float] = {
            t: float(w) for t, w in (weights or {}).items()
        }
        for t, w in self._weights.items():
            if w <= 0:
                raise ValueError(f"tenant {t!r} weight must be > 0, got {w}")
        self._lock = threading.Lock()
        self.spent: Dict[str, int] = {}
        self.reserved: Dict[str, int] = {}
        self.global_spent = 0

    @property
    def enabled(self) -> bool:
        return self.pool_b is not None

    def _ensure(self, tenant: str) -> None:
        if tenant not in self._weights:
            self._weights[tenant] = self.default_weight

    def _share(self, tenant: str) -> Optional[int]:
        if self.pool_b is None:
            return None
        self._ensure(tenant)
        total = sum(self._weights.values())
        return int(self.pool_b * self._weights[tenant] / total)

    def share(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._share(tenant)

    def _remaining(self, tenant: str) -> Optional[int]:
        share = self._share(tenant)
        if share is None:
            return None
        return max(
            0,
            share - self.spent.get(tenant, 0) - self.reserved.get(tenant, 0),
        )

    def remaining(self, tenant: str) -> Optional[int]:
        with self._lock:
            return self._remaining(tenant)

    def global_remaining(self) -> Optional[int]:
        if self.pool_b is None:
            return None
        with self._lock:
            return max(
                0,
                self.pool_b - self.global_spent - sum(self.reserved.values()),
            )

    def try_reserve(self, tenant: str, demand_b: int) -> Tuple[bool, Dict]:
        """Admission check for a hard byte demand; reserves on success.
        Returns (admitted, decision_record)."""
        with self._lock:
            rem_t = self._remaining(tenant)
            rem_g = (
                None
                if self.pool_b is None
                else max(
                    0,
                    self.pool_b
                    - self.global_spent
                    - sum(self.reserved.values()),
                )
            )
            record = {
                "kind": "hard",
                "demand_b": int(demand_b),
                "tenant_remaining_b": rem_t,
                "global_remaining_b": rem_g,
            }
            if rem_t is None:  # pool disabled: everything fits
                record["decision"] = "admit"
                return True, record
            if demand_b <= min(rem_t, rem_g):
                self.reserved[tenant] = self.reserved.get(tenant, 0) + int(
                    demand_b
                )
                record["decision"] = "admit"
                return True, record
            record["decision"] = "reject"
            return False, record

    def release(self, tenant: str, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.reserved[tenant] = max(0, self.reserved.get(tenant, 0) - n)

    def charge(self, tenant: str, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.spent[tenant] = self.spent.get(tenant, 0) + int(n)

    def charge_global(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.global_spent += int(n)

    def refund(self, tenant: str, n: int) -> None:
        """Return previously-charged bytes to a tenant's share — the
        resume path: a re-attempted node is charged its full planned
        union by ``plan_batch`` accounting, but the journaled prefix was
        already paid for by the dead attempt, so crash + resume must
        charge each expert byte once."""
        if n <= 0:
            return
        with self._lock:
            self.spent[tenant] = max(0, self.spent.get(tenant, 0) - int(n))

    def refund_global(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self.global_spent = max(0, self.global_spent - int(n))

    def usage(self) -> Dict:
        with self._lock:
            tenants = sorted(
                set(self._weights) | set(self.spent) | set(self.reserved)
            )
            return {
                "pool_b": self.pool_b,
                "global_spent_b": self.global_spent,
                "tenants": {
                    t: {
                        "weight": self._weights.get(t, self.default_weight),
                        "share_b": self._share(t),
                        "spent_b": self.spent.get(t, 0),
                        "reserved_b": self.reserved.get(t, 0),
                    }
                    for t in tenants
                },
            }


class _Job:
    """Internal scheduler record for one submitted handle."""

    __slots__ = ("handle", "opts", "group", "seq", "reserved_b",
                 "deadline_at", "attempts", "not_before")

    def __init__(self, handle: JobHandle, opts: WindowOptions,
                 group: Optional[str], seq: int, attempts: int = 0):
        self.handle = handle
        self.opts = opts
        self.group = group  # atomic-window token (run_all batches)
        self.seq = seq
        self.reserved_b = 0
        #: executions so far (carried across service restarts via the
        #: catalog row) — the poison-quarantine counter
        self.attempts = int(attempts)
        #: jittered retry backoff: admission skips this job until then
        self.not_before = 0.0
        self.deadline_at: Optional[float] = (
            None
            if handle.deadline is None
            else handle.submitted_at + float(handle.deadline)
        )


class MergeService(WorkspaceOps):
    """Long-lived, thread-backed merge scheduler (see module docstring).

    Standalone construction opens (or joins) a workspace::

        with MergeService("/path/ws", budget="2GiB",
                          tenants={"prod": 3.0, "batch": 1.0}) as svc:
            h = svc.submit(spec, tenant="prod", priority=5)
            result = h.wait()

    ``start=False`` creates an *inline* service: jobs run on the caller
    thread inside :meth:`drain` — this is how ``Session.run_all``
    embeds one (no scheduler thread, no behavior change, bit-identical
    I/O), and how tests make scheduling deterministic.
    """

    def __init__(
        self,
        workspace: str,
        block_size: int = blk.DEFAULT_BLOCK_SIZE,
        stats: Optional[IOStats] = None,
        recover: bool = True,
        budget: BudgetLike = None,
        tenants: Optional[Mapping[str, float]] = None,
        admission: str = "reject",
        shared_reads: bool = True,
        compute: str = "pipelined",
        coalesce: bool = True,
        analyze: bool = True,
        cache_max_bytes: Union[int, None, str] = "auto",
        pipeline: Optional[PipelineConfig] = None,
        prefer_packed: Union[bool, str] = True,
        tier_billing: bool = False,
        persistent_cache: bool = True,
        max_window_jobs: int = 16,
        max_open_readers: int = 64,
        poll_s: float = 0.05,
        start: bool = True,
        disk_cache_max_bytes: Optional[int] = None,
        max_job_attempts: int = DEFAULT_MAX_JOB_ATTEMPTS,
        verify=True,
        scrub_idle_s: Optional[float] = None,
        scrub_rate_mbps: float = 0.0,
        device="cuda",
    ):
        # the card is checked before the workspace is touched
        from repro_torch.kernels.ops import resolve_device  # lazy: torch

        device = resolve_device(device)
        # scoped I/O accounting: a service gets its own IOStats unless
        # the caller opts into a shared (e.g. GLOBAL_STATS) instance
        stats = stats if stats is not None else IOStats()
        os.makedirs(workspace, exist_ok=True)
        snapshots = SnapshotStore(
            workspace, stats, disk_cache_max_bytes=disk_cache_max_bytes
        )
        catalog = Catalog(os.path.join(workspace, "catalog.sqlite"), stats)
        snapshots.models.add_delete_guard(catalog.model_references)
        txn = TransactionManager(snapshots, catalog)
        recovery = txn.recover() if recover else None
        self._init_parts(
            snapshots, catalog, txn, block_size, stats,
            budget=budget, tenants=tenants, admission=admission,
            shared_reads=shared_reads, compute=compute, coalesce=coalesce,
            analyze=analyze, cache_max_bytes=cache_max_bytes,
            pipeline=pipeline, prefer_packed=prefer_packed,
            tier_billing=tier_billing,
            persistent_cache=persistent_cache,
            max_window_jobs=max_window_jobs,
            max_open_readers=max_open_readers, poll_s=poll_s,
            owns_substrate=True,
            max_job_attempts=max_job_attempts,
            verify=verify,
            scrub_idle_s=scrub_idle_s,
            scrub_rate_mbps=scrub_rate_mbps,
            device=device,
        )
        if recovery is not None:
            self._resume_states.update(recovery.get("resumable", {}))
            self._readopt()
        if start:
            self.start()

    @classmethod
    def _from_parts(
        cls,
        snapshots: SnapshotStore,
        catalog: Catalog,
        txn: TransactionManager,
        block_size: int,
        stats: IOStats,
        **opts,
    ) -> "MergeService":
        """Wrap an existing substrate (Session embedding) without
        re-opening stores or re-running recovery."""
        svc = cls.__new__(cls)
        svc._init_parts(
            snapshots, catalog, txn, block_size, stats,
            owns_substrate=False, **opts,
        )
        return svc

    def _init_parts(
        self,
        snapshots: SnapshotStore,
        catalog: Catalog,
        txn: TransactionManager,
        block_size: int,
        stats: IOStats,
        budget: BudgetLike = None,
        tenants: Optional[Mapping[str, float]] = None,
        admission: str = "reject",
        shared_reads: bool = True,
        compute: str = "pipelined",
        coalesce: bool = True,
        analyze: bool = True,
        cache_max_bytes: Union[int, None, str] = "auto",
        pipeline: Optional[PipelineConfig] = None,
        prefer_packed: Union[bool, str] = True,
        tier_billing: bool = False,
        persistent_cache: bool = True,
        max_window_jobs: int = 16,
        max_open_readers: int = 64,
        poll_s: float = 0.05,
        owns_substrate: bool = True,
        max_job_attempts: int = DEFAULT_MAX_JOB_ATTEMPTS,
        verify=True,
        scrub_idle_s: Optional[float] = None,
        scrub_rate_mbps: float = 0.0,
        device="cuda",
    ) -> None:
        from repro_torch.kernels.ops import resolve_device  # lazy: torch

        #: where ANALYZE's sketch and the merge kernels run
        self.device = resolve_device(device)
        self.snapshots = snapshots
        self.catalog = catalog
        self.txn = txn
        self.block_size = block_size
        self.stats = stats
        self.workspace = snapshots.workspace
        self._owns_substrate = owns_substrate

        pool_spec = BudgetSpec.parse(budget)
        if pool_spec.kind == "fraction":
            raise ValueError(
                "the MergeService budget pool needs an absolute size "
                "('2GiB', bytes, ...) — a fraction has no stable reference "
                "set in a continuously-scheduling service"
            )
        if admission not in ("reject", "queue"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.admission = admission
        self.arbiter = BudgetArbiter(pool_spec.resolve(), tenants)
        self.defaults = WindowOptions(
            shared_reads=shared_reads, compute=compute, coalesce=coalesce,
            analyze=analyze, cache_max_bytes=cache_max_bytes,
            pipeline=pipeline, prefer_packed=prefer_packed,
            tier_billing=tier_billing, verify=verify,
        )
        #: idle-time background scrub (mergefsck): when set, an idle
        #: scheduler runs a repairing fsck pass over the workspace every
        #: ``scrub_idle_s`` seconds of quiet — the ZFS-scrub counterpart
        #: to verify-on-read, catching rot in data no merge is touching
        self.scrub_idle_s = scrub_idle_s
        self.scrub_rate_mbps = float(scrub_rate_mbps)
        self._last_scrub = time.monotonic()  # scheduler thread only
        self._scrub_report: Optional[Dict[str, Any]] = None  # guarded-by: _cond
        self.persistent_cache = persistent_cache
        self.max_window_jobs = max(1, int(max_window_jobs))
        self.max_open_readers = max(1, int(max_open_readers))
        self.poll_s = poll_s
        self.max_job_attempts = max(1, int(max_job_attempts))
        #: jittered backoff between retry attempts of transiently-failed
        #: jobs (full jitter; shared with the remote store's retry story)
        self.retry_policy = RetryPolicy(
            attempts=self.max_job_attempts, base_backoff_s=0.01
        )
        #: sid -> validated ResumeState for crashed-but-resumable merges
        #: (from startup recovery, or stashed live after a worker death)
        self._resume_states: Dict[str, ResumeState] = {}

        self._cond = threading.Condition()
        self._pending: List[_Job] = []  # guarded-by: _cond
        self._jobs: Dict[str, _Job] = {}  # guarded-by: _cond
        self._seq = 0  # guarded-by: _cond
        self._window_seq = 0
        self.window_log: List[Dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False

        # persistent shared-read cache: one bounded budget for the whole
        # service; readers/layouts stay open across scheduling windows so
        # overlapping *in-flight* work shares one physical scan
        self._cache_budget = CacheBudget(self.defaults.cache_max_bytes)
        self._readers: Dict[Tuple[Optional[str], str], CachingModelReader] = {}
        self._layouts: Dict[str, Any] = {}

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MergeService":
        """Start the scheduler thread (idempotent)."""
        if self._closed:
            raise RuntimeError("MergeService already closed")
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="mergepipe-scheduler", daemon=True
            )
            self._thread.start()
        return self

    @property
    def started(self) -> bool:
        return self._thread is not None

    def __enter__(self) -> "MergeService":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(cancel_pending=exc_type is not None)

    def close(
        self, cancel_pending: bool = False, timeout: Optional[float] = None
    ) -> None:
        """Stop the service.  By default drains: waits for every
        submitted job to reach a terminal state first.
        ``cancel_pending=True`` instead cancels queued jobs and requests
        cooperative abort of running ones.  Idempotent."""
        if self._closed:
            return
        if cancel_pending:
            with self._cond:
                jobs = list(self._jobs.values())
            for job in jobs:
                job.handle.cancel()
        else:
            try:
                self.drain(timeout=timeout)
            except TimeoutError:
                pass
        # whatever drain could not finish (admission-held jobs, timeout
        # leftovers) is cancelled now: close() never strands a waiter on
        # a handle that can no longer reach a terminal state
        with self._cond:
            jobs = list(self._jobs.values())
        for job in jobs:
            if job.handle.status not in JobState.TERMINAL:
                job.handle.cancel()
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self._closed = True
        for r in self._readers.values():
            r.close()
        self._readers.clear()
        for layout in self._layouts.values():
            layout.close()
        self._layouts.clear()
        if self._owns_substrate:
            self.catalog.close()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                try:
                    busy = self._cycle()
                # broad-except-ok: the scheduler thread must outlive any
                # cycle failure (every live handle is settled with the
                # error); MergeCancelled is settled per-node inside
                # _run_level and cannot reach here, and SimulatedCrash is
                # a BaseException this handler deliberately cannot see
                except Exception as e:
                    with self._cond:
                        jobs = list(self._jobs.values())
                        self._pending.clear()
                    for job in jobs:
                        if job.handle.status not in JobState.TERMINAL:
                            self._fail_handle(job.handle, e)
                    busy = False
                if not busy:
                    self._maybe_scrub()
                    # nothing ran this cycle: any pending jobs are
                    # admission-held — sleep until a submit notifies or
                    # the poll interval re-checks admission (no spin)
                    with self._cond:
                        if not self._stop.is_set():
                            self._cond.wait(timeout=self.poll_s)
                else:
                    # work ran: push the next idle scrub out a full
                    # interval so scrubbing never competes with merges
                    self._last_scrub = time.monotonic()
        finally:
            self.catalog.close()  # this thread's sqlite connection

    # --------------------------------------------------------------- submit
    def submit(
        self,
        spec: Union[MergeSpec, Dict],
        sid: Optional[str] = None,
        tenant: str = "default",
        priority: int = 0,
        deadline: Optional[float] = None,
        job_id: Optional[str] = None,
        _opts: Optional[WindowOptions] = None,
        _group: Optional[str] = None,
        _attempts: int = 0,
    ) -> JobHandle:
        """Submit one merge job; returns immediately with a JobHandle.

        ``tenant`` scopes the job under the budget arbiter's weighted
        shares; ``priority`` (higher first) and ``deadline`` (relative
        seconds; the job fails with :class:`DeadlineExceeded` if no
        window ran it in time) order the scheduling queue.
        """
        if self._closed:
            raise RuntimeError("MergeService already closed")
        if isinstance(spec, dict):
            spec = MergeSpec.from_dict(spec)
        handle = JobHandle(
            spec, sid=sid, tenant=tenant, priority=priority,
            deadline=deadline, job_id=job_id,
        )
        handle.submitted_at = time.time()
        handle._service = self
        handle._set_state(JobState.QUEUED)
        job = _Job(
            handle, _opts or self.defaults, _group, self._next_seq(),
            attempts=_attempts,
        )
        # the spec is persisted at submit (not first execution) so a
        # service restart can re-adopt jobs that never reached a window
        self.catalog.record_spec(
            spec.spec_id, spec.name, spec.op, spec.to_dict()
        )
        self.catalog.record_job(
            handle.job_id, spec.spec_id, tenant, priority, JobState.QUEUED,
            sid=sid or spec.name, deadline=job.deadline_at,
            attempts=_attempts,
        )
        with self._cond:
            self._pending.append(job)
            self._jobs[handle.job_id] = job
            self._cond.notify_all()
        return handle

    def _next_seq(self) -> int:
        with self._cond:
            self._seq += 1
            return self._seq

    # ----------------------------------------------------- restart recovery
    def _readopt(self) -> None:
        """Re-adopt catalog job rows a dead service process left
        non-terminal (queued / admitted / running): each is re-submitted
        under its original job id, tenant, and priority, replaying the
        spec persisted at submit time.  A job whose sid has a validated
        progress journal resumes at its block-level high-water mark; one
        that already burned ``max_job_attempts`` executions is
        quarantined instead of being retried forever."""
        rows: List[Dict] = []
        for state in (JobState.QUEUED, JobState.ADMITTED, JobState.RUNNING):
            rows.extend(self.catalog.list_jobs(state=state))
        for row in rows:
            attempts = int(row.get("attempts") or 0)
            if attempts >= self.max_job_attempts:
                self._quarantine_row(
                    row,
                    f"{attempts} execution(s) died without committing",
                )
                continue
            spec_doc = self.catalog.get_spec(row["spec_id"])
            if spec_doc is None:
                self._quarantine_row(row, "spec payload missing from catalog")
                continue
            deadline = None
            if row.get("deadline") is not None:
                # catalog rows store the absolute instant; submit() takes
                # relative seconds — an already-missed deadline re-enters
                # at zero and fails cleanly at the next admission pass
                deadline = max(0.0, float(row["deadline"]) - time.time())
            self.submit(
                MergeSpec.from_dict(spec_doc["payload"]),
                sid=row.get("sid"),
                tenant=row["tenant"],
                priority=row["priority"],
                deadline=deadline,
                job_id=row["job_id"],
                _attempts=attempts,
            )

    def _quarantine_row(self, row: Dict, why: str) -> None:
        sid = row.get("sid")
        state = self._resume_states.pop(sid, None) if sid else None
        if state is not None:
            state.discard()
        self.catalog.update_job(
            row["job_id"], state=JobState.QUARANTINED,
            error=f"quarantined at restart: {why}",
            finished_at=time.time(),
        )

    # --------------------------------------------------------------- cancel
    def _cancel_job(self, handle: JobHandle) -> bool:
        """JobHandle.cancel() backend: dequeue a queued job immediately,
        flag a running one for cooperative abort."""
        dequeued = None
        with self._cond:
            job = self._jobs.get(handle.job_id)
            if job is not None and job in self._pending:
                self._pending.remove(job)
                dequeued = job
        if dequeued is not None:
            # once off the pending queue the job is exclusively ours —
            # settle it outside _cond: the catalog write is blocking
            # sqlite I/O and must not stall the scheduler lock
            self._settle_reservation(dequeued)
            # row first, handle second (see _fail_handle)
            finished_at = time.time()
            self.catalog.update_job(
                handle.job_id, state=JobState.CANCELLED,
                finished_at=finished_at,
            )
            handle._fail(
                JobCancelled(f"job {handle.job_id} was cancelled"),
                state=JobState.CANCELLED,
                finished_at=finished_at,
            )
            return True
        if handle.status in JobState.TERMINAL:
            return False
        handle._cancel_event.set()
        return True

    def _settle_reservation(self, job: _Job) -> None:
        if job.reserved_b:
            self.arbiter.release(job.handle.tenant, job.reserved_b)
            job.reserved_b = 0

    # ----------------------------------------------------------------- wait
    def wait_all(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted job reaches a terminal state."""
        deadline = None if timeout is None else time.time() + timeout
        with self._cond:
            jobs = list(self._jobs.values())
        for job in jobs:
            left = None if deadline is None else max(0.0, deadline - time.time())
            if not job.handle._terminal.wait(left):
                raise TimeoutError(
                    f"job {job.handle.job_id} still {job.handle.status}"
                )

    def drain(self, timeout: Optional[float] = None) -> None:
        """Run (inline mode) or wait for (threaded mode) the scheduler
        until no submitted job remains non-terminal.  Jobs held back by
        ``admission='queue'`` stay queued — drain does not force them."""
        if self._thread is None:
            while True:
                if self._cycle():
                    continue
                # nothing ran — but a job requeued after a transient
                # crash may just be waiting out its backoff
                delay = self._retry_delay_s()
                if delay is None:
                    return
                time.sleep(delay)
        else:
            deadline = None if timeout is None else time.time() + timeout
            while True:
                with self._cond:
                    jobs = list(self._jobs.values())
                live = [
                    j for j in jobs
                    if j.handle.status not in JobState.TERMINAL
                    and not self._is_parked(j)
                ]
                if not live:
                    return
                if deadline is not None and time.time() > deadline:
                    raise TimeoutError(
                        f"{len(live)} job(s) still live after {timeout}s"
                    )
                live[0].handle._terminal.wait(timeout=self.poll_s)

    def _retry_delay_s(self) -> Optional[float]:
        """Inline mode: seconds until the earliest backed-off retry is
        due, or None when no pending job is waiting on a retry (held or
        terminal jobs don't count — drain never forces those)."""
        now = time.time()
        with self._cond:
            waits = [
                j.not_before - now
                for j in self._pending
                if j.not_before > 0
                and j.handle.status not in JobState.TERMINAL
                and (j.handle.admission or {}).get("decision") != "hold"
            ]
        if not waits:
            return None
        return max(0.0, min(waits)) + 0.001

    def _is_parked(self, job: _Job) -> bool:
        """True for queue-policy jobs admission is still holding back."""
        with self._cond:
            return job in self._pending and (
                job.handle.admission or {}
            ).get("decision") == "hold"

    # ============================================================ scheduler
    def _cycle(self) -> bool:
        """One scheduler iteration: admit, window, execute.  Returns
        True when any window ran."""
        ready = self._admit_and_take()
        if not ready:
            return False
        for window_jobs, opts in self._windows(ready):
            self._run_window(window_jobs, opts)
        self._prune()
        return True

    def _prune(self) -> None:
        """Bound in-memory retention (always-on services): drop the
        oldest terminal job records beyond RETAIN_TERMINAL_JOBS and trim
        the window log.  The catalog's merge_job table keeps the durable
        history; caller-held handles are unaffected."""
        with self._cond:
            terminal = [
                jid for jid, job in self._jobs.items()
                if job.handle.status in JobState.TERMINAL
            ]
            for jid in terminal[:max(0, len(terminal) - RETAIN_TERMINAL_JOBS)]:
                del self._jobs[jid]
        if len(self.window_log) > RETAIN_WINDOW_LOG:
            del self.window_log[:len(self.window_log) - RETAIN_WINDOW_LOG]

    # ---------------------------------------------------------- admission
    def _hard_demand_b(self, spec: MergeSpec) -> Optional[int]:
        """A job's *hard* byte demand: the sum of absolute byte budgets
        across its spec graph.  Fraction/unbounded budgets are elastic —
        the window planner scales them into whatever share arbitration
        grants — so they carry no admission demand."""
        total = 0
        seen = False
        for node in spec.walk():
            if node.budget.kind == "bytes":
                total += int(node.budget.value)
                seen = True
        return total if seen else None

    def _admit_and_take(self) -> List[_Job]:
        """Admission control over the queued jobs; returns those cleared
        for scheduling (removed from the pending queue)."""
        taken: List[_Job] = []
        #: jobs settled terminal by admission this cycle; their handle
        #: _fail + catalog row land after _cond is released — the
        #: catalog write is blocking sqlite I/O and submit()/cancel()
        #: must not stall on the scheduler lock behind it
        settled: List[Tuple[_Job, BaseException, str, Optional[Dict]]] = []
        now = time.time()
        with self._cond:
            still_pending: List[_Job] = []
            for job in self._pending:
                handle = job.handle
                if handle.status in JobState.TERMINAL:
                    continue  # cancelled while queued
                if job.deadline_at is not None and now > job.deadline_at:
                    settled.append((job, DeadlineExceeded(
                        f"job {handle.job_id} missed its deadline before "
                        f"a scheduling window could run it"
                    ), JobState.FAILED, None))
                    continue
                if job.not_before > now:
                    # requeued after a transient crash: still waiting out
                    # its jittered backoff
                    still_pending.append(job)
                    continue
                demand = self._hard_demand_b(handle.spec)
                if not self.arbiter.enabled:
                    handle.admission = {"decision": "admit", "kind": "elastic"}
                elif demand is None:
                    # elastic demands scale into the tenant's remaining
                    # share — but an exhausted pool must reject (or hold)
                    # them here, not plan them down to a degenerate
                    # zero-budget merge that commits "successfully".
                    # "Exhausted" means less than one block left: the
                    # planner could not select anything with it.
                    rem_t = self.arbiter.remaining(handle.tenant)
                    rem_g = self.arbiter.global_remaining()
                    record = {
                        "kind": "elastic",
                        "tenant_remaining_b": rem_t,
                        "global_remaining_b": rem_g,
                    }
                    if min(rem_t, rem_g) < self.block_size:
                        if self.admission == "queue":
                            record["decision"] = "hold"
                            handle.admission = record
                            still_pending.append(job)
                            continue
                        record["decision"] = "reject"
                        handle.admission = record
                        settled.append((job, AdmissionRejected(
                            f"job {handle.job_id} is elastic but tenant "
                            f"{handle.tenant!r} has no budget pool left"
                        ), JobState.REJECTED, record))
                        continue
                    record["decision"] = "admit"
                    handle.admission = record
                else:
                    ok, record = self.arbiter.try_reserve(
                        handle.tenant, demand
                    )
                    if ok:
                        job.reserved_b = demand
                        handle.admission = record
                    elif self.admission == "queue":
                        record["decision"] = "hold"
                        handle.admission = record
                        still_pending.append(job)
                        continue
                    else:
                        handle.admission = record
                        settled.append((job, AdmissionRejected(
                            f"job {handle.job_id} demands "
                            f"{demand} expert bytes but tenant "
                            f"{handle.tenant!r} has "
                            f"{record['tenant_remaining_b']} of the "
                            f"pool left"
                        ), JobState.REJECTED, record))
                        continue
                # the transient ADMITTED state lives on the handle only;
                # the catalog records admission with the terminal row
                # (one less commit per job on the batch path)
                handle._set_state(JobState.ADMITTED)
                taken.append(job)
            self._pending = still_pending
        for job, error, state, record in settled:
            handle = job.handle
            self._settle_reservation(job)
            handle._fail(error, state=state)
            if state == JobState.REJECTED:
                self.catalog.update_job(
                    handle.job_id, state=state, admission=record,
                    finished_at=handle.finished_at,
                )
            else:
                self.catalog.update_job(
                    handle.job_id, state=state,
                    error="deadline exceeded",
                    finished_at=handle.finished_at,
                )
        return taken

    # ---------------------------------------------------------- windowing
    def _access_keys(self, job: _Job) -> List[str]:
        """Grouping keys: the job's leaf expert access set plus its
        target snapshot ids (so sid conflicts meet in one window and are
        rejected by validation, like the old batch barrier)."""
        keys: List[str] = []
        for node in job.handle.spec.walk():
            for e in node.experts:
                if isinstance(e, str):
                    keys.append(f"m:{e}")
            if node.name:
                keys.append(f"s:{node.name}")
        if job.handle.requested_sid:
            keys.append(f"s:{job.handle.requested_sid}")
        return keys

    def _windows(
        self, ready: List[_Job]
    ) -> List[Tuple[List[_Job], WindowOptions]]:
        """Partition admitted jobs into scheduling windows.

        Jobs submitted as one atomic group (``run_all`` batches) form
        exactly one window.  Remaining jobs are grouped by overlap of
        their expert access sets (union-find): overlapping jobs share a
        window — hence one CachingModelReader scan — while disjoint jobs
        roll into separate windows.  Jobs only share a window when their
        execution options object is the same."""
        explicit: Dict[str, List[_Job]] = {}
        rest: List[_Job] = []
        for job in ready:
            if job.group is not None:
                explicit.setdefault(job.group, []).append(job)
            else:
                rest.append(job)

        # (window, atomic): atomic groups (run_all batches) must stay one
        # window whatever their size — chunking would fragment the joint
        # plan, the pooled budget, and batch-wide sid validation
        windows: List[Tuple[List[_Job], bool]] = [
            (sorted(jobs, key=lambda j: j.seq), True)
            for jobs in explicit.values()
        ]

        # union-find over access keys, partitioned by options identity
        by_opts: Dict[int, List[_Job]] = {}
        for job in rest:
            by_opts.setdefault(id(job.opts), []).append(job)
        for bucket in by_opts.values():
            parent: Dict[str, str] = {}

            def find(x: str) -> str:
                while parent.setdefault(x, x) != x:
                    parent[x] = parent[parent[x]]
                    x = parent[x]
                return x

            def union(a: str, b: str) -> None:
                parent[find(a)] = find(b)

            roots: Dict[int, str] = {}
            for job in bucket:
                keys = self._access_keys(job) or [f"j:{job.handle.job_id}"]
                for k in keys[1:]:
                    union(keys[0], k)
                roots[job.seq] = keys[0]
            comps: Dict[str, List[_Job]] = {}
            for job in bucket:
                comps.setdefault(find(roots[job.seq]), []).append(job)
            windows.extend(
                (sorted(c, key=lambda j: j.seq), False)
                for c in comps.values()
            )

        # higher priority windows first; earliest-deadline, then arrival
        def job_key(j: _Job):
            return (-j.handle.priority,
                    j.deadline_at if j.deadline_at is not None else float("inf"),
                    j.seq)

        out: List[Tuple[List[_Job], WindowOptions]] = []
        for w, atomic in sorted(
            windows, key=lambda w: min(job_key(j) for j in w[0])
        ):
            w = sorted(w, key=job_key)
            if atomic:
                out.append((w, w[0].opts))
                continue
            for i in range(0, len(w), self.max_window_jobs):
                chunk = w[i:i + self.max_window_jobs]
                out.append((chunk, chunk[0].opts))
        return out

    # ===================================================== window execution
    def _run_window(self, wjobs: List[_Job], opts: WindowOptions) -> None:
        """Execute one scheduling window: the former ``run_all`` batch
        body (DAG expansion, sid validation/adoption, level-ordered
        planning + shared-read execution) extended with budget
        arbitration, cooperative cancellation, and progress events."""
        wjobs = [j for j in wjobs if j.handle.status not in JobState.TERMINAL]
        # admission re-check at window time: windows earlier in this same
        # scheduler cycle may have drained the pool since _admit_and_take
        # cleared these jobs — an elastic job whose share is now below one
        # block must reject here, not plan down to a degenerate zero-
        # budget merge (hard demands hold their reservation, so they keep
        # their headroom by construction)
        if self.arbiter.enabled:
            still: List[_Job] = []
            for job in wjobs:
                handle = job.handle
                if job.reserved_b == 0 and self._hard_demand_b(handle.spec) is None:
                    rem = min(
                        self.arbiter.remaining(handle.tenant),
                        self.arbiter.global_remaining(),
                    )
                    if rem < self.block_size:
                        record = dict(handle.admission or {})
                        record.update(
                            decision="reject", kind="elastic",
                            tenant_remaining_b=self.arbiter.remaining(
                                handle.tenant
                            ),
                        )
                        handle.admission = record
                        handle._fail(
                            AdmissionRejected(
                                f"job {handle.job_id}: tenant "
                                f"{handle.tenant!r} exhausted its budget "
                                f"pool before this scheduling window"
                            ),
                            state=JobState.REJECTED,
                        )
                        self.catalog.update_job(
                            handle.job_id, state=JobState.REJECTED,
                            admission=record,
                            finished_at=handle.finished_at,
                        )
                        continue
                still.append(job)
            wjobs = still
        if not wjobs:
            return
        self._window_seq += 1
        window_id = f"win-{self._window_seq:06d}"
        running_updates = []
        for job in wjobs:
            # this window realizes (or forfeits) any admission hold
            self._settle_reservation(job)
            job.attempts += 1
            job.handle.window_id = window_id
            job.handle._set_state(JobState.RUNNING)
            running_updates.append((
                job.handle.job_id,
                {"state": JobState.RUNNING, "window_id": window_id,
                 "attempts": job.attempts},
            ))
        self.catalog.update_jobs(running_updates)

        # -- 1. expand spec DAGs, dedupe shared subgraphs by content ------
        nodes: Dict[str, _Node] = {}
        alias_roots: List[_Node] = []
        job_nodes: Dict[str, _Node] = {}
        interested: Dict[int, List[JobHandle]] = {}
        for job in wjobs:
            handle = job.handle
            walked: List[_Node] = []
            for spec in handle.spec.walk():
                node = nodes.get(spec.spec_id)
                if node is None:
                    nodes[spec.spec_id] = node = _Node(spec, spec.name)
                walked.append(node)
            root = nodes[handle.spec.spec_id]
            if handle.requested_sid:
                if root.sid_hint and root.sid_hint != handle.requested_sid:
                    # same content already claimed under another sid: the
                    # user asked for a distinct snapshot — execute again
                    # under its own name (children still dedupe).
                    root = _Node(handle.spec, handle.requested_sid)
                    alias_roots.append(root)
                    walked[-1] = root
                else:
                    root.sid_hint = handle.requested_sid
            job_nodes[handle.job_id] = root
            for node in walked:
                interested.setdefault(id(node), []).append(handle)

        all_nodes = [*nodes.values(), *alias_roots]
        try:
            self._validate_sids(all_nodes, opts)
        except ValueError as e:
            self._fail_window(wjobs, e)
            return

        # -- 3. execute level by level (children before parents) ----------
        by_level: Dict[int, List[_Node]] = {}
        for node in all_nodes:
            if node.result is None:  # adopted snapshots skip execution
                by_level.setdefault(node.spec.depth(), []).append(node)
        dead: Dict[int, BaseException] = {}
        window_stats: Dict[str, Any] = {}
        try:
            for level in sorted(by_level):
                window_stats = self._run_level(
                    by_level[level], nodes, opts, interested, dead,
                )
        # broad-except-ok: level-infrastructure failure (per-node errors,
        # incl. MergeCancelled, are contained inside _run_level); every
        # unresolved handle in the window is settled with the error, and
        # SimulatedCrash stays invisible to this handler by design
        except Exception as e:
            self._fail_window(wjobs, e)
            return
        finally:
            self.window_log.append({
                "window_id": window_id,
                "jobs": [j.handle.job_id for j in wjobs],
                "tenants": sorted({j.handle.tenant for j in wjobs}),
                "stats": window_stats,
            })

        # -- 4. resolve handles -------------------------------------------
        done_updates = []
        finishes: List[Tuple[JobHandle, _Node]] = []
        finished_at = time.time()
        for job in wjobs:
            handle = job.handle
            if handle.status in JobState.TERMINAL:
                continue  # cancelled/failed during level execution
            if handle.status == JobState.QUEUED:
                continue  # requeued for a later attempt (transient crash)
            if handle.cancel_requested:
                # the node may still have completed for OTHER jobs that
                # dedupe to it — this handle's cancel() contract holds
                # regardless: wait() raises, status is cancelled
                self._fail_handle(
                    handle,
                    JobCancelled(f"job {handle.job_id} was cancelled"),
                )
                continue
            node = job_nodes[handle.job_id]
            if node.result is not None:
                finishes.append((handle, node))
                done_updates.append((
                    handle.job_id,
                    {"state": JobState.DONE, "sid": node.sid,
                     "admission": handle.admission,
                     "finished_at": finished_at},
                ))
            else:
                err = dead.get(id(node)) or RuntimeError(
                    f"node {node.spec.spec_id} did not execute"
                )
                self._fail_handle(handle, err)
        # rows committed (one batch) before any waiter is woken — same
        # ordering contract as _fail_handle
        self.catalog.update_jobs(done_updates)
        for handle, node in finishes:
            handle._finish(node.result, finished_at=finished_at)

    def _fail_window(self, wjobs: List[_Job], error: BaseException) -> None:
        for job in wjobs:
            if job.handle.status not in JobState.TERMINAL:
                self._fail_handle(job.handle, error)

    def _fail_handle(self, handle: JobHandle, error: BaseException) -> None:
        cancelled = isinstance(error, (MergeCancelled, JobCancelled))
        state = JobState.CANCELLED if cancelled else JobState.FAILED
        # catalog row BEFORE waking the waiter: a thread returning from
        # wait() must find the terminal row already committed, or it can
        # observe status==CANCELLED while the row still says running
        finished_at = time.time()
        self.catalog.update_job(
            handle.job_id, state=state, error=str(error),
            finished_at=finished_at,
        )
        handle._fail(
            error if not cancelled or isinstance(error, JobCancelled)
            else JobCancelled(str(error)),
            state=state,
            finished_at=finished_at,
        )

    def _requeue_or_quarantine(
        self,
        node: _Node,
        handles: List[JobHandle],
        error: BaseException,
        dead: Dict[int, BaseException],
    ) -> None:
        """After a transient worker death: send each surviving job back
        to the scheduling queue with jittered backoff, or move it to the
        terminal ``quarantined`` state once it has burned
        ``max_job_attempts`` executions (poison work that keeps killing
        workers must not be retried forever)."""
        updates: List[Tuple[str, Dict[str, Any]]] = []
        requeued = 0
        now = time.time()
        for h in handles:
            if h.status in JobState.TERMINAL or h.cancel_requested:
                continue
            with self._cond:
                job = self._jobs.get(h.job_id)
            if job is None or job.attempts >= self.max_job_attempts:
                quarantine_err = RuntimeError(
                    f"job {h.job_id} quarantined after "
                    f"{job.attempts if job else '?'} execution(s) died: "
                    f"{error}"
                )
                # chain the final attempt's failure so callers can
                # introspect the typed cause (e.g. CorruptBlockError
                # provenance after an unrepairable-source merge)
                quarantine_err.__cause__ = error
                updates.append((h.job_id, {
                    "state": JobState.QUARANTINED,
                    "error": str(quarantine_err),
                    "finished_at": now,
                }))
                h._fail(
                    quarantine_err, state=JobState.QUARANTINED,
                    finished_at=now,
                )
                continue
            job.not_before = now + self.retry_policy.backoff_s(
                job.attempts - 1
            )
            h._set_state(JobState.QUEUED)
            updates.append((h.job_id, {
                "state": JobState.QUEUED, "error": str(error),
            }))
            with self._cond:
                if job not in self._pending:
                    self._pending.append(job)
                self._cond.notify_all()
            requeued += 1
        self.catalog.update_jobs(updates)
        if not requeued:
            # nobody left to retry this node: dependents must fail too
            dead[id(node)] = (
                error if isinstance(error, Exception)
                else RuntimeError(str(error))
            )

    # ----------------------------------------------------- sid validation
    def _validate_sids(
        self, all_nodes: List[_Node], opts: WindowOptions
    ) -> None:
        """Validate target snapshot ids before any work; adopt committed
        snapshots produced by the exact same spec (incremental graph
        composition across windows)."""
        claimed: Dict[str, _Node] = {}
        for node in all_nodes:
            hint = node.sid_hint
            if not hint:
                continue
            other = claimed.get(hint)
            if other is not None and other is not node:
                raise ValueError(
                    f"two different merge jobs target snapshot id {hint!r} "
                    f"(specs {other.spec.spec_id} and {node.spec.spec_id})"
                )
            claimed[hint] = node
            if self.snapshots.is_published(hint):
                man = self.catalog.get_manifest(hint)
                plan = (
                    self.catalog.get_plan(man["plan_id"]) if man else None
                )
                committed_spec = (plan or {}).get("payload", {}).get("spec_id")
                if committed_spec == node.spec.spec_id:
                    node.sid = hint
                    # stats keep the executor's standard shape so legacy
                    # callers reading seconds/plan/etc. keep working
                    node.result = MergeResult(
                        hint, man,
                        {"seconds": 0.0, "c_expert_run": 0,
                         "c_expert_hat": (plan or {}).get("c_expert_hat", 0),
                         "realized_expert_blocks": 0,
                         "compute": opts.compute, "coalesce": opts.coalesce,
                         "reused_snapshot": True,
                         "plan": {"reused": True, "plan_seconds": 0.0}},
                    )
                    continue
                raise ValueError(
                    f"snapshot {hint!r} already published in this workspace "
                    f"by a different spec; pick a fresh sid/name"
                )

    # ------------------------------------------------------------- levels
    def _resolve_input(
        self, inp: Union[str, MergeSpec], nodes: Dict[str, _Node]
    ) -> str:
        if isinstance(inp, MergeSpec):
            sid = nodes[inp.spec_id].sid
            if sid is None:
                raise RuntimeError(
                    f"child spec {inp.spec_id} not yet executed (cycle?)"
                )
            return sid
        return inp

    def _node_alive(self, node: _Node, interested: Dict[int, List[JobHandle]]) -> bool:
        handles = interested.get(id(node), [])
        return any(
            h.status not in JobState.TERMINAL and not h.cancel_requested
            for h in handles
        )

    def _run_level(
        self,
        level_nodes: List[_Node],
        nodes: Dict[str, _Node],
        opts: WindowOptions,
        interested: Dict[int, List[JobHandle]],
        dead: Dict[int, BaseException],
    ) -> Dict:
        # deterministic order: by spec content digest, then requested sid
        # (identical specs executing under distinct names)
        level_nodes = sorted(
            level_nodes, key=lambda n: (n.spec.spec_id, n.sid_hint or "")
        )

        # drop nodes nobody wants anymore: every interested job already
        # terminal or cancel-requested (queued-cancel), or an input died
        live_nodes: List[_Node] = []
        for node in level_nodes:
            handles_n = interested.get(id(node), [])
            if handles_n and all(
                h.status == JobState.QUEUED for h in handles_n
            ):
                # every consumer was requeued (transient crash earlier in
                # this window) — skip quietly; a later attempt re-runs it
                continue
            dead_child = next(
                (
                    c for c in node.spec.children()
                    if id(nodes[c.spec_id]) in dead
                ),
                None,
            )
            if dead_child is not None:
                err = dead[id(nodes[dead_child.spec_id])]
                dead[id(node)] = err
                for h in interested.get(id(node), []):
                    if h.status not in JobState.TERMINAL:
                        self._fail_handle(h, err)
                continue
            if not self._node_alive(node, interested):
                err = MergeCancelled(
                    f"merge {node.sid_hint or node.spec.spec_id} cancelled "
                    f"before execution"
                )
                dead[id(node)] = err
                for h in interested.get(id(node), []):
                    if h.status not in JobState.TERMINAL:
                        self._fail_handle(h, err)
                continue
            live_nodes.append(node)
        level_nodes = live_nodes
        if not level_nodes:
            return {}

        pool_spec = (
            BudgetSpec.parse(opts.shared_budget)
            if opts.shared_budget is not None else None
        )
        pool_is_fraction = pool_spec is not None and pool_spec.kind == "fraction"

        resolved: List[Dict[str, Any]] = []
        for node in level_nodes:
            spec = node.spec
            base_id = self._resolve_input(spec.base, nodes)
            expert_ids = [self._resolve_input(e, nodes) for e in spec.experts]
            if opts.analyze:
                self.ensure_analyzed(base_id, expert_ids)
            resolved.append({"base_id": base_id, "expert_ids": expert_ids})

        # -- packed physical layout (auto-prefer / forced) -----------------
        # one layout per level: it must cover every expert the level reads
        # so the shared readers and the planner cost the same bytes.
        level_experts = sorted({e for r in resolved for e in r["expert_ids"]})
        layout_id = self._select_layout(
            opts.prefer_packed, level_experts, [r["base_id"] for r in resolved]
        )

        # arbitration group per node: the sorted set of tenants whose jobs
        # consume it.  A deduped node shared across tenants is capped by
        # their combined remaining shares and billed to them in equal
        # parts — never in full to whichever handle sorted first.
        node_tenants: Dict[int, Tuple[str, ...]] = {
            id(n): tuple(sorted({
                h.tenant for h in interested[id(n)]
            }))
            for n in level_nodes
        }
        batch_jobs: List[BatchJob] = []
        for node, res in zip(level_nodes, resolved):
            spec = node.spec
            base_id = res["base_id"]
            expert_ids = res["expert_ids"]
            # merge-graph lineage: any input that is itself a committed
            # merge snapshot becomes a DAG edge of this node.
            parent_sids = [
                i
                for i in [base_id, *expert_ids]
                if self.catalog.get_manifest(i) is not None
            ]
            self.catalog.record_spec(
                spec.spec_id, spec.name, spec.op, spec.to_dict()
            )
            naive = None
            if spec.budget.kind == "fraction":
                naive = cost_model.naive_expert_cost(self.catalog, expert_ids)
            budget_b = spec.budget.resolve(naive)
            batch_jobs.append(
                BatchJob(
                    base_id=base_id,
                    expert_ids=expert_ids,
                    op=spec.op,
                    theta=spec.theta,
                    budget_b=budget_b,
                    conflict_aware=spec.conflict_aware,
                    reuse=spec.reuse_plan,
                    spec_id=spec.spec_id,
                    parent_sids=parent_sids,
                    layout_id=layout_id,
                    group="\x1f".join(node_tenants[id(node)]),
                )
            )

        pool_b = None
        if pool_spec is not None:
            # The pool caps the level's UNION read schedule, so a
            # fractional pool resolves against the naive cost of the
            # level's distinct expert set — not the per-job sum.
            naive_union = None
            if pool_is_fraction:
                distinct = sorted({e for r in resolved for e in r["expert_ids"]})
                naive_union = cost_model.naive_expert_cost(self.catalog, distinct)
            pool_b = pool_spec.resolve(naive_union)
        # the service's global budget pool caps the same union; whatever
        # earlier windows left unspent carries over automatically
        group_budgets: Optional[Dict[str, Optional[int]]] = None
        if self.arbiter.enabled:
            arb_remaining = self.arbiter.global_remaining()
            pool_b = (
                arb_remaining if pool_b is None else min(pool_b, arb_remaining)
            )
            # a tenant's remaining share is granted ONCE per level: when
            # it appears in several groups (own nodes + deduped shared
            # nodes), the share is divided across them.  A shared group's
            # cap is n·min(member grants): its union is billed in equal
            # parts, so each member's bill union/n stays within its own
            # grant — a generous co-tenant can never subsidize a tenant
            # past its weighted-fair share.
            groups = set(node_tenants.values())
            appearances: Dict[str, int] = {}
            for tenants in groups:
                for t in tenants:
                    appearances[t] = appearances.get(t, 0) + 1
            group_budgets = {}
            for tenants in groups:
                grants = [
                    self.arbiter.remaining(t) // appearances[t]
                    for t in tenants
                ]
                group_budgets["\x1f".join(tenants)] = (
                    len(tenants) * min(grants)
                )

        # tier-aware billing: when any expert of this level is served from
        # a remote object store, bill candidates by the tier that would
        # serve them now (RAM free / disk cheap / remote full) so a fixed
        # budget admits more blocks as the shared warm tiers fill up
        tier_probe = None
        if opts.tier_billing and any(
            self.snapshots.models.is_remote(e) for e in level_experts
        ):
            from repro_torch.store.tiered import make_tier_probe

            ram_readers = {
                m: r
                for (lid, m), r in self._readers.items()
                if lid is None and m in level_experts
            }
            tier_probe = make_tier_probe(
                self.snapshots.models,
                self.block_size,
                ram_readers=ram_readers,
            )

        bp = plan_batch(
            self.catalog,
            batch_jobs,
            block_size=self.block_size,
            shared_budget_b=pool_b,
            group_budgets=group_budgets,
            tier_probe=tier_probe,
        )
        # weighted-fair accounting: each tenant group is charged the
        # physical union of its own nodes' selections (what a shared-read
        # window pays on its behalf), split equally when a deduped node
        # serves several tenants; the global pool is charged the window
        # union once.  Realized I/O never exceeds planned (§5.1), so
        # charging the plan keeps the pool sound.
        for g, ub in bp.stats.get("group_union_bytes", {}).items():
            tenants = g.split("\x1f")
            each = ub // len(tenants)
            for i, t in enumerate(tenants):
                self.arbiter.charge(
                    t, ub - each * (len(tenants) - 1) if i == 0 else each
                )
        self.arbiter.charge_global(bp.stats.get("c_expert_hat_union", 0))

        # -- shared expert readers: one open (cached) reader per model ----
        expert_readers = None
        cache_readers: Dict[str, CachingModelReader] = {}
        owned_readers: Dict[str, CachingModelReader] = {}
        cache_before = (0, 0, 0)
        owned_layout = None
        if self.persistent_cache and opts.shared_reads:
            cache_readers = self._shared_readers(layout_id, level_experts)
            expert_readers = cache_readers
            cache_before = self._cache_counters(cache_readers)
        elif opts.shared_reads and len(level_nodes) > 1:
            # one byte budget for the whole level: the cap bounds the
            # combined footprint across all expert readers
            cache_budget = CacheBudget(opts.cache_max_bytes)
            if layout_id is not None:
                # cross-job sharing composes with the packed layout: one
                # opened layout dedups extents across jobs, and the block
                # cache fans decoded blocks out to later jobs
                owned_layout = self.snapshots.packed.open_layout(layout_id)
                open_one = owned_layout.open_member
            else:
                open_one = self.snapshots.models.open_model
            cache_readers = owned_readers = {
                e: CachingModelReader(
                    open_one(e), budget=cache_budget, stats=self.stats
                )
                for e in level_experts
            }
            expert_readers = cache_readers

        try:
            for node, pr in zip(level_nodes, bp.results):
                handles = interested.get(id(node), [])
                cancel = _NodeCancel(handles) if handles else None
                # pin the executing sid before any I/O: a crash mid-merge
                # (or a service restart) can only find the progress
                # journal again if the snapshot id is stable and recorded
                # on the job rows, so generate it here instead of letting
                # the executor pick one
                exec_sid = node.sid_hint or TransactionManager.new_sid()
                if node.sid_hint is None and handles:
                    self.catalog.update_jobs(
                        [(h.job_id, {"sid": exec_sid}) for h in handles]
                    )
                plan = pr.plan
                resume = self._resume_states.pop(exec_sid, None)
                if resume is not None:
                    # re-planning under today's arbitration could shift
                    # the block selection and invalidate the journal:
                    # replay the dead attempt's exact plan from the
                    # catalog so digests line up and the journaled prefix
                    # stays bit-compatible
                    orig = self.catalog.get_plan(resume.plan_id)
                    if orig is not None:
                        plan = MergePlan.from_payload(orig["payload"])
                    if resume.plan_digest != plan.digest():
                        resume.discard()
                        resume = None
                try:
                    result = execute_merge(
                        plan,
                        self.snapshots,
                        self.catalog,
                        sid=exec_sid,
                        txn=self.txn,
                        compute=opts.compute,
                        coalesce=opts.coalesce,
                        verify=getattr(opts, "verify", True),
                        expert_readers=expert_readers,
                        pipeline=opts.pipeline,
                        cancel=cancel,
                        progress=self._node_progress(handles),
                        resume=resume,
                        device=self.device,
                    )
                except MergeCancelled as e:
                    dead[id(node)] = e
                    for h in handles:
                        if h.status not in JobState.TERMINAL:
                            self._fail_handle(h, e)
                    continue
                except SimulatedCrash as e:
                    # in-process worker death: the transaction was NOT
                    # aborted, so staging and the progress journal
                    # survive — salvage the validated prefix and requeue
                    # the survivors with backoff (the scheduler thread
                    # must outlive the crash: only this node dies)
                    self.txn.forsake()
                    state = self.txn.prepare_resume(exec_sid)
                    if state is not None:
                        self._resume_states[exec_sid] = state
                    self._requeue_or_quarantine(node, handles, e, dead)
                    continue
                # broad-except-ok: per-node containment — MergeCancelled
                # and SimulatedCrash are taken by the dedicated handlers
                # above; everything else either requeues (transient) or
                # settles the node's handles with the error
                except Exception as e:
                    if is_transient(e):
                        # transient I/O failure (timeouts, dropped
                        # connections): the executor already aborted, but
                        # a journal left by an earlier forsaken attempt
                        # may still be salvageable
                        state = self.txn.prepare_resume(exec_sid)
                        if state is not None:
                            self._resume_states[exec_sid] = state
                        self._requeue_or_quarantine(node, handles, e, dead)
                        continue
                    dead[id(node)] = e
                    for h in handles:
                        if h.status not in JobState.TERMINAL:
                            self._fail_handle(h, e)
                    continue
                if resume is not None:
                    # budget soundness across attempts: the dead attempt
                    # already paid for the journaled prefix, and this
                    # window's plan_batch charge re-billed the full union
                    # — refund the overlap so each expert byte is charged
                    # exactly once per committed merge
                    refund = resume.journaled_expert_bytes(plan)
                    if refund > 0:
                        tenants = node_tenants.get(id(node), ())
                        if tenants:
                            each = refund // len(tenants)
                            for i, t in enumerate(tenants):
                                self.arbiter.refund(
                                    t,
                                    refund - each * (len(tenants) - 1)
                                    if i == 0 else each,
                                )
                        self.arbiter.refund_global(refund)
                    result.stats["resumed"] = True
                result.stats["plan"] = pr.stats
                node.sid = result.sid
                node.result = result
        finally:
            for r in owned_readers.values():
                r.close()
            if owned_layout is not None:
                owned_layout.close()

        stats = dict(bp.stats)
        stats["layout_id"] = layout_id
        if cache_readers:
            hits, misses, saved = self._cache_counters(cache_readers)
            stats["cache"] = {
                "hits": hits - cache_before[0],
                "misses": misses - cache_before[1],
                "bytes_saved": saved - cache_before[2],
            }
        if len(level_nodes) > 1:
            for node in level_nodes:
                if node.result is not None:
                    node.result.stats["batch"] = stats
        return stats

    @staticmethod
    def _cache_counters(
        readers: Dict[str, CachingModelReader]
    ) -> Tuple[int, int, int]:
        return (
            sum(r.hits for r in readers.values()),
            sum(r.misses for r in readers.values()),
            sum(r.bytes_saved for r in readers.values()),
        )

    def _node_progress(self, handles: List[JobHandle]):
        if not handles:
            return None

        def cb(done: int, total: int) -> None:
            for h in handles:
                h._update_progress(done, total)

        return cb

    # ------------------------------------------------- persistent readers
    def _shared_readers(
        self, layout_id: Optional[str], model_ids: List[str]
    ) -> Dict[str, CachingModelReader]:
        """Service-lifetime cached readers: later windows re-use blocks
        already scanned for earlier (in-flight or finished) work, so an
        expert shared across windows is still read once physically while
        the shared CacheBudget has room.

        The open-reader set is LRU-bounded at ``max_open_readers`` so an
        always-on service over a large model fleet never accumulates
        file descriptors; the current level's readers are pinned against
        eviction.  (A reader pins its file, so re-registering a model id
        with different content mid-service is served from the old bytes
        until its reader is evicted — re-register under fresh ids.)"""
        pinned = {(layout_id, m) for m in model_ids}
        out: Dict[str, CachingModelReader] = {}
        for model_id in model_ids:
            key = (layout_id, model_id)
            reader = self._readers.pop(key, None)
            if reader is None:
                if layout_id is not None:
                    layout = self._layouts.get(layout_id)
                    if layout is None:
                        layout = self._layouts[layout_id] = (
                            self.snapshots.packed.open_layout(layout_id)
                        )
                    inner = layout.open_member(model_id)
                else:
                    inner = self.snapshots.models.open_model(model_id)
                reader = CachingModelReader(
                    inner, budget=self._cache_budget, stats=self.stats
                )
            self._readers[key] = reader  # re-insert = most recently used
            out[model_id] = reader
        while len(self._readers) > self.max_open_readers:
            victim = next(
                (k for k in self._readers if k not in pinned), None
            )
            if victim is None:
                break  # everything open is pinned by this level
            self._readers.pop(victim).close()
        return out

    # ---------------------------------------------------------------- packed
    def _select_layout(
        self,
        prefer_packed: Union[bool, str],
        expert_ids: List[str],
        base_ids: List[str],
    ) -> Optional[str]:
        """Resolve the packed layout one execution level reads from.

        A layout is only *applicable* when every expert of the level is a
        member AND the level's (single) base is the layout's own base —
        elision means "delta vs the layout's base is zero", so any other
        base would make synthesized zero deltas wrong.  Inapplicable
        levels fall back to flat reads: in a merge graph, upper levels
        whose inputs are freshly-committed snapshots are never members of
        a pre-built layout, and a forced layout must not abort the graph
        mid-way (unknown ids and block-size mismatches still raise — they
        are configuration errors, not graph structure).
        """
        if not prefer_packed or not expert_ids:
            return None
        bases = set(base_ids)
        if isinstance(prefer_packed, str):
            layout = self.catalog.get_packed_layout(prefer_packed)
            if layout is None:
                raise KeyError(f"packed layout {prefer_packed!r} not found")
            if layout["block_size"] != self.block_size:
                raise ValueError(
                    f"layout {prefer_packed!r} is packed at block_size="
                    f"{layout['block_size']}, session uses {self.block_size}"
                )
            members = set(self.catalog.packed_layout_members(prefer_packed))
            applicable = (
                bases == {layout["base_id"]}
                and all(e in members for e in expert_ids)
            )
            if not applicable:
                # fall back, but never silently: on a plain single-level
                # merge this usually means a misconfigured --layout
                causes = []
                if bases != {layout["base_id"]}:
                    causes.append(
                        f"layout base {layout['base_id']!r} vs merge "
                        f"base(s) {sorted(bases)}"
                    )
                non_members = [e for e in expert_ids if e not in members]
                if non_members:
                    causes.append(f"non-members: {non_members}")
                warnings.warn(
                    f"forced packed layout {prefer_packed!r} does not apply "
                    f"to this level ({'; '.join(causes)}) — reading flat "
                    f"checkpoints instead",
                    stacklevel=3,
                )
                return None
            return prefer_packed
        # auto-prefer: only lossless layouts packed against this exact
        # base qualify (outputs must stay bit-identical to the flat
        # store; lossy layouts are an explicit opt-in by id)
        if len(bases) != 1:
            return None
        return self.catalog.find_packed_layout(
            expert_ids, self.block_size, lossless_only=True,
            base_id=bases.pop(),
        )

    # ------------------------------------------------------- substrate ops
    def jobs(self, state: Optional[str] = None,
             tenant: Optional[str] = None) -> List[Dict]:
        """Job table view (catalog-backed; survives restarts)."""
        return self.catalog.list_jobs(state=state, tenant=tenant)

    # ------------------------------------------------------- mergefsck scrub
    def _maybe_scrub(self) -> None:
        """Scheduler-thread hook: run a repairing fsck pass when the
        service has been idle for ``scrub_idle_s``.  Disabled (None) by
        default; scrub failures never take down the scheduler."""
        if self.scrub_idle_s is None:
            return
        now = time.monotonic()
        if now - self._last_scrub < self.scrub_idle_s:
            return
        self._last_scrub = now
        try:
            self.scrub(repair=True)
        # broad-except-ok: the scrubber is best-effort background
        # hygiene; a failed pass is reported via status(), not by
        # killing the scheduler thread
        except Exception as e:
            with self._cond:
                self._scrub_report = {"error": str(e)}

    def scrub(self, repair: bool = True) -> Dict[str, Any]:
        """Run mergefsck over the workspace now (also available as
        ``merge_cli fsck``): re-hashes snapshots, packed extents, and
        disk-cache extents against their cataloged contracts, repairing
        or quarantining what it can (see :mod:`repro_torch.store.fsck`).  The
        latest report is kept and surfaced in :meth:`status`."""
        report = self.fsck(repair=repair, rate_mbps=self.scrub_rate_mbps)
        doc = report.to_dict()
        with self._cond:
            self._scrub_report = doc
        return doc

    def status(self) -> Dict[str, Any]:
        """Service health snapshot: in-memory job-state counts, pending
        queue depth, budget-pool usage, sids holding a validated resume
        state (crashed work awaiting its next attempt), quarantined job
        ids (catalog-backed, so restarts are included), and the latest
        background-scrub report (None until a scrub has run)."""
        with self._cond:
            jobs = list(self._jobs.values())
            pending = len(self._pending)
            scrub_report = self._scrub_report
        counts: Dict[str, int] = {}
        for j in jobs:
            s = j.handle.status
            counts[s] = counts.get(s, 0) + 1
        return {
            "jobs": counts,
            "pending": pending,
            "windows_run": self._window_seq,
            "budget": self.arbiter.usage(),
            "resumable_sids": sorted(self._resume_states),
            "quarantined": [
                r["job_id"]
                for r in self.catalog.list_jobs(state=JobState.QUARANTINED)
            ],
            "scrub": scrub_report,
        }
