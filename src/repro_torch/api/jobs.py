"""Job model for the asynchronous :class:`~repro_torch.api.service.MergeService`.

A merge job moves through a small state machine::

    pending ──submit──> queued ──admission──> admitted ──window──> running
                          │                      │                    │
                          │ reject               │ cancel             │ cancel
                          v                      v                    v
                       rejected              cancelled            cancelled
                                                                      │ error
                                                          done <──────┴──> failed

``pending`` is the pre-service state used by :meth:`Session.submit`
(jobs queued locally until ``run_all`` hands them to the service).
A job whose execution dies on a *transient* fault (simulated or real
worker death, I/O timeouts) is requeued with jittered backoff and — when
a progress journal survives — resumed at its block-level high-water
mark; after ``max_job_attempts`` such deaths it lands in the terminal
``quarantined`` state (poison work that keeps killing workers must not
be retried forever).  See docs/RECOVERY.md.
Admission control happens *before* any parameter I/O: a job whose hard
byte demand cannot fit the budget pool is rejected (or held queued,
depending on the service's admission policy) — never aborted
mid-execution for budget reasons.

:class:`JobHandle` is the future-style handle returned by
``MergeService.submit()``: ``wait()`` blocks for (and returns) the
committed :class:`~repro_torch.core.executor.MergeResult`, ``status`` /
``progress()`` observe execution from any thread, and ``cancel()``
requests cooperative cancellation — a running job aborts crash-safely
through the transaction manager (no partial snapshot ever becomes
visible).
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, Optional


class JobState:
    """String constants for the job state machine (JSON/catalog friendly)."""

    PENDING = "pending"      # created, not yet handed to a service
    QUEUED = "queued"        # submitted, awaiting admission
    ADMITTED = "admitted"    # past admission control, awaiting a window
    RUNNING = "running"      # executing inside a scheduling window
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    REJECTED = "rejected"    # refused at admission (budget pool)
    QUARANTINED = "quarantined"  # poison: crashed/retried past the limit

    TERMINAL = frozenset({DONE, FAILED, CANCELLED, REJECTED, QUARANTINED})


class JobCancelled(RuntimeError):
    """Raised by :meth:`JobHandle.wait` when the job was cancelled."""


class AdmissionRejected(RuntimeError):
    """Raised by :meth:`JobHandle.wait` when admission control refused
    the job (its hard byte demand exceeds the remaining budget pool)."""


class DeadlineExceeded(RuntimeError):
    """Raised by :meth:`JobHandle.wait` when the job's deadline passed
    before a scheduling window could run it."""


class JobHandle:
    """Future-style handle for one submitted merge job.

    Thread-safe: the service mutates it from the scheduler thread while
    any number of caller threads ``wait()`` / ``cancel()`` / observe.
    """

    def __init__(
        self,
        spec,
        sid: Optional[str] = None,
        tenant: str = "default",
        priority: int = 0,
        deadline: Optional[float] = None,
        job_id: Optional[str] = None,
    ):
        self.spec = spec
        self.requested_sid = sid
        self.tenant = tenant
        self.priority = int(priority)
        #: relative seconds from submission; bound to an absolute wall
        #: clock instant by the service at submit()
        self.deadline = deadline
        self.job_id = job_id or "job-" + uuid.uuid4().hex[:12]
        self.sid: Optional[str] = None
        self.window_id: Optional[str] = None
        #: admission record: {"decision", "kind", "demand_b", ...}
        self.admission: Optional[Dict[str, Any]] = None
        self.submitted_at: Optional[float] = None
        self.finished_at: Optional[float] = None

        self._lock = threading.Lock()
        self._terminal = threading.Event()
        self._cancel_event = threading.Event()
        self._state = JobState.PENDING
        self._result = None
        self._error: Optional[BaseException] = None
        self._progress: Dict[str, Any] = {"blocks_done": 0, "blocks_total": None}
        self._service = None  # set by MergeService.submit

    # ------------------------------------------------------------- queries
    @property
    def status(self) -> str:
        with self._lock:
            return self._state

    @property
    def result(self):
        """The committed MergeResult, or None while not done."""
        return self._result

    @result.setter
    def result(self, value) -> None:  # legacy Session handles assign this
        self._result = value

    @property
    def done(self) -> bool:
        return self._result is not None

    def progress(self) -> Dict[str, Any]:
        """Point-in-time view: state, sid (once known), blocks done/total."""
        with self._lock:
            out = dict(self._progress)
            out["state"] = self._state
            out["sid"] = self.sid
            total = out.get("blocks_total")
            done = out.get("blocks_done") or 0
            out["fraction"] = (done / total) if total else None
            return out

    # --------------------------------------------------------------- wait
    def wait(self, timeout: Optional[float] = None):
        """Block until the job reaches a terminal state; return the
        MergeResult on success, raise on failure / cancel / rejection."""
        if self._service is None and self.status == JobState.PENDING:
            raise RuntimeError(
                f"job {self.job_id} was queued on a Session but never "
                f"submitted to a MergeService — call Session.run_all()"
            )
        if not self._terminal.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not finished after {timeout}s "
                f"(state={self.status})"
            )
        with self._lock:
            if self._state == JobState.DONE:
                return self._result
            err = self._error
            if err is None:
                if self._state == JobState.CANCELLED:
                    err = JobCancelled(f"job {self.job_id} was cancelled")
                elif self._state == JobState.REJECTED:
                    err = AdmissionRejected(f"job {self.job_id} was rejected")
                else:
                    err = RuntimeError(f"job {self.job_id} failed")
        raise err

    # ------------------------------------------------------------- cancel
    def cancel(self) -> bool:
        """Request cancellation.  Returns True if this job is abandoned:
        queued jobs cancel immediately, running jobs abort at the next
        executor checkpoint (crash-safe — staged output is discarded,
        nothing is published) and ``wait()`` raises :class:`JobCancelled`.
        When the job's work is deduped with another live job's, that
        other job may still commit the shared snapshot — this handle
        still resolves cancelled.  Returns False when the job already
        reached a terminal state."""
        svc = self._service
        if svc is not None:
            return svc._cancel_job(self)
        with self._lock:
            if self._state == JobState.PENDING:
                self._state = JobState.CANCELLED
                self._error = JobCancelled(f"job {self.job_id} was cancelled")
                self.finished_at = time.time()
                self._terminal.set()
                return True
        return False

    @property
    def cancel_requested(self) -> bool:
        return self._cancel_event.is_set()

    # ----------------------------------------- service-side transitions
    def _set_state(self, state: str) -> None:
        with self._lock:
            if self._state not in JobState.TERMINAL:
                self._state = state

    def _update_progress(self, blocks_done: int, blocks_total: int) -> None:
        with self._lock:
            self._progress["blocks_done"] = blocks_done
            self._progress["blocks_total"] = blocks_total

    def _finish(self, result, finished_at: Optional[float] = None) -> None:
        with self._lock:
            if self._state in JobState.TERMINAL:
                return
            self._state = JobState.DONE
            self._result = result
            self.sid = result.sid
            self.finished_at = (
                finished_at if finished_at is not None else time.time()
            )
            self._terminal.set()

    def _fail(
        self,
        error: BaseException,
        state: str = JobState.FAILED,
        finished_at: Optional[float] = None,
    ) -> None:
        with self._lock:
            if self._state in JobState.TERMINAL:
                return
            self._state = state
            self._error = error
            self.finished_at = (
                finished_at if finished_at is not None else time.time()
            )
            self._terminal.set()

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"JobHandle({self.job_id}, spec={self.spec.spec_id}, "
            f"tenant={self.tenant!r}, state={self.status}, "
            f"sid={self.sid or self.requested_sid})"
        )
