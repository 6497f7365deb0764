"""Transaction manager — Begin / AtomicPublish / Commit (Algorithm 2).

Thin coordinator over :class:`SnapshotStore` and :class:`Catalog` that
gives the executor the exact call surface of the paper's pseudocode and
centralizes failure injection for crash-safety tests.

Commit protocol (all-or-nothing):
    1. stage writes              (invisible; journaled block-by-block)
    2. validate hashes           (invisible)
    3. snapshot dir rename + manifest file replace  <- publish point
    4. catalog CommitRecord      (idempotent, recoverable from manifest)

Failure handling (docs/RECOVERY.md):

* a crash before (3) leaves a staging dir plus its progress journal —
  ``recover()`` validates the journal and returns a
  :class:`~repro_torch.store.journal.ResumeState` so the merge restarts at its
  block-level high-water mark instead of from scratch (journal-less
  staging orphans are still gc'd as before);
* a crash between (3) and (4) is repaired by ``recover()``, which
  re-registers any published manifest missing from the catalog and
  replays lineage (coverage + touch map) from the journal — the journal
  deliberately outlives the publish rename until those catalog rows
  land;
* a deliberate ``abort()`` discards staging AND journal — only crashes
  (which never reach the abort path) leave resumable state behind.
"""
from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Optional

from repro_torch.core.catalog import Catalog
from repro_torch.store.journal import ResumeState, build_resume_state, parse_journal
from repro_torch.store.snapshot import SnapshotStore, StagingWriter
from repro_torch.testing.chaos import chaos_point


class CrashPoint(Exception):
    """Raised by injected failures in tests (abort-path injection; see
    :class:`repro_torch.testing.chaos.SimulatedCrash` for kill-style injection
    that leaves resumable state behind)."""


class TransactionManager:
    def __init__(self, snapshots: SnapshotStore, catalog: Catalog):
        self.snapshots = snapshots
        self.catalog = catalog
        self._active: Optional[StagingWriter] = None
        # test hooks
        self.fail_before_publish = False
        self.fail_after_publish = False

    def begin(
        self,
        sid: Optional[str] = None,
        plan=None,
        resume: Optional[ResumeState] = None,
    ) -> StagingWriter:
        """Open the transaction's staging writer.  With ``sid`` + ``plan``
        a progress journal is attached (crash-resumable); with ``resume``
        the dead run's staging is adopted at its validated high-water
        mark.  Bare ``begin()`` keeps the legacy journal-free behavior."""
        if self._active is not None:
            raise RuntimeError("transaction already active")
        if resume is not None:
            self._active = self.snapshots.open_staging_writer(resume=resume)
        else:
            self._active = self.snapshots.open_staging_writer(sid=sid, plan=plan)
        return self._active

    def atomic_publish(self, writer: StagingWriter, manifest: Dict) -> str:
        if writer is not self._active:
            raise RuntimeError("publishing a writer from another transaction")
        if self.fail_before_publish:
            self.abort()
            raise CrashPoint("injected failure before publish")
        chaos_point("publish:before")
        sid = self.snapshots.atomic_publish(writer, manifest)
        if self.fail_after_publish:
            self._active = None
            raise CrashPoint("injected failure after publish (pre-catalog)")
        chaos_point("publish:after")
        return sid

    def commit_record(self, sid: str, manifest: Dict) -> None:
        self.catalog.record_manifest(
            sid,
            manifest["plan_id"],
            manifest["base_id"],
            manifest["expert_ids"],
            manifest["op"],
            manifest["budget_b"],
            manifest["c_expert_run"],
            manifest["output_root"],
        )

    def commit(self) -> None:
        self._active = None

    def abort(self) -> None:
        if self._active is not None:
            self._active.abort()
            self._active = None

    def forsake(self) -> None:
        """Drop the active writer WITHOUT discarding its staging dir or
        journal — the in-process stand-in for a worker death.  The
        service's crash handling calls this after a
        :class:`~repro_torch.testing.chaos.SimulatedCrash` (or any failure it
        intends to resume) so the next attempt can ``prepare_resume``."""
        if self._active is not None:
            self._active.detach()
            self._active = None

    @staticmethod
    def new_sid() -> str:
        return "snap-" + uuid.uuid4().hex[:12]

    # -- recovery ---------------------------------------------------------
    def prepare_resume(self, sid: str) -> Optional[ResumeState]:
        """Validate the progress journal for ``sid`` (if any) and return
        a resume state, or ``None`` when nothing usable survives.  Stale
        journals (sid already published, staging gone) are cleaned up."""
        path = self.snapshots.journal_path(sid)
        if not os.path.exists(path):
            return None
        parsed = parse_journal(path, self.snapshots.stats)
        if parsed is None:
            _unlink(path)
            return None
        if self.snapshots.is_published(parsed.sid):
            self._repair_published_lineage(parsed)
            _unlink(path)
            return None
        state = build_resume_state(parsed, self.snapshots.stats)
        if state is None:
            _unlink(path)
            return None
        return state

    def _repair_published_lineage(self, parsed) -> None:
        """A journal outliving its published sid means the process died
        between the publish rename and the catalog's lineage inserts:
        re-insert the coverage rows (and touch ranges) the journal
        proves.  Idempotent — rows already committed are re-replaced
        with identical values."""
        from repro_torch.core.executor import _ranges_from_indices

        rows = []
        touched: Dict[str, list] = {}
        for t, blocks in parsed.blocks.items():
            for b, (_n, _h, experts) in sorted(blocks.items()):
                if experts:
                    rows.append((t, b, experts))
                    touched.setdefault(t, []).append(b)
        if rows:
            self.catalog.record_coverage(parsed.sid, rows)
            self.catalog.record_touch_map(
                parsed.sid,
                {t: _ranges_from_indices(ix) for t, ix in touched.items()},
            )

    def recover(self, resume: bool = True) -> Dict[str, Any]:
        """Crash recovery.

        1. Parse + validate every progress journal: journals whose sid is
           already published (or that fail validation) are deleted; the
           rest become ``resumable[sid] -> ResumeState`` and their staging
           dirs are protected from GC.
        2. GC all other staging orphans (``resume=False`` forces the
           legacy discard-everything behavior).
        3. Re-register published manifests missing from the catalog
           (idempotent repair of a crash between publish and commit).
        """
        resumable: Dict[str, ResumeState] = {}
        for path in self.snapshots.list_journal_paths():
            parsed = parse_journal(path, self.snapshots.stats)
            if parsed is None:
                _unlink(path)
                continue
            if self.snapshots.is_published(parsed.sid):
                self._repair_published_lineage(parsed)
                _unlink(path)
                continue
            if not resume:
                _unlink(path)
                continue
            state = build_resume_state(parsed, self.snapshots.stats)
            if state is None:
                _unlink(path)
                continue
            resumable[parsed.sid] = state
        keep = frozenset(
            os.path.basename(s.staging_dir) for s in resumable.values()
        )
        gc = self.snapshots.gc_staging(keep=keep)
        repaired = 0
        known = set(self.catalog.list_manifests())
        for sid in self.snapshots.list_snapshots():
            if sid not in known:
                man = self.snapshots.manifest(sid)
                man.setdefault("output_root", "")
                self.commit_record(sid, man)
                repaired += 1
        return {
            "staging_gc": gc,
            "manifests_repaired": repaired,
            "resumable": resumable,
        }


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except FileNotFoundError:
        pass
