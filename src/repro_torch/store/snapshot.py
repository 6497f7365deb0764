"""Snapshots: staged writes + atomic publish (paper §2.2, §5.3).

Invariant (Immutability and Atomic Visibility): a merge either publishes a
complete snapshot ``sid`` with manifest ``man(sid)``, or publishes nothing.
The publish point is a single ``os.replace`` of the manifest file — POSIX
rename atomicity gives us the transactional guarantee without a WAL.

Layout under the workspace root:

    models/                  # CheckpointStore root (bases, experts, snapshots)
    staging/txn-<token>/     # invisible until publish
    manifests/<sid>.json     # existence == committed
    journals/<sid>.journal   # block-level progress (crash resume; see
                             # repro_torch.store.journal and docs/RECOVERY.md)
"""
from __future__ import annotations

import hashlib
import json
import os
import queue
import shutil
import threading
import time
import uuid
from typing import Dict, List, Mapping, Optional

import numpy as np

from repro_torch.store import dtypes
from repro_torch.store.iostats import GLOBAL_STATS, IOStats
from repro_torch.store.journal import ProgressJournal, ResumeState, journal_path
from repro_torch.store.tensorstore import MODEL_MANIFEST, TENSOR_DIR, CheckpointStore
from repro_torch.testing.chaos import chaos_point


class StagingWriter:
    """Streams output blocks sequentially per tensor into a staging dir.

    The executor (Algorithm 2) materializes every output block in plan
    order; this writer appends them, maintaining streaming hashes so
    ``ValidateHashes`` never needs to re-read the data files.

    With a ``journal`` attached, every block append is also recorded in
    the durable progress journal (content hash + contributing experts),
    making a crash resumable.  With a ``resume`` state, tensors the dead
    run already (partially) staged are reopened in place: the file is
    truncated to the validated prefix, the streaming hash is seeded from
    the validation pass, and writes continue at the high-water block.
    """

    def __init__(
        self,
        staging_dir: str,
        stats: IOStats,
        journal: Optional[ProgressJournal] = None,
        resume: Optional[ResumeState] = None,
    ):
        self.dir = staging_dir
        self.stats = stats
        self.journal = journal
        os.makedirs(os.path.join(staging_dir, TENSOR_DIR), exist_ok=True)
        self.specs: Dict[str, Dict] = {}
        self._open_name: Optional[str] = None
        self._open_file = None
        self._open_hash = None
        self._block_hashes: List[str] = []
        self._written = 0
        self._next_block = 0
        self._resume_tensors = dict(resume.tensors) if resume is not None else {}
        self._tensor_count = resume.n_tensor_files if resume is not None else 0
        self.aborted = False

    # -- per-tensor streaming ------------------------------------------------
    def begin_tensor(self, tensor_id: str, shape, dtype) -> None:
        if self._open_name is not None:
            raise RuntimeError(f"tensor {self._open_name} still open")
        tr = self._resume_tensors.pop(tensor_id, None)
        if tr is not None:
            # resumed tensor: reopen its staged file, drop any torn tail
            # beyond the validated prefix, and seed the streaming state
            fname = tr.file
            path = os.path.join(self.dir, fname)
            try:
                f = open(path, "r+b")
            except FileNotFoundError:
                f = open(path, "wb")
            f.truncate(tr.validated_nbytes)
            f.seek(tr.validated_nbytes)
            self._open_file = f
            self._open_hash = tr.hash_obj.copy()
            self._block_hashes = list(tr.block_hashes)
            self._written = tr.validated_nbytes
            self._next_block = tr.n_validated
        else:
            fname = os.path.join(TENSOR_DIR, f"{self._tensor_count:05d}.bin")
            self._tensor_count += 1
            self._open_file = open(os.path.join(self.dir, fname), "wb")
            self._open_hash = hashlib.blake2b(digest_size=16)
            self._block_hashes = []
            self._written = 0
            self._next_block = 0
        self._open_name = tensor_id
        self.specs[tensor_id] = {
            "shape": list(shape),
            "dtype": dtypes.dtype_name(dtype),
            "file": fname,
            "nbytes": 0,
            "hash": "",
            "block_hashes": self._block_hashes,
        }
        if self.journal is not None:
            self.journal.tensor(
                tensor_id, fname, list(shape), dtypes.dtype_name(dtype)
            )

    def write_block(
        self,
        tensor_id: str,
        block_idx: int,
        block: np.ndarray,
        experts: Optional[str] = None,
    ) -> None:
        """Append one output block.  ``experts`` is the comma-joined list
        of experts that contributed (coverage) — journaled with the block
        so a resumed run can re-seed lineage without re-reading anything."""
        if tensor_id != self._open_name:
            raise RuntimeError(f"tensor {tensor_id} is not the open tensor")
        if block_idx != self._next_block:
            raise RuntimeError(
                f"blocks must stream in order: expected {self._next_block}, "
                f"got {block_idx}"
            )
        raw = np.ascontiguousarray(block).tobytes()
        self._open_file.write(raw)
        self._open_hash.update(raw)
        h8 = hashlib.blake2b(raw, digest_size=8).hexdigest()
        self._block_hashes.append(h8)
        self._written += len(raw)
        self._next_block += 1
        self.stats.record_write("out", len(raw))
        if self.journal is not None:
            self.journal.block(tensor_id, block_idx, len(raw), h8, experts)

    def finish_tensor(self, tensor_id: str) -> None:
        if tensor_id != self._open_name:
            raise RuntimeError(f"tensor {tensor_id} is not the open tensor")
        self._open_file.close()
        spec = self.specs[tensor_id]
        spec["nbytes"] = self._written
        spec["hash"] = self._open_hash.hexdigest()
        self._open_name = None
        self._open_file = None
        if self.journal is not None:
            self.journal.finish(tensor_id, spec["nbytes"], spec["hash"])

    # -- validation (Algorithm 2 step 2: S.ValidateHashes) ---------------------
    def validate_hashes(self) -> None:
        """Re-read staged bytes and compare against streaming hashes —
        catches torn writes / disk corruption before publish."""
        if self._open_name is not None:
            raise RuntimeError(f"tensor {self._open_name} never finished")
        for tensor_id, spec in self.specs.items():
            path = os.path.join(self.dir, spec["file"])
            h = hashlib.blake2b(digest_size=16)
            n = 0
            with open(path, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    h.update(chunk)
                    n += len(chunk)
            self.stats.record_read("meta", n)
            if n != spec["nbytes"] or h.hexdigest() != spec["hash"]:
                raise IOError(f"hash validation failed for staged tensor {tensor_id}")

    def abort(self) -> None:
        if self._open_file is not None:
            self._open_file.close()
            self._open_file = None
            self._open_name = None
        shutil.rmtree(self.dir, ignore_errors=True)
        if self.journal is not None:
            # a deliberate abort discards progress — unlike a crash, which
            # never reaches this path and leaves the journal for resume
            self.journal.remove()
        self.aborted = True

    def detach(self) -> None:
        """Close open handles WITHOUT deleting staged data or the journal
        — the in-process analogue of a worker death.  Used by the
        service's crash handling and the chaos harness before resuming."""
        if self._open_file is not None:
            self._open_file.close()
            self._open_file = None
            self._open_name = None
        if self.journal is not None:
            self.journal.close()


class WriteBehindWriter:
    """Asynchronous facade over a :class:`StagingWriter` — the pipelined
    executor's third stage.

    ``begin_tensor`` / ``write_block`` / ``finish_tensor`` enqueue
    commands onto a bounded queue drained *in order* by one writer
    thread, so output-file writes overlap the next window's reads and
    compute.  Ordering, streaming hashes, and I/O accounting are exactly
    the wrapped writer's — the commands replay verbatim, just later.

    A failure on the writer thread is re-raised on the producer side at
    the next enqueue (or at :meth:`flush`), so the executor's abort path
    fires exactly as in the synchronous engine; the ``failed`` event is
    set the moment the failure happens, so the *prefetch* stage can stop
    reading expert bytes a doomed merge would throw away instead of
    discovering the failure a full write-queue later.
    ``close(discard=True)`` stops the thread without replaying queued
    commands (abort path).
    """

    _FLUSH = object()  # queue marker: wake any flush() waiters

    def __init__(self, writer: StagingWriter, max_queued_blocks: int = 64):
        self.writer = writer
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, max_queued_blocks))
        self._exc: Optional[BaseException] = None
        self._discard = False
        self._closed = False
        self.peak_queued = 0
        self._flushed = threading.Event()
        #: set by the writer thread the instant a write fails — poll this
        #: (or ``raise_if_failed``) from read/compute stages for prompt
        #: failure propagation
        self.failed = threading.Event()
        self._thread = threading.Thread(
            target=self._drain, name="mergepipe-write-behind", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------
    def _submit(self, method: str, *args) -> None:
        self.raise_if_failed()
        if self._closed:
            raise RuntimeError("write-behind writer already closed")
        self._q.put((method, args))
        # sampled after the (possibly blocking) put — never exceeds the
        # queue bound, so the bounded-memory invariant is checkable
        self.peak_queued = max(self.peak_queued, self._q.qsize())

    def begin_tensor(self, tensor_id: str, shape, dtype) -> None:
        self._submit("begin_tensor", tensor_id, shape, dtype)

    def write_block(
        self,
        tensor_id: str,
        block_idx: int,
        block: np.ndarray,
        experts: Optional[str] = None,
    ) -> None:
        self._submit("write_block", tensor_id, block_idx, block, experts)

    def finish_tensor(self, tensor_id: str) -> None:
        self._submit("finish_tensor", tensor_id)

    def raise_if_failed(self) -> None:
        if self._exc is not None:
            raise self._exc

    def flush(self) -> None:
        """Block until every queued command has been applied, then
        re-raise any writer-thread failure."""
        self._flushed.clear()
        self._q.put((WriteBehindWriter._FLUSH, ()))
        self._flushed.wait()
        self.raise_if_failed()

    def close(self, discard: bool = False) -> None:
        """Stop the writer thread.  ``discard=True`` drops queued commands
        (abort path: the staging dir is about to be deleted anyway)."""
        if self._closed:
            return
        self._closed = True
        self._discard = self._discard or discard
        self._q.put((None, ()))
        self._thread.join()
        if not discard:
            self.raise_if_failed()

    # -- writer thread ------------------------------------------------------
    def _drain(self) -> None:
        while True:
            method, args = self._q.get()
            if method is None:
                return
            if method is WriteBehindWriter._FLUSH:
                self._flushed.set()
                continue
            if self._exc is not None or self._discard:
                continue  # drain without applying; producer will re-raise
            try:
                chaos_point("writer:drain")
                getattr(self.writer, method)(*args)
            # broad-except-ok: nothing is swallowed — the error (incl.
            # SimulatedCrash) is parked on self._exc and re-raised on the
            # producer thread at the next enqueue/flush/close via
            # raise_if_failed, which is also the abort path's view of it
            except BaseException as e:  # noqa: BLE001
                self._exc = e
                self.failed.set()


class SnapshotStore:
    """Workspace-level snapshot management with atomic publish."""

    def __init__(self, workspace: str, stats: Optional[IOStats] = None):
        self.workspace = workspace
        self.stats = stats or GLOBAL_STATS
        self.models = CheckpointStore(os.path.join(workspace, "models"), self.stats)
        self.staging_root = os.path.join(workspace, "staging")
        self.manifest_root = os.path.join(workspace, "manifests")
        self.journal_root = os.path.join(workspace, "journals")
        os.makedirs(self.staging_root, exist_ok=True)
        os.makedirs(self.manifest_root, exist_ok=True)
        os.makedirs(self.journal_root, exist_ok=True)

    # -- staging ------------------------------------------------------------
    def open_staging_writer(
        self,
        sid: Optional[str] = None,
        plan=None,
        resume: Optional[ResumeState] = None,
        journal_sync_every: Optional[int] = None,
    ) -> StagingWriter:
        """Open a staging writer.

        With ``sid`` + ``plan``, a durable progress journal is attached so
        a crash mid-merge is resumable.  With ``resume`` (a validated
        :class:`~repro_torch.store.journal.ResumeState`), the dead run's staging
        dir is adopted and the journal continued.  Bare calls (no sid/
        plan) stay journal-free — discard-only semantics, as before.
        """
        sync_every = (
            journal_sync_every if journal_sync_every is not None
            else self.journal_sync_every
        )
        if resume is not None:
            journal = ProgressJournal(
                resume.journal_file, self.stats, sync_every=sync_every
            )
            journal.begin(
                resume.sid, resume.plan_id, resume.plan_digest,
                resume.staging_dir, resume.block_size,
                attempt=resume.attempt + 1,
            )
            return StagingWriter(
                resume.staging_dir, self.stats, journal=journal, resume=resume
            )
        token = uuid.uuid4().hex[:12]
        staging_dir = os.path.join(self.staging_root, f"txn-{token}")
        journal = None
        if sid is not None and plan is not None:
            journal = ProgressJournal(
                self.journal_path(sid), self.stats, sync_every=sync_every
            )
            journal.begin(
                sid, plan.plan_id, plan.digest(), staging_dir,
                plan.block_size, attempt=1,
            )
        return StagingWriter(staging_dir, self.stats, journal=journal)

    # -- journals (crash resume) -------------------------------------------
    #: default fsync cadence for journal block records; tests lower it to
    #: 1 so every block is durably journaled the instant it lands
    journal_sync_every = 32

    def journal_path(self, sid: str) -> str:
        from repro_torch.store.journal import journal_path as _jp

        return _jp(self.journal_root, sid)

    def list_journal_paths(self) -> List[str]:
        try:
            names = os.listdir(self.journal_root)
        except OSError:
            return []
        return sorted(
            os.path.join(self.journal_root, n)
            for n in names
            if n.endswith(".journal")
        )

    # -- atomic publish (paper §5.3) ---------------------------------------
    def atomic_publish(self, writer: StagingWriter, manifest: Dict) -> str:
        """Publish a staged snapshot. Returns sid. All-or-nothing."""
        sid = manifest["sid"]
        if self.is_published(sid):
            raise ValueError(f"snapshot {sid} already published")
        # 1. finalize the staged model dir with its MODEL.json
        model_doc = {
            "model_id": sid,
            "meta": {"snapshot": True, "plan_id": manifest.get("plan_id")},
            "tensors": {
                name: {k: v for k, v in spec.items() if k != "block_hashes"}
                for name, spec in writer.specs.items()
            },
        }
        raw_model = json.dumps(model_doc, indent=1).encode()
        with open(os.path.join(writer.dir, MODEL_MANIFEST), "wb") as f:
            f.write(raw_model)
            f.flush()
            os.fsync(f.fileno())
        self.stats.record_write("meta", len(raw_model))
        # 2. move staged dir into the model store (same fs => atomic rename)
        final_dir = os.path.join(self.models.root, sid)
        # chaos-ok: the publish:before / publish:after crash points
        # bracket this whole call one layer up, in
        # TransactionManager.atomic_publish (transactions.py)
        os.replace(writer.dir, final_dir)
        # 3. publish point: manifest file appears atomically
        manifest = dict(manifest)
        manifest["output_root"] = final_dir
        manifest["created_at"] = time.time()
        raw = json.dumps(manifest, indent=1, default=str).encode()
        tmp = os.path.join(self.manifest_root, f".{sid}.tmp")
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        # chaos-ok: bracketed by publish:before / publish:after in
        # TransactionManager.atomic_publish (transactions.py)
        os.replace(tmp, os.path.join(self.manifest_root, f"{sid}.json"))
        self.stats.record_write("meta", len(raw))
        # 4. the snapshot is durable, but its progress journal must
        # outlive the publish until the catalog's lineage rows (coverage,
        # touch map) land — the executor removes it right before commit,
        # and recovery replays lineage for a published sid from the
        # journal before deleting it.  Journal-less writers just clear
        # any stale journal a previous crashed attempt left behind.
        if writer.journal is None:
            try:
                os.unlink(self.journal_path(sid))
            except FileNotFoundError:
                pass
        return sid

    # -- queries ----------------------------------------------------------
    def is_published(self, sid: str) -> bool:
        return os.path.exists(os.path.join(self.manifest_root, f"{sid}.json"))

    def manifest(self, sid: str) -> Dict:
        path = os.path.join(self.manifest_root, f"{sid}.json")
        with open(path, "rb") as f:
            raw = f.read()
        self.stats.record_read("meta", len(raw))
        return json.loads(raw)

    def list_snapshots(self) -> List[str]:
        return sorted(
            f[: -len(".json")]
            for f in os.listdir(self.manifest_root)
            if f.endswith(".json")
        )

    def gc_staging(self, keep: Optional[frozenset] = None) -> int:
        """Remove orphaned staging dirs (crash recovery). Returns count.

        ``keep`` holds directory basenames with a validated progress
        journal — resumable work the GC must not destroy."""
        keep = keep or frozenset()
        n = 0
        for d in os.listdir(self.staging_root):
            if d in keep:
                continue
            shutil.rmtree(os.path.join(self.staging_root, d), ignore_errors=True)
            n += 1
        return n
