"""File-backed block-granular tensor storage.

Physical layout of one stored model (base, expert, or merged snapshot):

    <root>/<model_id>/
        MODEL.json            # tensor specs: name -> {shape, dtype, file, nbytes}
        tensors/00000.bin     # raw little-endian row-major bytes, one per tensor

Blocks are *logical* views over the flat tensor bytes (core.blocks); reads
use positional ``os.pread`` on a per-tensor file descriptor so expert
access is genuinely partial — reading 3 of 40 blocks of a tensor moves
only those bytes — and **concurrent readers never race**: ``pread`` takes
an explicit offset and does not touch the shared file position, so the
pipelined executor's prefetch pool (and v2 batch sessions sharing a
``CachingModelReader``) can read the same tensor from many threads.
Every physical read/write is tagged into :mod:`repro_torch.store.iostats` with
the paper's cost category.
"""
from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.store import dtypes
from repro_torch.store.iostats import GLOBAL_STATS, IOStats

MODEL_MANIFEST = "MODEL.json"
TENSOR_DIR = "tensors"
#: presence of this stub (instead of MODEL.json) marks a model whose
#: bytes live in a remote object store (see repro_torch.store.remote)
REMOTE_STUB = "REMOTE.json"


def _hash_bytes(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


class TensorSpec(dict):
    """Lightweight spec record: shape, dtype name, file, nbytes."""

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self["shape"])

    @property
    def dtype(self) -> np.dtype:
        return dtypes.to_np_dtype(self["dtype"])

    @property
    def nbytes(self) -> int:
        return int(self["nbytes"])

    @property
    def file(self) -> str:
        return self["file"]


class BlockReaderMixin:
    """Block-granular read surface over any ``read_range`` provider.

    Everything here is derived purely from ``self.specs`` (a
    ``{tensor_id: TensorSpec}`` map) plus the subclass's ``read_range`` —
    the local :class:`ModelReader` and the remote-backed
    :class:`repro_torch.store.tiered.TieredReader` share it, so the executor,
    delta iterator, and block cache see one reader interface regardless
    of which storage backend serves the bytes.
    """

    specs: Dict[str, "TensorSpec"]

    #: verify-on-read hook (repro_torch.store.integrity.BlockVerifier or None).
    #: When attached, every derived block read is checked against the
    #: cataloged block hash before the bytes reach compute — duck-typed
    #: so this module stays import-free of the integrity layer.
    verifier = None

    # -- structure -------------------------------------------------------
    def tensor_names(self) -> List[str]:
        return list(self.specs.keys())

    def spec(self, tensor_id: str) -> "TensorSpec":
        return self.specs[tensor_id]

    def total_nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs.values())

    def num_blocks(self, tensor_id: str, block_size: int) -> int:
        return blk.num_blocks(self.specs[tensor_id].nbytes, block_size)

    # -- derived reads ---------------------------------------------------
    def read_block(
        self, tensor_id: str, block_idx: int, block_size: int, category: str
    ) -> np.ndarray:
        spec = self.specs[tensor_id]
        rng = blk.block_range(spec.nbytes, block_idx, block_size)
        data = self.read_range(tensor_id, rng.offset, rng.nbytes, category)
        v = self.verifier
        if v is not None and block_size == v.block_size:
            data = v.check(
                self, tensor_id, block_idx, rng.offset, rng.nbytes, data,
                category,
            )
        return np.frombuffer(data, dtype=spec.dtype)

    def read_blocks_coalesced(
        self,
        tensor_id: str,
        block_idxs: Sequence[int],
        block_size: int,
        category: str,
        gap_bytes: int = 0,
    ) -> Dict[int, np.ndarray]:
        """Read a set of blocks with adjacent ranges coalesced into large
        sequential reads (beyond-paper batched streaming; planning remains
        block-granular, physical I/O becomes run-granular).

        ``gap_bytes`` tolerates up to that many unrequested bytes between
        two selected ranges before splitting the run (one larger
        sequential read instead of two round trips — pays off on
        high-latency shared storage).  Gap bytes are tagged ``other``,
        never ``category``, so budgeted categories count exactly the
        requested payload.

        Runs and ranges are both offset-sorted, so slicing runs back into
        blocks is a single linear sweep — O(R) total over R requested
        blocks, not O(R²) (one rescan of every range per run).
        """
        spec = self.specs[tensor_id]
        ranges = sorted(
            (blk.block_range(spec.nbytes, i, block_size) for i in block_idxs),
            key=lambda r: r.offset,
        )
        out: Dict[int, np.ndarray] = {}
        ri = 0
        for offset, nbytes in blk.coalesce_ranges(ranges, gap=gap_bytes):
            end = offset + nbytes
            run_ranges = []
            payload = 0
            while ri < len(ranges) and ranges[ri].end <= end:
                run_ranges.append(ranges[ri])
                payload += ranges[ri].nbytes
                ri += 1
            waste = max(0, nbytes - payload)
            # pass waste (and the selected ranges it lies between) only
            # when present: gap=0 keeps the historical 4-arg call shape
            # (tests/benches wrap read_range to emulate storage profiles
            # and must see an unchanged surface)
            data = (
                self.read_range(tensor_id, offset, nbytes, category)
                if waste == 0
                else self.read_range(
                    tensor_id, offset, nbytes, category, waste_nbytes=waste,
                    selected=[(r.offset, r.nbytes) for r in run_ranges],
                )
            )
            v = self.verifier
            for r in run_ranges:
                lo = r.offset - offset
                chunk = data[lo : lo + r.nbytes]
                if v is not None and block_size == v.block_size:
                    # verified per logical block, not per physical run:
                    # the contract hashes live on the block grid, and a
                    # repair refetches only the corrupt block's range
                    chunk = v.check(
                        self, tensor_id, r.block_idx, r.offset, r.nbytes,
                        chunk, category,
                    )
                out[r.block_idx] = np.frombuffer(chunk, dtype=spec.dtype)
        return out

    def read_tensor(self, tensor_id: str, category: str) -> np.ndarray:
        spec = self.specs[tensor_id]
        data = self.read_range(tensor_id, 0, spec.nbytes, category)
        return np.frombuffer(data, dtype=spec.dtype).reshape(spec.shape)

    def close(self) -> None:  # pragma: no cover — overridden where needed
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ModelReader(BlockReaderMixin):
    """Read-only, block-granular view over one stored model."""

    def __init__(self, root: str, model_id: str, stats: IOStats):
        self.root = root
        self.model_id = model_id
        self.stats = stats
        self.dir = os.path.join(root, model_id)
        manifest_path = os.path.join(self.dir, MODEL_MANIFEST)
        with open(manifest_path, "rb") as f:
            raw = f.read()
        stats.record_read("meta", len(raw))
        doc = json.loads(raw)
        self.meta: Dict = doc.get("meta", {})
        self.specs: Dict[str, TensorSpec] = {
            name: TensorSpec(spec) for name, spec in doc["tensors"].items()
        }
        self._fds: Dict[str, int] = {}
        self._fd_lock = threading.Lock()

    # -- physical reads ----------------------------------------------------
    def _fd(self, tensor_id: str) -> int:
        fd = self._fds.get(tensor_id)
        if fd is None:
            with self._fd_lock:
                fd = self._fds.get(tensor_id)
                if fd is None:
                    path = os.path.join(self.dir, self.specs[tensor_id].file)
                    fd = os.open(path, os.O_RDONLY)
                    self._fds[tensor_id] = fd
        return fd

    def read_range(
        self,
        tensor_id: str,
        offset: int,
        nbytes: int,
        category: str,
        waste_nbytes: int = 0,
        selected: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> bytes:
        """Positional read — safe under arbitrary thread concurrency
        (``pread`` never moves a shared file offset).

        ``waste_nbytes`` marks bytes inside the range that no caller
        requested (gap-tolerant coalescing reads them to save a round
        trip); they are tagged ``other`` instead of ``category`` so
        budget categories count payload bytes only while total physical
        volume stays fully accounted.  ``selected`` names the requested
        ``(offset, nbytes)`` ranges around that waste; one file is one
        tier, so this reader needs only their total.
        """
        fd = self._fd(tensor_id)
        chunks = []
        got = 0
        while got < nbytes:  # pread may return short on signals / EOF
            chunk = os.pread(fd, nbytes - got, offset + got)
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        if len(data) != nbytes:
            raise IOError(
                f"short read on {self.model_id}/{tensor_id} "
                f"[{offset}:{offset+nbytes}]: got {len(data)}"
            )
        self.stats.record_read(category, nbytes - waste_nbytes)
        if waste_nbytes:
            self.stats.record_read("other", waste_nbytes)
        return data

    def close(self) -> None:
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()


class CheckpointStore:
    """Directory of stored models with tagged-I/O read/write access."""

    def __init__(self, root: str, stats: Optional[IOStats] = None):
        self.root = root
        self.stats = stats or GLOBAL_STATS
        os.makedirs(root, exist_ok=True)
        #: callables ``model_id -> List[str]`` naming live references that
        #: make deletion unsafe (catalog lineage, packed layouts, ...).
        #: Wired by MergePipe/Session; a bare store has no guards.
        self._delete_guards: List = []
        #: shared local-disk extent cache for remote-backed models
        #: (repro_torch.store.tiered.DiskExtentCache); wired by SnapshotStore so
        #: every tenant on the box shares one warm tier.  None => tiered
        #: readers skip the disk tier and fetch straight from remote.
        self.disk_cache = None
        # one RemoteObjectStore per remote root, shared across readers so
        # fault-injection / request counters are coherent per endpoint
        self._remote_stores: Dict[str, object] = {}
        self._remote_lock = threading.Lock()

    def add_delete_guard(self, guard) -> None:
        """Register a referential-integrity check consulted by
        :meth:`delete_model` (``guard(model_id) -> List[str]`` of
        human-readable references; empty list = safe to delete)."""
        self._delete_guards.append(guard)

    # -- write -------------------------------------------------------------
    def write_model(
        self,
        model_id: str,
        tensors: Mapping[str, np.ndarray],
        meta: Optional[Dict] = None,
        category: str = "out",
        fsync: bool = False,
    ) -> str:
        """Materialize a full model. Returns the model directory."""
        mdir = os.path.join(self.root, model_id)
        tdir = os.path.join(mdir, TENSOR_DIR)
        os.makedirs(tdir, exist_ok=True)
        specs: Dict[str, Dict] = {}
        for idx, (name, arr) in enumerate(tensors.items()):
            arr = np.ascontiguousarray(dtypes.as_storage(arr))
            fname = os.path.join(TENSOR_DIR, f"{idx:05d}.bin")
            raw = arr.tobytes()
            with open(os.path.join(mdir, fname), "wb") as f:
                f.write(raw)
                if fsync:
                    f.flush()
                    os.fsync(f.fileno())
            self.stats.record_write(category, len(raw))
            specs[name] = {
                "shape": list(arr.shape),
                "dtype": dtypes.dtype_name(arr.dtype),
                "file": fname,
                "nbytes": len(raw),
                "hash": _hash_bytes(raw),
            }
        doc = {"model_id": model_id, "meta": meta or {}, "tensors": specs}
        raw_manifest = json.dumps(doc, indent=1).encode()
        tmp = os.path.join(mdir, MODEL_MANIFEST + ".tmp")
        with open(tmp, "wb") as f:
            f.write(raw_manifest)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        # chaos-ok: input-model ingest, upstream of merge transactions —
        # crash points cover the merge publish/journal edges only
        os.replace(tmp, os.path.join(mdir, MODEL_MANIFEST))
        self.stats.record_write("meta", len(raw_manifest))
        return mdir

    # -- remote-backed models (repro_torch.store.remote / .tiered) -----------------
    def register_remote(
        self,
        model_id: str,
        remote_root: str,
        profile: Optional[Dict] = None,
        disk_cache: bool = True,
    ) -> str:
        """Register a model whose bytes live in a remote object store.

        Writes a ``REMOTE.json`` stub in place of a local ``MODEL.json``;
        ``open_model`` then returns a :class:`repro_torch.store.tiered.
        TieredReader` serving reads RAM -> disk cache -> remote.
        ``disk_cache=False`` opts this model out of the shared disk tier
        (every miss pays the remote round trip — benchmark baseline).
        """
        if self.exists(model_id):
            raise ValueError(f"model {model_id!r} already registered")
        # validate now, not at first read: a typo'd id would otherwise
        # plant a stub that only fails deep inside a merge (HEAD is a
        # cheap control-plane request, never fault-injected)
        self.remote_store(remote_root).head(f"{model_id}/{MODEL_MANIFEST}")
        mdir = os.path.join(self.root, model_id)
        os.makedirs(mdir, exist_ok=True)
        stub = {
            "model_id": model_id,
            "remote_root": os.path.abspath(remote_root),
            "profile": dict(profile or {}),
            "disk_cache": bool(disk_cache),
        }
        raw = json.dumps(stub, indent=1).encode()
        tmp = os.path.join(mdir, REMOTE_STUB + ".tmp")
        with open(tmp, "wb") as f:
            f.write(raw)
            f.flush()
            os.fsync(f.fileno())
        # chaos-ok: model registration at ingest, upstream of merge
        # transactions; a crash here is re-run by the operator
        os.replace(tmp, os.path.join(mdir, REMOTE_STUB))
        self.stats.record_write("meta", len(raw))
        return mdir

    def is_remote(self, model_id: str) -> bool:
        return not os.path.exists(
            os.path.join(self.root, model_id, MODEL_MANIFEST)
        ) and os.path.exists(os.path.join(self.root, model_id, REMOTE_STUB))

    def remote_stub(self, model_id: str) -> Dict:
        path = os.path.join(self.root, model_id, REMOTE_STUB)
        with open(path, "rb") as f:
            raw = f.read()
        self.stats.record_read("meta", len(raw))
        return json.loads(raw)

    def remote_store(self, remote_root: str):
        """Shared :class:`repro_torch.store.remote.RemoteObjectStore` per remote
        root (so request/fault counters are per-endpoint, not per-reader)."""
        from repro_torch.store.remote import RemoteObjectStore

        key = os.path.abspath(remote_root)
        with self._remote_lock:
            store = self._remote_stores.get(key)
            if store is None:
                store = RemoteObjectStore(key)
                self._remote_stores[key] = store
            return store

    def publish_remote(
        self,
        model_id: str,
        remote_root: str,
        profile: Optional[Dict] = None,
        keep_local: bool = False,
        disk_cache: bool = True,
    ) -> str:
        """Upload a locally stored model to a remote object store and
        replace its local copy with a ``REMOTE.json`` stub (unless
        ``keep_local``).  Subsequent reads go through the tiered path."""
        from repro_torch.store.remote import publish_model

        if not os.path.exists(os.path.join(self.root, model_id, MODEL_MANIFEST)):
            raise ValueError(f"model {model_id!r} has no local copy to publish")
        remote = self.remote_store(remote_root)
        publish_model(self, model_id, remote)
        if not keep_local:
            import shutil

            mdir = os.path.join(self.root, model_id)
            shutil.rmtree(os.path.join(mdir, TENSOR_DIR), ignore_errors=True)
            os.remove(os.path.join(mdir, MODEL_MANIFEST))
            stub = {
                "model_id": model_id,
                "remote_root": os.path.abspath(remote_root),
                "profile": dict(profile or {}),
                "disk_cache": bool(disk_cache),
            }
            raw = json.dumps(stub, indent=1).encode()
            tmp = os.path.join(mdir, REMOTE_STUB + ".tmp")
            # the local tensors are already gone at this point: a torn
            # stub after a crash would orphan the model, so the stub
            # must be durable before it becomes visible (mergelint:
            # durability caught the missing fsync here)
            with open(tmp, "wb") as f:
                f.write(raw)
                f.flush()
                os.fsync(f.fileno())
            # chaos-ok: operator-driven republish, upstream of merge
            # transactions — re-run publish_remote after a crash
            os.replace(tmp, os.path.join(mdir, REMOTE_STUB))
            self.stats.record_write("meta", len(raw))
        return remote.root

    # -- read ----------------------------------------------------------------
    def open_model(self, model_id: str):
        if os.path.exists(os.path.join(self.root, model_id, MODEL_MANIFEST)):
            return ModelReader(self.root, model_id, self.stats)
        if self.is_remote(model_id):
            from repro_torch.store.tiered import open_tiered_reader

            return open_tiered_reader(self, model_id)
        # fall through to ModelReader's "no such manifest" error
        return ModelReader(self.root, model_id, self.stats)

    def exists(self, model_id: str) -> bool:
        mdir = os.path.join(self.root, model_id)
        return os.path.exists(os.path.join(mdir, MODEL_MANIFEST)) or os.path.exists(
            os.path.join(mdir, REMOTE_STUB)
        )

    def list_models(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d
            for d in os.listdir(self.root)
            if os.path.exists(os.path.join(self.root, d, MODEL_MANIFEST))
            or os.path.exists(os.path.join(self.root, d, REMOTE_STUB))
        )

    def delete_model(self, model_id: str, force: bool = False) -> None:
        """Delete a stored model, refusing while anything still references
        it (snapshot lineage, merge-graph edges, packed layouts that
        synthesize or attribute blocks from it) — deleting such a model
        would silently corrupt committed snapshots' audit trail or packed
        reads.  ``force=True`` is the explicit escape hatch.
        """
        import shutil

        if not force:
            refs = [r for g in self._delete_guards for r in g(model_id)]
            if refs:
                raise ValueError(
                    f"refusing to delete model {model_id!r}: still "
                    f"referenced by {refs} (pass force=True / --force to "
                    f"delete anyway)"
                )
        mdir = os.path.join(self.root, model_id)
        if os.path.isdir(mdir):
            shutil.rmtree(mdir)


def load_model_arrays(
    store: CheckpointStore, model_id: str, category: str = "base"
) -> Dict[str, np.ndarray]:
    """Convenience full load (used by tests / naive baseline)."""
    with store.open_model(model_id) as reader:
        return {t: reader.read_tensor(t, category) for t in reader.tensor_names()}
