"""Tiered block cache over a remote backend: RAM -> local disk -> remote.

The hierarchy (paper §2.1: expert reads dominate; the fix is to stop
paying for them repeatedly):

* **RAM** — the existing :class:`repro_torch.store.blockcache.
  CachingModelReader` wraps a :class:`TieredReader` exactly like a local
  reader; hits are free (no I/O recorded), admission is bounded by the
  shared ``CacheBudget``.
* **Local disk** — :class:`DiskExtentCache`, a content-hash-keyed extent
  cache shared by every tenant of one MergeService box (wired through
  ``SnapshotStore``).  Extents are immutable files published by atomic
  rename, so a crash mid-fill leaves only an invisible temp file, never
  a torn extent.  Concurrent readers missing on the same extent share
  one fill (single-flight latch — the remote sees exactly one request).
  Hits are charged to the ``expert_disk`` IOStats category: real local
  I/O, but *not* part of the budget-enforced cold-byte term.
* **Remote** — :class:`repro_torch.store.remote.RemoteObjectStore` ranged
  GETs, wrapped in bounded :class:`~repro_torch.store.remote.RetryPolicy`
  retry/backoff against injected faults.  Cold fetches are charged to
  ``expert_remote`` — the bytes the merge budget governs.

Cache keying and invalidation: an extent is keyed by the *tensor
content hash* from the model manifest plus the byte range, so the cache
never needs invalidation messages — republishing a changed model
changes its tensor hashes, new reads key to new extents, and stale ones
age out by LRU eviction.  The locally cached manifest itself is
revalidated against the remote's etag on every reader open.

A coalesced range that the disk tier covers only in part is read piece
by piece (:meth:`TieredReader._read_pieces`): covered pieces from disk,
only the gaps from remote.  The JAX package fetches such a range whole
from remote, so a tier-billed plan (warm blocks at the disk weight)
realized more cold bytes than it planned and ``execute_merge`` refused
it; fully warm and fully cold ranges are read as there.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import blocks as blk
from repro_torch.store.iostats import IOStats
from repro_torch.store.remote import (
    RemoteObjectStore,
    RemoteProfile,
    RetryPolicy,
    model_key,
)
from repro_torch.store.tensorstore import (
    MODEL_MANIFEST,
    BlockReaderMixin,
    CheckpointStore,
    TensorSpec,
)
from repro_torch.testing.chaos import chaos_corrupt, chaos_point

#: locally cached copy of a remote model's manifest (etag-validated)
MANIFEST_CACHE = "MODEL.cache.json"

_EXT_DIR = "ext"
_TMP_DIR = "tmp"


_TMP_NAME = re.compile(r"fill-(\d+)-\d+\.tmp$")


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else
    except OSError:
        return False
    return True


def _key_hash(content_key: str) -> str:
    return hashlib.blake2b(content_key.encode(), digest_size=16).hexdigest()


def _payload_digest(data: bytes) -> str:
    """Self-check digest embedded in an extent's filename (blake2b-8,
    same construction as the catalog block hash)."""
    return hashlib.blake2b(data, digest_size=8).hexdigest()


def _parse_ext_name(fname: str) -> Optional[Tuple[str, int, int, Optional[str]]]:
    """``(kh, offset, nbytes, digest)`` from an extent filename, or None.
    Accepts both the current 4-part self-verifying form
    ``kh__offset__nbytes__digest.ext`` and the legacy 3-part form
    (digest None — length-validated only)."""
    if not fname.endswith(".ext"):
        return None
    parts = fname[: -len(".ext")].split("__")
    try:
        if len(parts) == 4:
            return parts[0], int(parts[1]), int(parts[2]), parts[3]
        if len(parts) == 3:
            return parts[0], int(parts[1]), int(parts[2]), None
    except ValueError:
        return None
    return None


class DiskExtentCache:
    """Crash-safe, content-addressed, *self-verifying* extent cache on
    local disk.

    One extent file per cached byte range, named
    ``<blake2b(content_key)>__<offset>__<nbytes>__<payload-digest>.ext``
    under a 2-hex fanout directory — the name *is* the index entry, so
    the in-memory index can always be rebuilt from a directory listing
    (other processes' fills become visible on rescan).  The name is
    also the extent's integrity contract: rebuild/rescan drop any file
    whose on-disk length disagrees with the ``nbytes`` in its name
    (instead of trusting the filename and serving a truncated extent),
    and every hit re-hashes the payload against the embedded digest —
    a rotted extent is evicted and the read falls through to remote as
    a repair fill, never served corrupt.  Legacy 3-part names (no
    digest) stay readable with length-validation only.

    A read hits when a single cached extent fully covers the requested
    range; partial overlaps miss and fill a new extent (deterministic
    coalescing plus plan reuse make warm re-runs exact-key hits, so
    overlap storage is transient and reclaimed by LRU eviction).

    ``max_bytes`` bounds usage: fills evict least-recently-used extents
    (hit reads refresh mtime) until the new extent fits; an extent
    larger than the whole cap is served but never cached.
    """

    def __init__(self, root: str, max_bytes: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.max_bytes = max_bytes
        os.makedirs(os.path.join(self.root, _EXT_DIR), exist_ok=True)
        os.makedirs(os.path.join(self.root, _TMP_DIR), exist_ok=True)
        self._lock = threading.Lock()
        # extent -> filename payload digest (None for legacy 3-part names)
        self._index: Dict[str, Dict[Tuple[int, int], Optional[str]]] = {}  # guarded-by: _lock
        self._usage = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.fills = 0  # guarded-by: _lock
        self.evictions = 0  # guarded-by: _lock
        #: extents dropped because their file length or payload digest
        #: disagreed with the filename contract (truncation / bit-rot)
        self.corrupt_dropped = 0  # guarded-by: _lock
        self._inflight: Dict[Tuple[str, int, int], threading.Event] = {}  # guarded-by: _lock
        self._rebuild_index()

    # -- paths / index ------------------------------------------------------
    def _ext_dir(self, kh: str) -> str:
        return os.path.join(self.root, _EXT_DIR, kh[:2])

    def _ext_path(
        self, kh: str, offset: int, nbytes: int, digest: Optional[str]
    ) -> str:
        if digest is None:
            name = f"{kh}__{offset}__{nbytes}.ext"
        else:
            name = f"{kh}__{offset}__{nbytes}__{digest}.ext"
        return os.path.join(self._ext_dir(kh), name)

    def _drop_corrupt(self, path: str) -> None:
        """Unlink an extent whose content broke the filename contract."""
        try:
            os.unlink(path)
        except OSError:
            pass
        with self._lock:
            self.corrupt_dropped += 1

    def _scan_dir(
        self, dirpath: str, files: List[str], kh_filter: Optional[str] = None
    ) -> Dict[str, Dict[Tuple[int, int], Optional[str]]]:
        """Parse + length-validate one fanout directory's extent files;
        corrupt (wrong-length) files are unlinked, not indexed — the
        rebuild must never resurrect an extent the filename promises but
        the file cannot honor."""
        found: Dict[str, Dict[Tuple[int, int], Optional[str]]] = {}
        for fname in files:
            parsed = _parse_ext_name(fname)
            if parsed is None:
                continue
            kh, offset, nbytes, digest = parsed
            if kh_filter is not None and kh != kh_filter:
                continue
            path = os.path.join(dirpath, fname)
            try:
                if os.stat(path).st_size != nbytes:
                    self._drop_corrupt(path)
                    continue
            except OSError:
                continue
            found.setdefault(kh, {})[(offset, nbytes)] = digest
        return found

    def _rebuild_index(self) -> None:
        self._sweep_tmp()
        index: Dict[str, Dict[Tuple[int, int], Optional[str]]] = {}
        ext_root = os.path.join(self.root, _EXT_DIR)
        for dirpath, _dirs, files in os.walk(ext_root):
            for kh, entries in self._scan_dir(dirpath, files).items():
                index.setdefault(kh, {}).update(entries)
        with self._lock:
            self._index = index
            self._usage = sum(
                n for entries in index.values() for (_o, n) in entries
            )

    def _sweep_tmp(self) -> int:
        """GC partial fill files (``tmp/fill-<pid>-<seq>.tmp``) left by
        writers that died between write and atomic-rename publish.
        Files owned by *another still-running* pid are in-flight fills
        and kept; dead-pid files, unparseable names, and our own pid's
        leftovers (this runs only at construction, before this instance
        has any fill in flight) are deleted.  Returns the count removed.
        """
        tmp_root = os.path.join(self.root, _TMP_DIR)
        removed = 0
        try:
            names = os.listdir(tmp_root)
        except FileNotFoundError:
            return 0
        for fname in names:
            m = _TMP_NAME.match(fname)
            if m is not None:
                pid = int(m.group(1))
                if pid != os.getpid() and _pid_alive(pid):
                    continue
            try:
                os.unlink(os.path.join(tmp_root, fname))
                removed += 1
            except OSError:
                pass
        return removed

    def _rescan(self, kh: str) -> None:
        """Refresh one key's extents from disk (picks up fills by other
        processes sharing the cache directory); wrong-length files are
        dropped here exactly as at full rebuild.  An extent this process
        indexed while the directory was being listed is kept: the listing
        may predate its publish, and dropping it would send the next
        reader of the range back to remote."""
        with self._lock:
            before = set(self._index.get(kh, {}))
        dirpath = self._ext_dir(kh)
        try:
            names = os.listdir(dirpath)
        except FileNotFoundError:
            names = []
        entries = self._scan_dir(dirpath, names, kh_filter=kh).get(kh, {})
        with self._lock:
            old = self._index.get(kh, {})
            for ext, digest in old.items():
                if ext not in before and ext not in entries:
                    entries[ext] = digest
            self._usage += sum(n for (_o, n) in entries) - sum(
                n for (_o, n) in old
            )
            self._index[kh] = entries

    def _assemble(
        self, kh: str, offset: int, nbytes: int
    ) -> Optional[List[Tuple[Tuple[int, int], int, int]]]:
        """Greedy cover of ``[offset, offset+nbytes)`` by cached extents —
        ``[(extent, lo, hi), ...]`` slices, or None on any gap.  Multi-
        extent assembly matters because fill granularity varies: ANALYZE
        caches per-block extents while the executor reads coalesced
        multi-block runs; a run whose blocks are all cached individually
        is still a warm hit."""
        with self._lock:
            extents = sorted(self._index.get(kh, {}))
        end = offset + nbytes
        plan: List[Tuple[Tuple[int, int], int, int]] = []
        pos = offset
        i = 0
        while pos < end:
            best = None
            best_end = pos
            while i < len(extents) and extents[i][0] <= pos:
                o, n = extents[i]
                if o + n > best_end:
                    best_end = o + n
                    best = (o, n)
                i += 1
            if best is None:
                return None
            plan.append((best, pos, min(best_end, end)))
            pos = best_end
        return plan

    # -- queries ------------------------------------------------------------
    def covers(self, content_key: str, offset: int, nbytes: int) -> bool:
        kh = _key_hash(content_key)
        if self._assemble(kh, offset, nbytes) is not None:
            return True
        self._rescan(kh)
        return self._assemble(kh, offset, nbytes) is not None

    def pieces(
        self, content_key: str, offset: int, nbytes: int
    ) -> List[Tuple[int, int, bool]]:
        """``[offset, offset+nbytes)`` cut at the indexed extents' edges:
        ``(offset, nbytes, covered)`` pieces in order, neighbours of one
        kind merged.  Reads the index as it stands (a miss of
        :meth:`read_verified` has just rescanned it)."""
        with self._lock:
            extents = sorted(self._index.get(_key_hash(content_key), {}))
        end = offset + nbytes
        cuts: List[Tuple[int, int, bool]] = []

        def add(lo: int, hi: int, covered: bool) -> None:
            if cuts and cuts[-1][2] == covered:
                lo = cuts.pop()[0]
            cuts.append((lo, hi, covered))

        pos = offset
        for o, n in extents:
            if o >= end:
                break
            if o + n <= pos:
                continue
            if o > pos:
                add(pos, o, False)
                pos = o
            add(pos, min(o + n, end), True)
            pos = min(o + n, end)
        if pos < end:
            add(pos, end, False)
        return [(lo, hi - lo, covered) for lo, hi, covered in cuts]

    def extents_for(self, content_key: str) -> List[Tuple[int, int]]:
        kh = _key_hash(content_key)
        self._rescan(kh)
        with self._lock:
            return sorted(self._index.get(kh, {}))

    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "extents": sum(len(v) for v in self._index.values()),
                "usage_bytes": self._usage,
                "max_bytes": self.max_bytes or 0,
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
                "corrupt_dropped": self.corrupt_dropped,
            }

    # -- data path ----------------------------------------------------------
    def _remove_extent(self, kh: str, ext: Tuple[int, int]) -> None:
        with self._lock:
            ent = self._index.get(kh, {})
            if ext in ent:
                del ent[ext]
                self._usage -= ext[1]

    def read_verified(
        self, content_key: str, offset: int, nbytes: int,
        check_digest: bool = True,
    ) -> Tuple[Optional[bytes], bool]:
        """Serve a range if cached extents cover it without gaps, after
        verifying every touched extent against its filename contract.

        Returns ``(data, corrupt_dropped)``: on a digest/length mismatch
        the offending extent is evicted on the spot and the result is a
        miss with ``corrupt_dropped=True`` — the caller refills from
        remote and bills the refetch as *repair* traffic, not a plain
        cold miss.

        ``check_digest=False`` skips the payload-digest re-hash (length
        validation still applies): the tiered reader passes it when a
        catalog :class:`~repro_torch.store.integrity.BlockVerifier` is attached
        above, whose end-to-end block hashes strictly subsume the
        extent's write-consistency digest — each byte is then hashed
        once per read, not twice, and a corrupt extent is still caught
        (and evicted via :meth:`invalidate`) by the catalog check.
        """
        kh = _key_hash(content_key)
        plan = self._assemble(kh, offset, nbytes)
        if plan is None:
            self._rescan(kh)
            plan = self._assemble(kh, offset, nbytes)
        if plan is None:
            with self._lock:
                self.misses += 1
            return None, False
        with self._lock:
            digests = dict(self._index.get(kh, {}))
        parts: List[bytes] = []
        for (o, n), lo, hi in plan:
            digest = digests.get((o, n))
            path = self._ext_path(kh, o, n, digest)
            try:
                with open(path, "rb") as f:
                    if digest is None or not check_digest:
                        # legacy extent (length-validated at index time),
                        # or the caller's catalog verifier subsumes the
                        # digest: serve the requested slice only
                        f.seek(lo - o)
                        chunk = f.read(hi - lo)
                        whole = None
                    else:
                        whole = f.read()
                        chunk = whole[lo - o : hi - o]
                os.utime(path, None)  # LRU touch
            except (FileNotFoundError, OSError):
                # evicted (possibly by another process) between index + open
                self._remove_extent(kh, (o, n))
                with self._lock:
                    self.misses += 1
                return None, False
            corrupt = len(chunk) != hi - lo
            if not corrupt and whole is not None:
                corrupt = len(whole) != n or _payload_digest(whole) != digest
            if corrupt:
                # the file does not honor its own name: evict it rather
                # than ever serving the bytes
                self._remove_extent(kh, (o, n))
                self._drop_corrupt(path)
                with self._lock:
                    self.misses += 1
                return None, True
            parts.append(chunk)
        with self._lock:
            self.hits += 1
        return (parts[0] if len(parts) == 1 else b"".join(parts)), False

    def read(self, content_key: str, offset: int, nbytes: int) -> Optional[bytes]:
        """Verified read without the corruption signal (compat surface)."""
        data, _dropped = self.read_verified(content_key, offset, nbytes)
        return data

    def invalidate(
        self, content_key: str, offset: int, nbytes: int,
        corrupt: bool = False,
    ) -> int:
        """Evict every cached extent overlapping ``[offset,
        offset+nbytes)`` — read-repair calls this before refetching so a
        corrupt extent can never serve the repaired range again.
        ``corrupt=True`` (the read-repair path) counts the drops as
        ``corrupt_dropped`` rather than plain evictions, so the cache's
        rot statistics stay truthful when the catalog verifier — not the
        extent digest — is what caught the damage.  Returns the number
        of extents removed."""
        kh = _key_hash(content_key)
        self._rescan(kh)
        with self._lock:
            victims = [
                (ext, digest)
                for ext, digest in self._index.get(kh, {}).items()
                if ext[0] < offset + nbytes and offset < ext[0] + ext[1]
            ]
        removed = 0
        for (o, n), digest in victims:
            try:
                os.remove(self._ext_path(kh, o, n, digest))
            except FileNotFoundError:
                pass
            self._remove_extent(kh, (o, n))
            with self._lock:
                if corrupt:
                    self.corrupt_dropped += 1
                else:
                    self.evictions += 1
            removed += 1
        return removed

    def scrub(self, repair: bool = False, on_bytes=None) -> Dict[str, object]:
        """Re-validate every cached extent against its filename contract
        (length always; payload digest when the name carries one) — the
        mergefsck cache pass.  ``on_bytes(n)`` is invoked per extent read
        so the caller can rate-limit scrub I/O.  With ``repair=True``
        corrupt extents are unlinked and dropped from the index (a cache
        entry is re-fetchable, so dropping *is* the repair); otherwise
        they are only reported.  Returns scanned/verified/corrupt/
        repaired counters plus the corrupt file paths and bytes read."""
        self._rebuild_index()  # adopt other processes' fills; drop bad lengths
        with self._lock:
            snapshot = {kh: dict(v) for kh, v in self._index.items()}
        res: Dict[str, object] = {
            "scanned": 0, "verified": 0, "corrupt": 0, "repaired": 0,
            "bytes": 0, "corrupt_paths": [],
        }
        for kh in sorted(snapshot):
            for (offset, nbytes), digest in sorted(snapshot[kh].items()):
                res["scanned"] += 1
                path = self._ext_path(kh, offset, nbytes, digest)
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    continue  # evicted by a concurrent reader/writer
                res["bytes"] += len(data)
                if on_bytes is not None:
                    on_bytes(len(data))
                ok = len(data) == nbytes and (
                    digest is None or _payload_digest(data) == digest
                )
                if ok:
                    res["verified"] += 1
                    continue
                res["corrupt"] += 1
                res["corrupt_paths"].append(path)
                if repair:
                    self._drop_corrupt(path)
                    self._remove_extent(kh, (offset, nbytes))
                    res["repaired"] += 1
        return res

    def put(self, content_key: str, offset: int, data: bytes) -> bool:
        """Cache one extent (atomic rename publish). Returns False when
        the extent is larger than the entire cap and was not cached."""
        nbytes = len(data)
        if self.max_bytes is not None and nbytes > self.max_bytes:
            return False
        if self.max_bytes is not None:
            self._evict_to(self.max_bytes - nbytes)
        kh = _key_hash(content_key)
        # the filename contract is sealed over the CLEAN payload before
        # the at-rest corruption point below: injected rot lands in the
        # file body, disagrees with the embedded digest, and must be
        # caught by the next verified read
        digest = _payload_digest(data)
        data = chaos_corrupt("cache:extent", data)
        path = self._ext_path(kh, offset, nbytes, digest)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._lock:
            self._seq += 1
            seq = self._seq
        tmp = os.path.join(self.root, _TMP_DIR, f"fill-{os.getpid()}-{seq}.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        # a crash here leaves only the invisible temp file — swept by
        # the next _rebuild_index, never a torn extent
        chaos_point("cache:fill")
        os.replace(tmp, path)
        with self._lock:
            ent = self._index.setdefault(kh, {})
            if (offset, nbytes) not in ent:
                ent[(offset, nbytes)] = digest
                self._usage += nbytes
            self.fills += 1
        return True

    def fill(
        self,
        content_key: str,
        offset: int,
        nbytes: int,
        fetch: Callable[[], bytes],
    ) -> Tuple[bytes, bool]:
        """Single-flight miss fill: concurrent callers for the same extent
        share one ``fetch`` — the rest wait and re-read from disk.

        Returns ``(data, we_fetched)``; ``we_fetched=False`` means the
        range was served warm from another caller's fill.

        A caller that becomes the filler first looks at the cache again:
        one that reached the lock just after an earlier filler published
        the extent and left the in-flight table would otherwise fetch it
        a second time.
        """
        key = (_key_hash(content_key), offset, nbytes)
        while True:
            with self._lock:
                ev = self._inflight.get(key)
                we_fill = ev is None
                if we_fill:
                    ev = threading.Event()
                    self._inflight[key] = ev
            if we_fill:
                try:
                    if self._assemble(key[0], offset, nbytes) is not None:
                        data = self.read(content_key, offset, nbytes)
                        if data is not None:
                            return data, False
                    data = fetch()
                    self.put(content_key, offset, data)
                    return data, True
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                    ev.set()
            ev.wait()
            data = self.read(content_key, offset, nbytes)
            if data is not None:
                return data, False
            # the filler failed (or the extent was immediately evicted):
            # loop and become the filler ourselves

    # -- eviction -----------------------------------------------------------
    def _evict_to(self, target: int) -> int:
        """Evict LRU extents until usage <= max(target, 0)."""
        target = max(0, target)
        with self._lock:
            if self._usage <= target:
                return 0
        victims: List[Tuple[float, int, str, str, Tuple[int, int]]] = []
        ext_root = os.path.join(self.root, _EXT_DIR)
        for dirpath, _dirs, files in os.walk(ext_root):
            for fname in files:
                if not fname.endswith(".ext"):
                    continue
                path = os.path.join(dirpath, fname)
                try:
                    st = os.stat(path)
                except FileNotFoundError:
                    continue
                parsed = _parse_ext_name(fname)
                if parsed is None:
                    continue
                kh, offset, nbytes, _digest = parsed
                ext = (offset, nbytes)
                victims.append((st.st_mtime, st.st_size, path, kh, ext))
        victims.sort()
        freed = 0
        for _mtime, size, path, kh, ext in victims:
            with self._lock:
                if self._usage <= target:
                    break
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
            with self._lock:
                ent = self._index.get(kh, {})
                if ext in ent:
                    del ent[ext]
                    self._usage -= ext[1]
                self.evictions += 1
            freed += size
        return freed

    def evict(self, target_bytes: int = 0) -> int:
        """Explicit eviction (CLI / operator): shrink usage to
        ``target_bytes`` (0 = clear everything). Returns bytes freed."""
        return self._evict_to(target_bytes)


class TieredReader(BlockReaderMixin):
    """Block-granular reader over a remote model, served through the
    local-disk extent cache.  Drop-in for :class:`ModelReader` — the
    executor, delta iterator, and ``CachingModelReader`` (the RAM tier)
    see the identical surface.

    IOStats tagging: expert reads become ``expert_disk`` (warm hit) or
    ``expert_remote`` (cold fetch); every other category (``base``,
    ``analyze``, ``meta``...) keeps its name regardless of tier, so the
    paper's cost decomposition is unchanged and the budget term counts
    exactly the cold expert bytes.
    """

    #: hints execute_merge to deepen the pipelined engine's prefetch
    #: (more read threads / windows in flight) to hide remote latency
    prefers_deep_prefetch = True

    def __init__(
        self,
        model_id: str,
        remote: RemoteObjectStore,
        stats: IOStats,
        local_dir: str,
        disk: Optional[DiskExtentCache] = None,
        retry: Optional[RetryPolicy] = None,
    ):
        self.model_id = model_id
        self.remote = remote
        self.stats = stats
        self.local_dir = local_dir
        self.disk = disk
        self.retry = retry or RetryPolicy()
        #: bytes re-fetched from remote for ranges that were disk-cached
        #: when this reader first touched the tensor (mid-run eviction);
        #: the executor widens its budget-soundness slack by the delta
        self.evict_refetch_bytes = 0  # guarded-by: _mut
        #: bytes re-fetched from remote to repair corruption (a dropped
        #: disk-cache extent or a failed catalog-hash check); billed to
        #: ``expert_repair`` and folded into executor budget slack the
        #: same way evict_refetch_bytes is — disjoint counters: a given
        #: refetch bumps exactly one of the two
        self.repair_bytes = 0  # guarded-by: _mut
        #: verify-on-read hook (repro_torch.store.integrity.BlockVerifier);
        #: attached by the executor, consulted by BlockReaderMixin
        self.verifier = None
        #: remote requests that failed and were retried (fault injection)
        self.retries = 0  # guarded-by: _mut
        self._mut = threading.Lock()
        self._cover_snapshots: Dict[str, List[Tuple[int, int]]] = {}  # guarded-by: _mut
        doc = self._load_manifest()
        self.meta: Dict = doc.get("meta", {})
        self.specs: Dict[str, TensorSpec] = {
            name: TensorSpec(spec) for name, spec in doc["tensors"].items()
        }

    # -- manifest (etag-validated local cache) ------------------------------
    def _load_manifest(self) -> Dict:
        mkey = model_key(self.model_id, MODEL_MANIFEST)
        head = self.remote.head(mkey)
        cache_path = os.path.join(self.local_dir, MANIFEST_CACHE)
        try:
            with open(cache_path, "rb") as f:
                cached = json.loads(f.read())
            if cached.get("etag") == head["etag"]:
                # manifest served from the local cache: meta-sized local read
                raw_len = len(json.dumps(cached["manifest"]))
                self.stats.record_read("meta", raw_len)
                return cached["manifest"]
        except (FileNotFoundError, ValueError, KeyError):
            pass
        raw = self.retry.call(
            lambda: self.remote.get_range(mkey), on_retry=self._on_retry
        )
        self.stats.record_read("meta", len(raw))
        doc = json.loads(raw)
        os.makedirs(self.local_dir, exist_ok=True)
        tmp = cache_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"etag": head["etag"], "manifest": doc}, f)
        # fsync-ok: local manifest cache — a torn file fails the JSON
        # parse (or the etag check) above and is refetched from remote
        # chaos-ok: soft state, not a durability edge; cache:fill covers
        # the disk tier's real persistence path
        os.replace(tmp, cache_path)
        return doc

    # -- helpers ------------------------------------------------------------
    def _on_retry(self, _attempt: int) -> None:
        with self._mut:
            self.retries += 1

    def _content_key(self, tensor_id: str) -> str:
        spec = self.specs[tensor_id]
        return spec.get("hash") or f"{self.model_id}:{spec['file']}"

    @staticmethod
    def _tier_category(category: str, tier: str) -> str:
        if category in ("expert", "expert_packed"):
            if tier == "repair":
                return "expert_repair"
            return "expert_remote" if tier == "remote" else "expert_disk"
        return category

    def _record(self, category: str, tier: str, payload: int, waste: int) -> None:
        self.stats.record_read(self._tier_category(category, tier), payload)
        if waste:
            self.stats.record_read("other", waste)

    def _fetch_remote(self, tensor_id: str, offset: int, nbytes: int) -> Callable[[], bytes]:
        key = model_key(self.model_id, self.specs[tensor_id]["file"])
        # deferred fetch thunk: read_range records the bytes at the
        # serving tier via _record, once it knows which tier served it
        return lambda: self.retry.call(
            lambda: self.remote.get_range(key, offset, nbytes),  # unaccounted-ok: recorded by read_range via _record
            on_retry=self._on_retry,
        )

    # -- the read path -------------------------------------------------------
    def read_range(
        self,
        tensor_id: str,
        offset: int,
        nbytes: int,
        category: str,
        waste_nbytes: int = 0,
        selected: Optional[Sequence[Tuple[int, int]]] = None,
    ) -> bytes:
        """Read ``[offset, offset+nbytes)`` from the disk tier where it
        holds the bytes, else from remote, and bill each byte to the tier
        that served it.  ``waste_nbytes`` of the range were not requested
        (a coalesced run's gaps); ``selected`` names the requested
        ``(offset, nbytes)`` ranges, so a run the disk tier covers in part
        bills each piece for the requested bytes inside it."""
        payload = nbytes - waste_nbytes
        if selected is None:
            if waste_nbytes:
                raise ValueError("read_range: waste_nbytes needs the "
                                 "selected ranges around it")
            selected = [(offset, nbytes)]
        if self.disk is None:
            data = self._fetch_remote(tensor_id, offset, nbytes)()
            self._record(category, "remote", payload, waste_nbytes)
            return data
        ckey = self._content_key(tensor_id)
        with self._mut:
            if ckey not in self._cover_snapshots:
                # what the disk tier held when this reader first touched
                # the tensor — a later miss inside this set means the
                # extent was evicted mid-run and must be re-fetched
                self._cover_snapshots[ckey] = self.disk.extents_for(ckey)
            snap = self._cover_snapshots[ckey]
        # hash once per boundary: with an active catalog verifier above
        # (strictly stronger — end-to-end hashes, catches stale-extent
        # substitution the local digest cannot), skip the extent-digest
        # re-hash; without one, the digest remains the disk tier's guard
        v = self.verifier
        data, corrupt_dropped = self.disk.read_verified(
            ckey, offset, nbytes,
            check_digest=v is None or not v.active(),
        )
        if data is not None:
            self.stats.record_cache("disk", nbytes, hit=True)
            self._record(category, "disk", payload, waste_nbytes)
            return data
        if not corrupt_dropped:
            pieces = self.disk.pieces(ckey, offset, nbytes)
            if len(pieces) > 1:
                return self._read_pieces(
                    tensor_id, ckey, pieces, category, selected, snap
                )
        return self._miss(tensor_id, ckey, offset, nbytes, category,
                          waste_nbytes, snap, corrupt_dropped)

    def _read_pieces(
        self,
        tensor_id: str,
        ckey: str,
        pieces: List[Tuple[int, int, bool]],
        category: str,
        selected: Sequence[Tuple[int, int]],
        snap: List[Tuple[int, int]],
    ) -> bytes:
        """A range the disk tier covers in part (a coalesced run of warm
        and cold blocks): each covered piece is read from disk and billed
        to it, only the uncovered pieces are fetched (and filled) from
        remote.  This is the port's repair of tier billing over coalesced
        runs: the planner bills a disk-cached block at the disk tier's
        weight, and the reference fetches such a run whole from remote,
        so its realized remote bytes can pass the plan.

        Each piece bills its tier for the ``selected`` bytes inside it;
        the rest of the piece (the run's unrequested gap bytes that lie
        there) is waste, tagged ``other``, whichever tier the gap is in."""
        waste = [n - sum(max(0, min(o + n, so + sn) - max(o, so))
                         for so, sn in selected)
                 for o, n, _covered in pieces]
        v = self.verifier
        parts = []
        for (o, n, covered), w in zip(pieces, waste):
            data, corrupt = None, False
            if covered:
                data, corrupt = self.disk.read_verified(
                    ckey, o, n, check_digest=v is None or not v.active(),
                )
            if data is not None:
                self.stats.record_cache("disk", n, hit=True)
                self._record(category, "disk", n - w, w)
            else:
                data = self._miss(tensor_id, ckey, o, n, category, w, snap,
                                  corrupt)
            parts.append(data)
        return b"".join(parts)

    def _miss(
        self,
        tensor_id: str,
        ckey: str,
        offset: int,
        nbytes: int,
        category: str,
        waste_nbytes: int,
        snap: List[Tuple[int, int]],
        corrupt_dropped: bool,
    ) -> bytes:
        """Fetch a range the disk tier does not serve from remote (single-
        flight through the disk tier's ``fill``) and bill it."""
        payload = nbytes - waste_nbytes
        if corrupt_dropped:
            # read-repair, disk tier: the cache just evicted an extent
            # whose payload broke its filename contract; the refill is
            # repair traffic, not an eviction refetch or a cold miss
            self.stats.record_cache("disk", nbytes, hit=False)
            data, we_fetched = self.disk.fill(
                ckey, offset, nbytes,
                self._fetch_remote(tensor_id, offset, nbytes),
            )
            if we_fetched:
                with self._mut:
                    self.repair_bytes += payload
                self._record(category, "repair", payload, waste_nbytes)
            else:
                self._record(category, "disk", payload, waste_nbytes)
            return data
        if any(o <= offset and offset + nbytes <= o + n for o, n in snap):
            with self._mut:
                self.evict_refetch_bytes += payload
        self.stats.record_cache("disk", nbytes, hit=False)
        data, we_fetched = self.disk.fill(
            ckey, offset, nbytes, self._fetch_remote(tensor_id, offset, nbytes)
        )
        # a waiter served by another caller's fill got the bytes warm
        self._record(category, "remote" if we_fetched else "disk", payload, waste_nbytes)
        return data

    # -- read-repair ---------------------------------------------------------
    def repair_range(
        self,
        tensor_id: str,
        offset: int,
        nbytes: int,
        category: str,
        expected: Optional[str] = None,
    ) -> bytes:
        """Repair one range that failed catalog-hash verification:
        invalidate every covering disk-cache extent (the cached copy is
        tainted even if *it* hashed clean — it may have been filled from
        the same corrupt GET), refetch from remote under the bounded
        :class:`RetryPolicy`, verify the fresh bytes against ``expected``
        *before* caching them, and bill the traffic to ``expert_repair``.

        Raises :class:`~repro_torch.store.integrity.CorruptBlockError` when the
        refetched bytes still mismatch — a persistently corrupt remote
        object is unrepairable from this tier and must fail the job, not
        poison the cache.
        """
        if self.disk is not None:
            self.disk.invalidate(
                self._content_key(tensor_id), offset, nbytes, corrupt=True
            )
        data = self._fetch_remote(tensor_id, offset, nbytes)()
        if expected is not None:
            from repro_torch.store.integrity import CorruptBlockError, block_hash

            actual = block_hash(data)
            if actual != expected:
                raise CorruptBlockError(
                    f"read-repair failed for {self.model_id}/{tensor_id}"
                    f"[{offset}:{offset + nbytes}]: refetched bytes hash "
                    f"{actual}, catalog says {expected} — remote object is "
                    f"corrupt at the source",
                    tier="remote",
                    model_id=self.model_id,
                    tensor_id=tensor_id,
                    expected=expected,
                    actual=actual,
                )
        if self.disk is not None:
            self.disk.put(self._content_key(tensor_id), offset, data)
        with self._mut:
            self.repair_bytes += nbytes
        self.stats.record_read(self._tier_category(category, "repair"), nbytes)
        return data


def open_tiered_reader(store: CheckpointStore, model_id: str) -> TieredReader:
    """Open a remote-registered model through the tier hierarchy (used by
    ``CheckpointStore.open_model`` when it finds a ``REMOTE.json`` stub)."""
    stub = store.remote_stub(model_id)
    remote = store.remote_store(stub["remote_root"])
    if stub.get("profile"):
        remote.profile = RemoteProfile.from_dict(stub["profile"])
    disk = store.disk_cache if stub.get("disk_cache", True) else None
    return TieredReader(
        model_id,
        remote,
        store.stats,
        local_dir=os.path.join(store.root, model_id),
        disk=disk,
    )


def cached_remote_specs(store: CheckpointStore, model_id: str) -> Optional[Dict]:
    """Tensor specs of a remote model from its locally cached manifest —
    metadata only, never touches the remote.  None when the manifest has
    not been fetched yet (probe falls back to full remote billing)."""
    path = os.path.join(store.root, model_id, MANIFEST_CACHE)
    try:
        with open(path, "rb") as f:
            return json.loads(f.read())["manifest"]["tensors"]
    except (FileNotFoundError, ValueError, KeyError):
        return None


def make_tier_probe(
    store: CheckpointStore,
    block_size: int,
    ram_readers: Optional[Dict[str, object]] = None,
    costs=None,
):
    """Build a planner tier probe: ``probe(expert_id, tensor_id,
    block_idx, nbytes) -> billing weight`` in [0, 1].

    Local models bill at full weight (1.0, unchanged semantics); remote
    models bill by the tier that would serve the block right now — free
    for RAM-cached blocks, cheap for disk-cached extents, full for cold
    remote fetches — so a fixed budget admits strictly more blocks as
    the warm tiers fill up.  Pure metadata: probing never performs
    remote I/O.
    """
    if costs is None:
        from repro_torch.core.cost import TierCostModel

        costs = TierCostModel()
    specs_cache: Dict[str, object] = {}

    def probe(expert_id: str, tensor_id: str, block_idx: int, nbytes: int) -> float:
        if expert_id not in specs_cache:
            specs_cache[expert_id] = (
                cached_remote_specs(store, expert_id)
                if store.is_remote(expert_id)
                else "local"
            )
        info = specs_cache[expert_id]
        if info == "local":
            return 1.0
        reader = (ram_readers or {}).get(expert_id)
        if reader is not None:
            has = getattr(reader, "has_block", None)
            if has is not None and has(tensor_id, block_idx, block_size):
                return costs.ram_weight
        if info is None:
            return costs.remote_weight  # manifest not cached yet: bill cold
        spec = info.get(tensor_id)
        if spec is None:
            return costs.remote_weight
        rng = blk.block_range(int(spec["nbytes"]), block_idx, block_size)
        ckey = spec.get("hash") or f"{expert_id}:{spec['file']}"
        if store.disk_cache is not None and store.disk_cache.covers(
            ckey, rng.offset, rng.nbytes
        ):
            return costs.disk_weight
        return costs.remote_weight

    return probe
