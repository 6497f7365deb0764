"""End-to-end block integrity: the verification contract (docs/STORAGE.md).

ANALYZE already persists a blake2b-8 content hash per (model, tensor,
block) into the catalog, and the packed store keys extents by the same
hash — until now both were used only as join/dedup keys.  This module
turns them into a *verification contract*: every tier boundary that
serves parameter bytes re-hashes what it read and compares against the
cataloged value, so a bit-flipped remote GET, a rotted disk-cache
extent, or a corrupt packed extent is **detected at read time** instead
of silently merged into a committed snapshot (ZFS-style
checksum-on-read).

Enforcement points (each tier verifies what *it* serves):

* flat :class:`~repro_torch.store.tensorstore.ModelReader` block reads —
  via an attached :class:`BlockVerifier` (the ``flat`` policy knob is
  the documented opt-out for local hot paths);
* :class:`~repro_torch.store.tiered.TieredReader` block reads (remote GET
  payloads and disk-cache hits) — via an attached
  :class:`BlockVerifier`, with **read-repair**: a mismatch evicts the
  covering disk-cache extents and refetches from remote
  (``TieredReader.repair_range``), billed to the ``expert_repair``
  IOStats category;
* :class:`~repro_torch.store.tiered.DiskExtentCache` fills *and* hits —
  self-verifying extent files (payload digest in the filename) checked
  on every hit, corrupt extents evicted instead of served;
* :class:`~repro_torch.store.packed.PackedLayout` extent reads — decoded
  logical bytes are re-hashed against the extent's own content-hash
  key; corrupt extents are quarantined and reads fall back to the flat
  source checkpoint.

A verification failure that read-repair cannot fix raises
:class:`CorruptBlockError` — an ``IOError`` so the MergeService's
transient-failure classifier requeues the job (bounded by
``max_job_attempts``); a poisoned store quarantines the job rather
than ever committing a silently wrong snapshot.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Tuple

#: categories whose reads are never verified: ANALYZE *creates* the
#: block hashes (verifying against a previous analysis would reject
#: legitimate re-analysis), and repack verifies via extent keys instead
SKIP_CATEGORIES = ("analyze",)


def block_hash(data: bytes) -> str:
    """The contract hash: blake2b-8 of the raw logical block bytes —
    identical to ANALYZE's BlockMeta hash and the packed store's
    extent content hash, so all three layers share one join key."""
    return hashlib.blake2b(data, digest_size=8).hexdigest()


class CorruptBlockError(IOError):
    """A block failed hash verification and could not be repaired.

    Subclasses ``IOError`` on purpose: the service's
    :func:`~repro_torch.store.retry.is_transient` classifier treats it as a
    retryable infrastructure fault, so the job flows through the
    journal-preserving requeue path and is quarantined by the attempt
    cap if the corruption is persistent — never a silent wrong answer.

    Carries full provenance: the serving ``tier`` (``flat`` / ``disk``
    / ``remote`` / ``packed``), the model/tensor/block coordinates, and
    the expected vs actual digests.
    """

    def __init__(
        self,
        message: str,
        tier: str = "unknown",
        model_id: Optional[str] = None,
        tensor_id: Optional[str] = None,
        block_idx: Optional[int] = None,
        extent_key: Optional[str] = None,
        expected: Optional[str] = None,
        actual: Optional[str] = None,
    ):
        super().__init__(message)
        self.tier = tier
        self.model_id = model_id
        self.tensor_id = tensor_id
        self.block_idx = block_idx
        self.extent_key = extent_key
        self.expected = expected
        self.actual = actual


@dataclasses.dataclass(frozen=True)
class VerifyPolicy:
    """Which tiers enforce the verification contract.

    ``remote`` (tiered readers: remote GETs + disk-cache hits) and
    ``packed`` (extent decode self-check) default on — those tiers
    cross machine/process/durability boundaries where corruption is a
    real threat model.  ``flat`` also defaults on but is the documented
    opt-out knob for local hot paths where the checkpoint files are
    trusted (e.g. a benchmark isolating hashing overhead).
    """

    flat: bool = True
    remote: bool = True
    packed: bool = True

    @staticmethod
    def coerce(value) -> Optional["VerifyPolicy"]:
        """Normalize the executor's ``verify`` knob: ``True`` -> default
        policy, ``False``/``None`` -> verification off, a policy passes
        through."""
        if value is None or value is False:
            return None
        if value is True:
            return VerifyPolicy()
        if isinstance(value, VerifyPolicy):
            return value
        raise TypeError(f"verify must be bool or VerifyPolicy, got {value!r}")


class BlockVerifier:
    """Catalog-backed verify-on-read for one model's block reads.

    Attached to a reader (``reader.verifier = BlockVerifier(...)``);
    :class:`~repro_torch.store.tensorstore.BlockReaderMixin` calls
    :meth:`check` on every block it slices out of a physical read.
    The hash table loads lazily from ``catalog.block_metas`` on the
    first checked read (metadata-sized, one query per model) — a model
    with no analysis rows at this block size verifies nothing, which
    also auto-skips adapter factor tensors (their BlockMeta rows live
    on the *target* tensor's virtual grid, not the factors).

    Thread-safe: the executor's prefetch pool checks blocks from many
    threads (the catalog handles per-thread sqlite connections).
    """

    def __init__(self, catalog, model_id: str, block_size: int, tier: str = "flat"):
        self.catalog = catalog
        self.model_id = model_id
        self.block_size = block_size
        self.tier = tier
        #: racy += on the hot path by design: a torn increment under
        #: thread collision undercounts a statistics counter, while a
        #: per-block lock serializes the prefetch pool (see check())
        self.verified_blocks = 0
        self.repaired_blocks = 0  # guarded-by: _lock
        self.corrupt_blocks = 0  # guarded-by: _lock
        self._lock = threading.Lock()
        #: written exactly once under _lock (in _table()), immutable
        #: after — readers may snapshot the reference without the lock
        self._hashes: Optional[Dict[Tuple[str, int], str]] = None

    def _table(self) -> Dict[Tuple[str, int], str]:
        with self._lock:
            if self._hashes is None:
                self._hashes = {
                    (row[0], row[1]): row[3]
                    for row in self.catalog.block_metas(
                        self.model_id, self.block_size
                    )
                    if row[3]
                }
            return self._hashes

    def active(self) -> bool:
        """Whether this model has any cataloged hashes at this grid.  A
        verifier with an empty table enforces nothing, so lower tiers
        (e.g. the disk cache's extent digest) keep their own weaker
        integrity checks in force rather than deferring to it.
        Called per physical read — uses the same lock-free table
        snapshot as :meth:`check`."""
        table = self._hashes
        if table is None:
            table = self._table()
        return bool(table)

    def expected(self, tensor_id: str, block_idx: int) -> Optional[str]:
        return self._table().get((tensor_id, block_idx))

    def check(
        self,
        reader,
        tensor_id: str,
        block_idx: int,
        offset: int,
        nbytes: int,
        data: bytes,
        category: str,
    ) -> bytes:
        """Verify one block's raw bytes; returns the (possibly repaired)
        bytes or raises :class:`CorruptBlockError`.

        On mismatch, a reader exposing ``repair_range`` (the tiered
        reader) gets one read-repair attempt — evict + refetch, verified
        against the same expected hash inside the repair itself; readers
        without a second copy of the bytes (flat local) fail directly.
        """
        if category in SKIP_CATEGORIES:
            return data
        # lock-free hot path: the table reference is written once (under
        # _lock, inside _table()) and immutable afterwards, and blake2b
        # releases the GIL for block-sized payloads — taking _lock per
        # block would serialize the executor's whole prefetch pool on
        # this one verifier and cost more wall time than the hash itself
        table = self._hashes
        if table is None:
            table = self._table()
        want = table.get((tensor_id, block_idx))
        if want is None:
            return data  # not analyzed at this grid: no contract to enforce
        if block_hash(data) == want:
            self.verified_blocks += 1
            return data
        with self._lock:
            self.corrupt_blocks += 1
        repair = getattr(reader, "repair_range", None)
        if repair is None:
            raise CorruptBlockError(
                f"corrupt block {self.model_id}/{tensor_id}[{block_idx}] "
                f"(tier={self.tier}): hash {block_hash(data)} != cataloged "
                f"{want}, and this tier has no second copy to repair from",
                tier=self.tier,
                model_id=self.model_id,
                tensor_id=tensor_id,
                block_idx=block_idx,
                expected=want,
                actual=block_hash(data),
            )
        # read-repair: raises CorruptBlockError itself when the refetched
        # bytes still do not match (persistently corrupt remote object)
        fresh = repair(tensor_id, offset, nbytes, category, expected=want)
        with self._lock:
            self.repaired_blocks += 1
        return fresh

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "verified": self.verified_blocks,
                "repaired": self.repaired_blocks,
                "corrupt": self.corrupt_blocks,
            }


def attach_verifier(
    reader, catalog, model_id: str, block_size: int,
    policy: Optional[VerifyPolicy],
):
    """Wire the verification contract onto one opened reader.

    Unwraps a :class:`~repro_torch.store.blockcache.CachingModelReader` (the
    RAM tier calls the inner reader's block methods, so blocks are
    verified at cache admission).  Packed members verify via the
    layout's extent self-check instead of a catalog table — the extent
    key *is* the cataloged hash.  Returns the attached
    :class:`BlockVerifier` (or None when the tier verifies internally
    or the policy disables it).  A disabled policy explicitly detaches,
    so a reader reused across scheduling windows honors the latest
    window's knob.
    """
    inner = getattr(reader, "_reader", reader)
    layout = getattr(inner, "layout", None)
    if layout is not None:  # packed member: extent-key self-check
        layout.verify = bool(policy is not None and policy.packed)
        return None
    if not hasattr(inner, "read_range"):
        return None
    tiered = hasattr(inner, "evict_refetch_bytes")
    enabled = policy is not None and (policy.remote if tiered else policy.flat)
    if not enabled:
        inner.verifier = None
        return None
    v = BlockVerifier(
        catalog, model_id, block_size, tier="remote" if tiered else "flat"
    )
    inner.verifier = v
    return v
