"""Shared expert-block cache — cross-job read amortization (API v2).

When a batch of merge jobs selects overlapping expert blocks, each
physical block only needs to be read once: the first job's read populates
an in-memory cache and every later job that selected the same
``(tensor, block)`` is served from memory with **zero** storage I/O.
This turns a J-job × K-expert sweep from ``O(K·J)`` expert reads toward
``O(K)`` — the paper's "expert reads are the optimization target" insight
lifted from a single merge to a workload.

:class:`CachingModelReader` wraps a :class:`~repro_torch.store.tensorstore.ModelReader`
with the exact read surface the executor and
:class:`~repro_torch.core.delta_iterator.DeltaIterator` use (``read_block``,
``read_blocks_coalesced``, ``read_tensor``), so it can be injected into
``execute_merge(expert_readers=...)`` transparently.  I/O accounting
stays honest: only cache *misses* touch the storage layer and record
tagged bytes; hits are free, which is precisely the accounting the
shared-read schedule claims.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.store.tensorstore import ModelReader, TensorSpec


class CacheBudget:
    """Byte budget shared by a group of caching readers (one per batch
    level), so the documented cap bounds their *combined* footprint.
    Admission is atomic — concurrent readers (pipelined prefetch pool)
    cannot jointly overshoot the cap."""

    def __init__(self, max_bytes: Optional[int]):
        self.max_bytes = max_bytes
        self.used = 0  # guarded-by: _lock
        self._lock = threading.Lock()

    def admit(self, nbytes: int) -> bool:
        with self._lock:
            if self.max_bytes is not None and self.used + nbytes > self.max_bytes:
                return False
            self.used += nbytes
            return True

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.used -= nbytes


class CachingModelReader:
    """Read-through block cache over one stored model.

    ``max_bytes`` (or a shared ``budget``) bounds the cache: once the cap
    is reached, further misses are passed through uncached (no eviction —
    predictable accounting beats hit rate for budget soundness proofs).
    """

    def __init__(
        self,
        reader: ModelReader,
        max_bytes: Optional[int] = None,
        budget: Optional[CacheBudget] = None,
        stats=None,
    ):
        self._reader = reader
        self.budget = budget or CacheBudget(max_bytes)
        self._blocks: Dict[Tuple[str, int, int], np.ndarray] = {}  # guarded-by: _lock
        self._tensors: Dict[str, np.ndarray] = {}  # guarded-by: _lock
        #: guards cache maps + counters; physical reads happen outside the
        #: lock (pread is already concurrent-safe), so a racing miss may
        #: read a block twice — accounting stays honest, never unsound.
        self._lock = threading.Lock()
        self.cached_bytes = 0  # guarded-by: _lock
        self.hits = 0  # guarded-by: _lock
        self.misses = 0  # guarded-by: _lock
        self.bytes_saved = 0  # guarded-by: _lock
        #: optional IOStats for RAM-tier hit/miss counters (hits still
        #: record zero read bytes — they are free by construction)
        self.stats = stats

    def _record_cache(self, nbytes: int, hit: bool) -> None:
        if self.stats is not None:
            self.stats.record_cache("ram", nbytes, hit)

    # -- delegated structure ----------------------------------------------
    @property
    def model_id(self) -> str:
        return self._reader.model_id

    @property
    def meta(self) -> Dict:
        return self._reader.meta

    @property
    def specs(self) -> Dict[str, TensorSpec]:
        return self._reader.specs

    def spec(self, tensor_id: str) -> TensorSpec:
        return self._reader.spec(tensor_id)

    def tensor_names(self) -> List[str]:
        return self._reader.tensor_names()

    def total_nbytes(self) -> int:
        return self._reader.total_nbytes()

    def num_blocks(self, tensor_id: str, block_size: int) -> int:
        return self._reader.num_blocks(tensor_id, block_size)

    def elided_blocks(self, tensor_id: str) -> frozenset:
        """Packed-layout surface passthrough: blocks the DeltaIterator
        synthesizes without any read (empty for flat readers)."""
        fn = getattr(self._reader, "elided_blocks", None)
        return fn(tensor_id) if fn is not None else frozenset()

    # -- caching reads -----------------------------------------------------
    # unguarded-ok: caller holds self._lock (every call site acquires it)
    def _admit(self, key: Tuple[str, int, int], arr: np.ndarray) -> None:
        if key in self._blocks or not self.budget.admit(arr.nbytes):
            return
        self._blocks[key] = arr
        self.cached_bytes += arr.nbytes

    def read_block(
        self, tensor_id: str, block_idx: int, block_size: int, category: str
    ) -> np.ndarray:
        key = (tensor_id, block_idx, block_size)
        with self._lock:
            hit = self._blocks.get(key)
            if hit is not None:
                self.hits += 1
                self.bytes_saved += hit.nbytes
                self._record_cache(hit.nbytes, hit=True)
                return hit
            self.misses += 1
        arr = self._reader.read_block(tensor_id, block_idx, block_size, category)
        self._record_cache(arr.nbytes, hit=False)
        with self._lock:
            self._admit(key, arr)
        return arr

    def has_block(self, tensor_id: str, block_idx: int, block_size: int) -> bool:
        """Tier probe: is this block RAM-resident right now? (Planner
        billing hook — see repro_torch.store.tiered.make_tier_probe.)"""
        with self._lock:
            return (
                (tensor_id, block_idx, block_size) in self._blocks
                or tensor_id in self._tensors
            )

    def read_blocks_coalesced(
        self,
        tensor_id: str,
        block_idxs: Sequence[int],
        block_size: int,
        category: str,
        gap_bytes: int = 0,
    ) -> Dict[int, np.ndarray]:
        out: Dict[int, np.ndarray] = {}
        missing: List[int] = []
        with self._lock:
            for b in block_idxs:
                hit = self._blocks.get((tensor_id, b, block_size))
                if hit is not None:
                    self.hits += 1
                    self.bytes_saved += hit.nbytes
                    self._record_cache(hit.nbytes, hit=True)
                    out[b] = hit
                else:
                    missing.append(b)
            self.misses += len(missing)
        if missing:
            fetched = self._reader.read_blocks_coalesced(
                tensor_id, missing, block_size, category,
                gap_bytes=gap_bytes,
            )
            with self._lock:
                for b, arr in fetched.items():
                    self._admit((tensor_id, b, block_size), arr)
                    self._record_cache(arr.nbytes, hit=False)
                    out[b] = arr
        return out

    def read_tensor(self, tensor_id: str, category: str) -> np.ndarray:
        with self._lock:
            hit = self._tensors.get(tensor_id)
            if hit is not None:
                self.hits += 1
                self.bytes_saved += hit.nbytes
                self._record_cache(hit.nbytes, hit=True)
                return hit
            self.misses += 1
        arr = self._reader.read_tensor(tensor_id, category)
        self._record_cache(arr.nbytes, hit=False)
        with self._lock:
            if tensor_id not in self._tensors and self.budget.admit(arr.nbytes):
                self._tensors[tensor_id] = arr
                self.cached_bytes += arr.nbytes
        return arr

    def read_range(
        self, tensor_id: str, offset: int, nbytes: int, category: str
    ) -> bytes:
        # uncached passthrough (not on the executor's expert hot path)
        return self._reader.read_range(tensor_id, offset, nbytes, category)

    # -- lifecycle ---------------------------------------------------------
    def drop_cache(self) -> None:
        with self._lock:
            self._blocks.clear()
            self._tensors.clear()
            self.budget.release(self.cached_bytes)
            self.cached_bytes = 0

    def cache_stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "cached_bytes": self.cached_bytes,
                "bytes_saved": self.bytes_saved,
            }

    def close(self) -> None:
        self.drop_cache()
        self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
