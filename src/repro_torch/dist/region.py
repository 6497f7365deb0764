"""Shard-side staged output regions.

A worker stages its slice of the output as per-tensor *region files* —
the same streaming format, hashes, and progress journal as the real
:class:`~repro_torch.store.snapshot.StagingWriter`, just rooted in a per-shard
directory and indexed by LOCAL block (``global - span_lo``).  Keeping the
journal local-indexed means ``parse_journal``/``build_resume_state``
work on shard journals verbatim: a successor worker re-validates the
region prefix exactly the way service recovery re-validates a dead
run's staging.

Region bytes are deliberately billed to the ``other`` IOStats category
(writes here, reads at coordinator splice time): the canonical ``out``
bytes are recorded once, by the coordinator's real StagingWriter, so
per-category parity with single-process execution holds and the shard
overhead is visible instead of laundered into C_out.

Port note: :class:`ShardRegionWriter` keeps the wall-clock time of its
first staged block (``first_block_at``), which the worker reports.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.store.iostats import IOStats
from repro_torch.store.journal import ProgressJournal, ResumeState
from repro_torch.store.snapshot import StagingWriter
from repro_torch.testing.chaos import chaos_point


class _RegionStats:
    """Remaps the wrapped StagingWriter's billing (``out`` writes,
    ``meta`` validation reads) onto ``other`` — region I/O is shard
    overhead, not canonical output volume."""

    def __init__(self, stats: IOStats):
        self._stats = stats

    def record_write(self, category: str, nbytes: int) -> None:
        self._stats.record_write("other", nbytes)

    def record_read(self, category: str, nbytes: int) -> None:
        self._stats.record_read("other", nbytes)


class ShardRegionWriter:
    """StagingWriter facade taking GLOBAL block indices over a lease's
    spans.  Implements the writer protocol the pipelined engine's
    write-behind stage expects (begin_tensor / write_block /
    finish_tensor), so the engine runs unmodified over a shard."""

    def __init__(
        self,
        shard_dir: str,
        spans: Dict[str, Tuple[int, int]],
        stats: IOStats,
        journal: Optional[ProgressJournal] = None,
        resume: Optional[ResumeState] = None,
    ):
        self.spans = spans
        self.dir = shard_dir
        #: time.time() of the first block staged (None before it)
        self.first_block_at: Optional[float] = None
        self.inner = StagingWriter(
            shard_dir, _RegionStats(stats), journal=journal, resume=resume
        )

    def begin_tensor(self, tensor_id: str, shape, dtype) -> None:
        if tensor_id not in self.spans:
            raise RuntimeError(
                "tensor %r is outside this shard's lease" % tensor_id)
        self.inner.begin_tensor(tensor_id, shape, dtype)

    def write_block(
        self,
        tensor_id: str,
        block_idx: int,
        block: np.ndarray,
        experts: Optional[str] = None,
    ) -> None:
        chaos_point("worker:block")
        if self.first_block_at is None:
            self.first_block_at = time.time()
        lo, hi = self.spans[tensor_id]
        if not (lo <= block_idx < hi):
            raise RuntimeError(
                "block %d of %r outside shard span [%d, %d)"
                % (block_idx, tensor_id, lo, hi))
        self.inner.write_block(tensor_id, block_idx - lo, block,
                               experts=experts)

    def finish_tensor(self, tensor_id: str) -> None:
        self.inner.finish_tensor(tensor_id)

    def validate_hashes(self) -> None:
        self.inner.validate_hashes()

    def abort(self) -> None:
        self.inner.abort()

    def detach(self) -> None:
        self.inner.detach()

    def region_manifest(self) -> List[Dict]:
        """[{tensor, lo, hi, file, nbytes, hash, shape, dtype}] for the
        coordinator splice — ``file`` is relative to the shard dir and
        ``hash`` is the streaming blake2b-16 over the region bytes."""
        out = []
        for tensor_id, spec in self.inner.specs.items():
            lo, hi = self.spans[tensor_id]
            out.append({
                "tensor": tensor_id,
                "lo": lo,
                "hi": hi,
                "file": spec["file"],
                "nbytes": spec["nbytes"],
                "hash": spec["hash"],
                "shape": spec["shape"],
                "dtype": spec["dtype"],
            })
        return out
