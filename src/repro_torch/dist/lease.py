"""Shard leases and distributed-execution options.

A :class:`ShardLease` is the complete, self-contained work order the
coordinator hands a worker: which shard of which exec sid, the global
block spans to merge, the per-shard byte budget, where to stage the
region, and which journal namespace to append progress into.  It
round-trips through JSON so the process transport can pass it by file —
the same document a future RPC transport would put on the wire.

Leases are versioned by ``attempt``: when a worker dies its lease
expires and the shard is re-issued at ``attempt + 1`` to a survivor,
which resumes from the shard journal's high-water mark.  The journal
namespace is per-shard (not per-attempt) precisely so the successor can
see its predecessor's progress.

Port notes: the worker kernels are ``"torch"`` (the pipelined engine
with the port's merge kernels, the default, in the reference's
``"jax"`` place), ``"numpy"`` and ``"mesh"`` (the packed whole-shard
merge on the lease's one device; the name is kept so a reader finds its
counterpart).  ``DistOptions.device`` and ``ShardLease.device`` say
where a worker computes: a CUDA device launches the Hopper kernels and
never falls back to the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

TRANSPORTS = ("process", "inline")
KERNELS = ("numpy", "torch", "mesh")


@dataclasses.dataclass(frozen=True)
class DistOptions:
    """Knobs for ``execution="sharded"`` (see docs/DISTRIBUTED.md).

    ``transport="process"`` launches each worker as a separate Python
    process (the CI-friendly stand-in for remote hosts); ``"inline"``
    runs workers synchronously in the coordinator process — useful for
    deterministic tests that need the dead attempt's partial stats.
    ``kernel`` selects the worker's compute path: the bit-identical
    ``"numpy"`` stream kernel, the ``"torch"`` block kernels (the
    default: ``merge_blocks`` on ``device``, bit-identical too), or
    ``"mesh"`` — the packed whole-tensor device path of
    ``core.distributed.build_merge_step`` (tolerance-level on TIES tail
    blocks; forces tensor-aligned shard cuts).  ``device`` is where the
    workers compute; ``None`` takes the calling Session's or service's
    device.
    """

    n_workers: int = 2
    transport: str = "process"
    kernel: str = "torch"
    max_lease_attempts: int = 3
    journal_sync_every: Optional[int] = None
    heartbeat_s: float = 0.2
    #: chaos hand-off to workers: {"point": ..., "skip": int, "shard": int,
    #: "mode"?: ...} — armed only on the target shard's FIRST attempt so
    #: recovery tests kill exactly one worker once
    chaos: Optional[Dict] = None
    #: "cuda", "cuda:N", "cpu", or None for the caller's device
    device: Optional[str] = None

    def validate(self) -> None:
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if self.transport not in TRANSPORTS:
            raise ValueError(
                "unknown transport %r (expected one of %s)"
                % (self.transport, ", ".join(TRANSPORTS)))
        if self.kernel not in KERNELS:
            raise ValueError(
                "unknown worker kernel %r (expected one of %s)"
                % (self.kernel, ", ".join(KERNELS)))
        if self.max_lease_attempts < 1:
            raise ValueError("max_lease_attempts must be >= 1")


@dataclasses.dataclass
class ShardLease:
    """One shard's work order (JSON round-trippable)."""

    shard: int
    sid: str
    attempt: int
    #: per-shard expert byte budget (partitioner's extent-once cost plus
    #: cross-shard extent re-reads); the worker widens it exactly the
    #: way execute_merge widens the plan budget
    budget: int
    #: [(tensor, lo, hi)] global half-open block spans, plan order
    spans: List[Tuple[str, int, int]]
    #: full plan payload (MergePlan.to_payload) — workers rebuild the
    #: identical plan so selections, DARE seeds, digests all agree
    plan: Dict
    block_size: int
    shard_dir: str
    journal_path: str
    coalesce: bool = True
    #: False, True, or a {"flat","remote","packed"} policy dict
    verify: object = True
    kernel: str = "torch"
    #: dataclasses.asdict(PipelineConfig) or None for defaults
    pipeline: Optional[Dict] = None
    journal_sync_every: Optional[int] = None
    chaos: Optional[Dict] = None
    #: where the worker computes; a lease document without it means the
    #: card ("cuda"), and a CUDA lease never runs on the CPU
    device: str = "cuda"

    def to_doc(self) -> Dict:
        d = dataclasses.asdict(self)
        d["spans"] = [[t, int(lo), int(hi)] for t, lo, hi in self.spans]
        return d

    @classmethod
    def from_doc(cls, doc: Dict) -> "ShardLease":
        d = dict(doc)
        d["spans"] = [(t, int(lo), int(hi)) for t, lo, hi in d["spans"]]
        return cls(**d)

    def span_map(self) -> Dict[str, Tuple[int, int]]:
        return {t: (lo, hi) for t, lo, hi in self.spans}

    def write(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # chaos-ok: worker-death points live in dist/worker.py

    @classmethod
    def read(cls, path: str) -> "ShardLease":
        with open(path) as f:
            return cls.from_doc(json.load(f))
