"""Shard-parallel distributed merge execution (docs/DISTRIBUTED.md).

Coordinator/worker subsystem that scatters one planned merge across
byte-balanced shard workers and rolls the staged regions back into a
single transactional commit:

* :mod:`repro_torch.dist.partition` — physical-byte shard partitioning over
  the plan's realized read set;
* :mod:`repro_torch.dist.lease` — :class:`ShardLease` work orders and
  :class:`DistOptions` knobs;
* :mod:`repro_torch.dist.region` — shard-side staged output regions (local
  StagingWriter + per-shard progress journal);
* :mod:`repro_torch.dist.worker` — one lease in, one region + result doc out;
* :mod:`repro_torch.dist.transport` — process / inline worker transports;
* :mod:`repro_torch.dist.coordinator` — scatter, lease re-issue, splice,
  single atomic publish.

Deliberately torch-free at import time: a worker imports torch when it
runs (its device and kernels); only ``kernel="mesh"`` touches
:mod:`repro_torch.core.distributed`.
"""
from repro_torch.dist.coordinator import run_sharded_merge, shard_journal_root
from repro_torch.dist.lease import DistOptions, ShardLease
from repro_torch.dist.partition import Partition, Shard, partition_plan
from repro_torch.dist.region import ShardRegionWriter
from repro_torch.dist.transport import (
    InlineTransport,
    LocalProcessTransport,
    WorkerExit,
    make_transport,
)
from repro_torch.dist.worker import run_worker

__all__ = [
    "DistOptions",
    "InlineTransport",
    "LocalProcessTransport",
    "Partition",
    "Shard",
    "ShardLease",
    "ShardRegionWriter",
    "WorkerExit",
    "make_transport",
    "partition_plan",
    "run_sharded_merge",
    "run_worker",
    "shard_journal_root",
]
