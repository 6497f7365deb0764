"""Storage substrate: block-granular tensor files, packed layouts,
snapshots, I/O stats."""
from repro_torch.store.iostats import GLOBAL_STATS, IOStats, measure
from repro_torch.store.packed import (
    PackedLayout,
    PackedModelReader,
    PackedStore,
    RepackOptions,
)
from repro_torch.store.snapshot import SnapshotStore, StagingWriter
from repro_torch.store.tensorstore import CheckpointStore, ModelReader, load_model_arrays

__all__ = [
    "GLOBAL_STATS",
    "IOStats",
    "measure",
    "PackedLayout",
    "PackedModelReader",
    "PackedStore",
    "RepackOptions",
    "SnapshotStore",
    "StagingWriter",
    "CheckpointStore",
    "ModelReader",
    "load_model_arrays",
]
