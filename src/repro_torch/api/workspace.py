"""Shared workspace surface for :class:`~repro_torch.api.session.Session` and
:class:`~repro_torch.api.service.MergeService`.

Both own the same substrate (``self.snapshots`` / ``self.catalog`` /
``self.block_size``); this mixin keeps their ingestion, audit, and data
accessors one implementation instead of two drifting copies.

Port notes: ANALYZE runs on the owner's ``device`` (the sketch kernel on
a CUDA card, its plain version on the CPU).
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.core.lineage import explain as _explain
from repro_torch.core.lineage import lineage_chain, merge_graph, verify_snapshot
from repro_torch.core.sketch import analyze_model
from repro_torch.store.tensorstore import load_model_arrays


class WorkspaceOps:
    """Ingestion / audit / data accessors over one workspace substrate."""

    # ------------------------------------------------------------ ingestion
    def register_model(
        self,
        model_id: str,
        arrays: Mapping[str, np.ndarray],
        kind: str = "full",
        scale: float = 1.0,
        analyze: bool = False,
        base_id: Optional[str] = None,
    ) -> str:
        meta: Dict[str, Any] = {"kind": kind}
        if kind == "adapter":
            meta["scale"] = scale
        self.snapshots.models.write_model(model_id, arrays, meta=meta)
        if analyze:
            self.analyze(model_id, base_id=base_id)
        return model_id

    def analyze(
        self, model_id: str, base_id: Optional[str] = None, force: bool = False
    ) -> Dict:
        return analyze_model(
            self.catalog,
            self.snapshots.models,
            model_id,
            self.block_size,
            base_id=base_id,
            force=force,
            device=self.device,
        )

    def ensure_analyzed(self, base_id: str, expert_ids: Sequence[str]) -> None:
        self.analyze(base_id)
        for e in expert_ids:
            self.analyze(e, base_id=base_id)

    # ------------------------------------------------- remote-backed models
    def register_remote_model(
        self,
        model_id: str,
        remote_root: str,
        profile: Optional[Dict[str, Any]] = None,
        disk_cache: bool = True,
        analyze: bool = False,
        base_id: Optional[str] = None,
    ) -> str:
        """Register a model already published in a remote object store
        (``<remote_root>/<model_id>/...``).  Reads are served through the
        tier hierarchy RAM -> local disk cache -> remote; ``profile``
        sets the emulated endpoint's latency/bandwidth/fault shape (see
        :class:`repro_torch.store.remote.RemoteProfile`)."""
        self.snapshots.models.register_remote(
            model_id, remote_root, profile=profile, disk_cache=disk_cache
        )
        if analyze:
            self.analyze(model_id, base_id=base_id)
        return model_id

    def publish_model_remote(
        self,
        model_id: str,
        remote_root: str,
        profile: Optional[Dict[str, Any]] = None,
        keep_local: bool = False,
        disk_cache: bool = True,
    ) -> str:
        """Upload a locally registered model to a remote object store and
        (unless ``keep_local``) replace the local bytes with a remote
        stub, so later reads exercise the tiered path."""
        return self.snapshots.models.publish_remote(
            model_id,
            remote_root,
            profile=profile,
            keep_local=keep_local,
            disk_cache=disk_cache,
        )

    def disk_cache_stats(self) -> Dict[str, int]:
        """Usage/hit counters of the shared local-disk extent cache."""
        return self.snapshots.disk_cache.cache_stats()

    def evict_disk_cache(self, target_bytes: int = 0) -> int:
        """Shrink the shared disk cache to ``target_bytes`` (0 = clear).
        Returns bytes freed."""
        return self.snapshots.disk_cache.evict(target_bytes)

    # ---------------------------------------------------------------- audit
    def explain(self, sid: str) -> Dict:
        return _explain(self.catalog, self.snapshots, sid)

    def merge_graph(self, sid: str) -> Dict:
        return merge_graph(self.catalog, sid)

    def lineage(self, sid: str):
        return lineage_chain(self.catalog, sid)

    def verify(self, sid: str) -> bool:
        return verify_snapshot(self.snapshots, sid)

    def fsck(self, repair: bool = False, rate_mbps: float = 0.0):
        """mergefsck: scrub every store of this workspace (models,
        remote stubs, snapshots, packed layouts, disk cache, journals)
        against the block-integrity contract.  Returns a
        :class:`repro_torch.store.fsck.FsckReport`; see that module for what
        each pass checks and what ``repair`` may mutate."""
        from repro_torch.store.fsck import fsck as _fsck

        return _fsck(self.snapshots, repair=repair, rate_mbps=rate_mbps)

    # ----------------------------------------------------------------- data
    def load(self, model_id: str) -> Dict[str, np.ndarray]:
        return load_model_arrays(self.snapshots.models, model_id)

    def list_snapshots(self) -> List[str]:
        return self.snapshots.list_snapshots()
