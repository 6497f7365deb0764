"""mergefsck: offline/idle-time integrity scrubbing for a workspace.

:func:`fsck` walks every store a :class:`~repro_torch.store.snapshot.
SnapshotStore` owns and re-checks the catalog <-> disk <-> remote
integrity contract that verify-on-read (repro_torch.store.integrity) enforces
lazily — but over *everything*, including bytes no merge has touched
since they rotted:

- **models** — every local flat checkpoint / published snapshot is
  stream-re-hashed tensor file by tensor file against the blake2b-16
  hashes sealed in its ``MODEL.json`` (the same contract
  :func:`repro_torch.core.lineage.verify_snapshot` audits for one sid).
  Corrupt source bytes have no redundant copy, so they are reported
  unrepairable; directories with neither a ``MODEL.json`` nor a
  ``REMOTE.json`` are counted orphaned (torn ingest debris).
- **remote** — each ``REMOTE.json`` stub's manifest is HEADed at its
  object store; an unreachable manifest means every future read of that
  model fails, so it is reported as a problem.
- **snapshots** — each published manifest must parse and point at a
  live model directory (its tensor bytes are covered by the models
  pass, since publish moves snapshots into the model store).
- **packed** — every extent of every layout is read, decoded, and
  (for lossless encodings) re-hashed against its content-hash key.
  With ``repair=True`` corrupt extents are quarantined via
  :meth:`~repro_torch.store.packed.PackedLayout.quarantine_extent`, so
  subsequent reads fall back to the flat source; quarantine counts as
  *repaired* only when a flat-source store is attached to fall back to.
- **cache** — every disk-cache extent is re-validated against its
  filename contract (length + payload digest); corrupt extents are
  droppable without data loss (the next read refills from remote), so
  with ``repair=True`` they are unlinked and counted repaired.
- **journals** — a progress journal whose sid is already published is
  leftover crash debris (normally removed at lineage commit); with
  ``repair=True`` it is unlinked.

``rate_mbps`` throttles scrub I/O (hash + extent reads) so the
background scrubber in :class:`repro_torch.api.service.MergeService` cannot
starve foreground merges; ``0`` means unthrottled.

The report's :meth:`FsckReport.exit_code` is non-zero whenever a
problem was found and *not* repaired — ``merge_cli fsck --check`` uses
it as a CI gate over fixture stores.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional

__all__ = ["FsckReport", "fsck"]

#: counter names every store section of the report carries
COUNTERS = ("scanned", "verified", "corrupt", "repaired", "orphaned",
            "quarantined")


class _RateLimiter:
    """Sleep-based token bucket capping scrub I/O at ``mbps`` MB/s."""

    def __init__(self, mbps: float):
        self.rate = float(mbps) * 1e6  # bytes per second; <=0 = unthrottled
        self._t0 = time.monotonic()
        self._consumed = 0.0

    def consume(self, nbytes: int) -> None:
        if self.rate <= 0:
            return
        self._consumed += nbytes
        ahead = self._consumed / self.rate - (time.monotonic() - self._t0)
        if ahead > 0:
            time.sleep(ahead)


class FsckReport:
    """Per-store scrub counters plus a flat list of concrete problems."""

    def __init__(self):
        self.stores: Dict[str, Dict[str, int]] = {}
        self.problems: List[Dict] = []
        self.scrubbed_bytes = 0
        self.seconds = 0.0

    def note(self, store: str, counter: str, n: int = 1) -> None:
        c = self.stores.setdefault(store, {k: 0 for k in COUNTERS})
        c[counter] += n

    def problem(
        self,
        store: str,
        obj_id: str,
        kind: str,
        detail: str,
        repaired: bool = False,
    ) -> None:
        self.problems.append({
            "store": store,
            "id": obj_id,
            "kind": kind,
            "detail": detail,
            "repaired": repaired,
        })

    @property
    def unrepaired(self) -> List[Dict]:
        return [p for p in self.problems if not p["repaired"]]

    def exit_code(self) -> int:
        """0 = clean or fully repaired; 1 = damage that still stands."""
        return 1 if self.unrepaired else 0

    def to_dict(self) -> Dict:
        return {
            "stores": {k: dict(v) for k, v in self.stores.items()},
            "problems": [dict(p) for p in self.problems],
            "clean": not self.problems,
            "exit_code": self.exit_code(),
            "scrubbed_bytes": self.scrubbed_bytes,
            "seconds": self.seconds,
        }

    def summary(self) -> str:
        lines = []
        for store in sorted(self.stores):
            c = self.stores[store]
            parts = [f"{name}={c[name]}" for name in COUNTERS if c[name]]
            lines.append(f"{store:>10}: {' '.join(parts) or 'empty'}")
        for p in self.problems:
            mark = "repaired" if p["repaired"] else "UNREPAIRED"
            lines.append(
                f"  [{mark}] {p['store']}/{p['id']}: {p['kind']} — "
                f"{p['detail']}"
            )
        lines.append(
            f"fsck: {len(self.problems)} problem(s), "
            f"{len(self.unrepaired)} unrepaired, "
            f"{self.scrubbed_bytes} bytes scrubbed in {self.seconds:.2f}s"
        )
        return "\n".join(lines)


def _stream_hash(path: str, limiter: _RateLimiter, report: FsckReport) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            h.update(chunk)
            report.scrubbed_bytes += len(chunk)
            limiter.consume(len(chunk))
    return h.hexdigest()


def _fsck_models(snapshots, report: FsckReport, limiter: _RateLimiter) -> None:
    from repro_torch.store.remote import RemoteError
    from repro_torch.store.tensorstore import MODEL_MANIFEST, REMOTE_STUB

    models = snapshots.models
    try:
        names = sorted(os.listdir(models.root))
    except OSError:
        return
    for model_id in names:
        mdir = os.path.join(models.root, model_id)
        if not os.path.isdir(mdir):
            continue
        manifest = os.path.join(mdir, MODEL_MANIFEST)
        stub = os.path.join(mdir, REMOTE_STUB)
        if os.path.exists(manifest):
            report.note("models", "scanned")
            try:
                with open(manifest, "rb") as f:
                    doc = json.loads(f.read())
            except (OSError, ValueError) as e:
                report.note("models", "corrupt")
                report.problem(
                    "models", model_id, "bad-manifest",
                    f"unreadable MODEL.json: {e}",
                )
                continue
            bad = 0
            for tensor_id, spec in sorted(doc.get("tensors", {}).items()):
                want = spec.get("hash")
                if not want:
                    continue  # pre-hash manifests: nothing to verify against
                path = os.path.join(mdir, spec["file"])
                try:
                    got = _stream_hash(path, limiter, report)
                except OSError as e:
                    bad += 1
                    report.problem(
                        "models", model_id, "missing-tensor",
                        f"{tensor_id}: {e}",
                    )
                    continue
                if got != want:
                    bad += 1
                    report.problem(
                        "models", model_id, "corrupt-tensor",
                        f"{tensor_id} hashes {got}, MODEL.json says {want} "
                        f"(no redundant copy: unrepairable)",
                    )
            report.note("models", "corrupt" if bad else "verified")
        elif os.path.exists(stub):
            report.note("remote", "scanned")
            try:
                with open(stub, "rb") as f:
                    sdoc = json.loads(f.read())
                store = models.remote_store(sdoc["remote_root"])
                store.head(f"{model_id}/{MODEL_MANIFEST}")
            except (OSError, ValueError, KeyError, RemoteError) as e:
                report.note("remote", "corrupt")
                report.problem(
                    "remote", model_id, "unreachable-remote",
                    f"remote manifest HEAD failed: {e}",
                )
                continue
            report.note("remote", "verified")
        else:
            # torn ingest: a directory that never got its manifest
            report.note("models", "orphaned")


def _fsck_snapshots(snapshots, report: FsckReport) -> None:
    from repro_torch.store.tensorstore import MODEL_MANIFEST

    for sid in snapshots.list_snapshots():
        report.note("snapshots", "scanned")
        try:
            man = snapshots.manifest(sid)
        except (OSError, ValueError) as e:
            report.note("snapshots", "corrupt")
            report.problem(
                "snapshots", sid, "bad-manifest",
                f"unreadable snapshot manifest: {e}",
            )
            continue
        root = man.get("output_root", "")
        if not root or not os.path.exists(os.path.join(root, MODEL_MANIFEST)):
            report.note("snapshots", "corrupt")
            report.problem(
                "snapshots", sid, "missing-output",
                f"published manifest points at {root!r} but no model "
                f"directory is there",
            )
            continue
        # tensor bytes were re-hashed by the models pass (publish moves
        # snapshots into the model store) — structural check only here
        report.note("snapshots", "verified")


def _fsck_packed(
    snapshots, report: FsckReport, limiter: _RateLimiter, repair: bool
) -> None:
    from repro_torch.store.integrity import CorruptBlockError

    packed = snapshots.packed
    for layout_id in packed.list_layouts():
        try:
            layout = packed.open_layout(layout_id)
        except (OSError, ValueError, KeyError) as e:
            report.note("packed", "scanned")
            report.note("packed", "corrupt")
            report.problem(
                "packed", layout_id, "bad-layout",
                f"layout cannot be opened: {e}",
            )
            continue
        try:
            report.note("packed", "scanned")
            layout_bad = 0
            for key in sorted(layout.extents):
                if key in layout.quarantined:
                    report.note("packed", "quarantined")
                    continue
                ent = layout.extents[key]
                try:
                    payload = layout._pread(ent[0], ent[1])
                    # scrub traffic is background I/O, never expert/base
                    # merge bytes — bill it to "other"
                    layout.stats.record_read("other", ent[1])
                    report.scrubbed_bytes += ent[1]
                    limiter.consume(ent[1])
                    # decode + hash-verify; quarantines the key itself
                    # on failure (durable QUARANTINE.json)
                    layout._decode_verified(key, ent, payload)
                except (CorruptBlockError, IOError) as e:
                    layout_bad += 1
                    # _decode_verified already quarantined verify
                    # failures; short physical reads need it explicitly
                    if repair and key not in layout.quarantined:
                        layout.quarantine_extent(key)
                    fixed = (
                        repair
                        and key in layout.quarantined
                        and layout.models is not None
                    )
                    if fixed:
                        report.note("packed", "repaired")
                    report.problem(
                        "packed", f"{layout_id}/{key}", "corrupt-extent",
                        f"{e}" + (
                            " (quarantined; reads fall back to flat source)"
                            if fixed else ""
                        ),
                        repaired=fixed,
                    )
            report.note("packed", "corrupt" if layout_bad else "verified")
            if not repair:
                # detection-only pass: _decode_verified quarantined what
                # it saw — that persistence is correct for reads, but the
                # report must still flag the damage (handled above via
                # problems); nothing further to do
                pass
        finally:
            layout.close()


def _fsck_cache(
    snapshots, report: FsckReport, limiter: _RateLimiter, repair: bool
) -> None:
    cache = getattr(snapshots, "disk_cache", None)
    if cache is None:
        return
    res = cache.scrub(repair=repair, on_bytes=lambda n: (
        limiter.consume(n),
    ))
    report.scrubbed_bytes += res.get("bytes", 0)
    report.note("cache", "scanned", res["scanned"])
    report.note("cache", "verified", res["verified"])
    report.note("cache", "corrupt", res["corrupt"])
    report.note("cache", "repaired", res["repaired"])
    for path in res["corrupt_paths"]:
        report.problem(
            "cache", os.path.basename(path), "corrupt-extent",
            "payload disagrees with filename length/digest contract"
            + (" (dropped; next read refills from remote)" if repair
               else " (re-run with repair to drop it)"),
            repaired=repair,
        )


def _fsck_journals(snapshots, report: FsckReport, repair: bool) -> None:
    for path in snapshots.list_journal_paths():
        report.note("journals", "scanned")
        sid = os.path.basename(path)[: -len(".journal")]
        if not snapshots.is_published(sid):
            # resumable in-flight work — recovery owns it, not fsck
            report.note("journals", "verified")
            continue
        if repair:
            try:
                os.unlink(path)
            except OSError:
                continue
            report.note("journals", "repaired")
        else:
            report.note("journals", "orphaned")
        report.problem(
            "journals", sid, "orphaned-journal",
            "journal outlived its published snapshot"
            + (" (removed)" if repair else ""),
            repaired=repair,
        )


def fsck(
    snapshots,
    repair: bool = False,
    rate_mbps: float = 0.0,
) -> FsckReport:
    """Scrub every store of a workspace; see the module docstring for
    what each pass checks.  Pure detection with ``repair=False`` (except
    that packed verification durably quarantines extents it proves
    corrupt — that is the read-path contract, not a mutation fsck adds);
    ``repair=True`` additionally drops corrupt cache extents and
    orphaned journals."""
    t0 = time.monotonic()
    report = FsckReport()
    limiter = _RateLimiter(rate_mbps)
    _fsck_models(snapshots, report, limiter)
    _fsck_snapshots(snapshots, report)
    _fsck_packed(snapshots, report, limiter, repair)
    _fsck_cache(snapshots, report, limiter, repair)
    _fsck_journals(snapshots, report, repair)
    report.seconds = time.monotonic() - t0
    return report
