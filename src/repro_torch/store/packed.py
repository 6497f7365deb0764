"""PackedStore — content-addressed packed physical layouts for expert reads.

The paper's headline metric is expert read volume: C_expert is the only
cost term that grows with K, and the planner and executor make those
reads fewer (budgeted selection, cross-job caching) and overlapped
(pipelining).  This module
makes the *bytes behind each read* smaller.  A ``repack`` pass rewrites a
fleet of expert checkpoints into one **layout** of block-aligned extents
keyed by the same blake2b content hashes ANALYZE already records in the
catalog:

* **Dedup** — blocks with identical bytes (shared frozen layers, tied
  weights, embeddings common across fine-tunes of one base) become one
  extent, stored once and read once per merge regardless of how many
  (expert, block) consumers selected it.
* **Elision** — blocks whose delta against the base is exactly zero
  (full-kind experts bit-identical to the base block; delta-kind experts
  all-zero) become metadata-only entries: the executor synthesizes their
  zero delta from the base read it already pays for, moving **no** expert
  bytes.  An optional ``elide_threshold`` extends this to near-zero
  deltas (lossy — gated off by default).
* **Downcast + compression** — optional per-extent dtype downcast
  (lossy) and zlib compression (lossless), with exact physical sizes
  recorded so the planner costs selections in true post-compression
  bytes.

Physical layout of one packed layout::

    <workspace>/packed/<layout_id>/
        LAYOUT.json    # members, tensor specs, block -> extent/elided map
        extents.bin    # unique extents, concatenated

``LAYOUT.json`` is self-contained: opening a layout never needs the
catalog.  The catalog additionally records layout/member/extent/block
tables (``repro_torch.core.catalog``) so the planner can cost selections in
physical bytes and so ``CheckpointStore.delete_model`` can refuse to
delete source checkpoints a layout still references (the layout's *base*
serves elided blocks at read time).

Read-side accounting: physical extent reads serving expert blocks are
tagged ``expert_packed`` (kept distinct from flat ``expert`` reads so
packed-vs-flat volume stays directly comparable; both count into the
budget's C_expert).  Extents referenced by more than one (model, block)
consumer are pinned in memory after their first read for the lifetime of
the opened layout — one physical read fans out to every consumer, which
is exactly what the planner's marginal-cost model charges.  Pinned bytes
are bounded by the layout's duplicated bytes (the very bytes dedup
saved); ``max_pinned_bytes`` caps them explicitly if needed.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import threading
import time
import uuid
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import blocks as blk
from repro_torch.store import dtypes
from repro_torch.store.integrity import CorruptBlockError
from repro_torch.store.iostats import GLOBAL_STATS, IOStats
from repro_torch.store.tensorstore import CheckpointStore, TensorSpec
from repro_torch.testing.chaos import chaos_corrupt

LAYOUT_MANIFEST = "LAYOUT.json"
EXTENT_FILE = "extents.bin"
#: extent keys verified corrupt and excluded from serving (reads fall
#: back to the member's flat source checkpoint); written by the read
#: path and by fsck, honored by every subsequent open of the layout
QUARANTINE_FILE = "QUARANTINE.json"

#: lossy downcasts the repack pass may apply, per source dtype
_DOWNCASTS = {"float32": ("float16", "bfloat16")}

#: dtypes whose blocks participate in elision (merge semantics only ever
#: pull deltas from float tensors; everything else is base passthrough)
_FLOAT_DTYPES = ("float32", "float16", "float64", "bfloat16")
#: blocks a repack reads before it encodes them at once, and the threads
#: that encode them (zlib releases the GIL)
_ENCODE_CHUNK = 64
_ENCODE_THREADS = min(8, os.cpu_count() or 1)


def content_hash(raw: bytes) -> str:
    """Same algorithm as ANALYZE's BlockMeta hash (catalog join key)."""
    return hashlib.blake2b(raw, digest_size=8).hexdigest()


@dataclasses.dataclass(frozen=True)
class RepackOptions:
    """Repack tuning knobs.

    elide_threshold — L2 bound on a block's delta (vs base for full-kind
                      experts, vs zero for delta-kind) below which the
                      block is elided.  0.0 = byte-exact elision only
                      (lossless).  > 0 is **lossy**.
    compress        — "none" | "zlib": per-extent compression (lossless);
                      an extent keeps whichever of raw/compressed is
                      smaller, recorded per extent.
    downcast        — None | "float16" | "bfloat16": store float32
                      extents in a narrower dtype (**lossy**; see
                      docs/STORAGE.md for when this is safe).
    """

    elide_threshold: float = 0.0
    compress: str = "none"
    downcast: Optional[str] = None

    def validate(self) -> None:
        if self.elide_threshold < 0:
            raise ValueError(
                f"elide_threshold must be >= 0, got {self.elide_threshold}"
            )
        if self.compress not in ("none", "zlib"):
            raise ValueError(f"unknown compression {self.compress!r}")
        if self.downcast is not None and self.downcast not in (
            "float16", "bfloat16"
        ):
            raise ValueError(f"unknown downcast dtype {self.downcast!r}")

    @property
    def lossless(self) -> bool:
        return self.downcast is None and self.elide_threshold == 0.0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict) -> "RepackOptions":
        return RepackOptions(**d)


def encode_extent(
    raw: bytes, dtype_name: str, options: RepackOptions
) -> Tuple[bytes, str]:
    """raw logical block bytes -> (physical payload, encoding tag).

    Encoding tags compose left-to-right: ``cast:<dtype>`` then ``zlib``;
    ``raw`` means identity.  Decode reverses them exactly.
    """
    steps: List[str] = []
    data = raw
    if (
        options.downcast is not None
        and options.downcast in _DOWNCASTS.get(dtype_name, ())
    ):
        src = dtypes.to_np_dtype(dtype_name)
        dst = dtypes.to_np_dtype(options.downcast)
        # through float32 values: bf16 is carried as uint16 words, which a
        # bare astype would fill with truncated integers
        data = dtypes.from_float32(
            dtypes.to_float32(np.frombuffer(raw, dtype=src)), dst
        ).tobytes()
        steps.append(f"cast:{options.downcast}")
    if options.compress == "zlib":
        z = zlib.compress(data, 6)
        if len(z) < len(data):
            data = z
            steps.append("zlib")
    return data, "+".join(steps) if steps else "raw"


def decode_extent(
    payload: bytes, encoding: str, dtype_name: str, logical_nbytes: int
) -> bytes:
    """Invert :func:`encode_extent`; returns logical raw block bytes."""
    data = payload
    steps = [] if encoding == "raw" else encoding.split("+")
    for step in reversed(steps):
        if step == "zlib":
            data = zlib.decompress(data)
        elif step.startswith("cast:"):
            src = dtypes.to_np_dtype(dtype_name)
            dst = dtypes.to_np_dtype(step[len("cast:"):])
            data = dtypes.from_float32(
                dtypes.to_float32(np.frombuffer(data, dtype=dst)), src
            ).tobytes()
        else:
            raise ValueError(f"unknown extent encoding step {step!r}")
    if len(data) != logical_nbytes:
        raise IOError(
            f"extent decode produced {len(data)} bytes, "
            f"expected {logical_nbytes} (encoding {encoding!r})"
        )
    return data


class _BaseTensorCache:
    """Whole-tensor LRU over the base checkpoint for the repack pass:
    full-kind elision byte-compares every member block against base, so
    without this the base would be re-read once per member (O(K x base)
    repack I/O).  A handful of resident tensors suffices because members
    walk tensors in the same order."""

    def __init__(self, base_reader, maxsize: int = 4):
        self.reader = base_reader
        self.maxsize = maxsize
        self._cache: "OrderedDict[str, bytes]" = OrderedDict()

    def block_bytes(self, tensor_id: str, rng) -> bytes:
        data = self._cache.get(tensor_id)
        if data is None:
            spec = self.reader.spec(tensor_id)
            data = self.reader.read_range(tensor_id, 0, spec.nbytes, "repack")
            self._cache[tensor_id] = data
            while len(self._cache) > self.maxsize:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(tensor_id)
        return data[rng.offset:rng.end]


class PackedStore:
    """Directory of packed layouts under ``<workspace>/packed``."""

    def __init__(
        self,
        root: str,
        stats: Optional[IOStats] = None,
        models: Optional[CheckpointStore] = None,
    ):
        self.root = root
        self.stats = stats or GLOBAL_STATS
        #: flat store the layouts were packed from — needed at repack time
        #: (source reads) and at read time (base synthesis of elided blocks)
        self.models = models

    # -- structure ---------------------------------------------------------
    def layout_dir(self, layout_id: str) -> str:
        return os.path.join(self.root, layout_id)

    def exists(self, layout_id: str) -> bool:
        return os.path.exists(
            os.path.join(self.layout_dir(layout_id), LAYOUT_MANIFEST)
        )

    def list_layouts(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        return sorted(
            d for d in os.listdir(self.root)
            if os.path.exists(os.path.join(self.root, d, LAYOUT_MANIFEST))
        )

    def open_layout(
        self, layout_id: str, max_pinned_bytes: Optional[int] = None
    ) -> "PackedLayout":
        return PackedLayout(
            self.layout_dir(layout_id), self.stats, models=self.models,
            max_pinned_bytes=max_pinned_bytes,
        )

    # -- repack ------------------------------------------------------------
    def repack(
        self,
        base_id: str,
        model_ids: Sequence[str],
        block_size: int,
        layout_id: Optional[str] = None,
        options: Optional[RepackOptions] = None,
        catalog=None,
    ) -> Dict:
        """Rewrite ``model_ids`` into one content-addressed packed layout.

        One pass per member checkpoint: every block is read (tagged
        ``repack`` — a one-time, amortized cost like ANALYZE), compared
        byte-exact against the base block (elision) and against every
        extent already written (dedup by content hash), then encoded and
        appended to ``extents.bin``.  Returns the repack report; when a
        ``catalog`` is supplied, layout/member/extent/block rows are
        recorded so the planner can cost in physical bytes and lineage
        back to the source checkpoints is durable.
        """
        t0 = time.time()
        options = options or RepackOptions()
        options.validate()
        # order-preserving dedupe: a repeated id would pack twice and
        # violate the catalog's member primary key after the disk publish
        model_ids = list(dict.fromkeys(model_ids))
        if self.models is None:
            raise RuntimeError("PackedStore has no source CheckpointStore")
        layout_id = layout_id or "layout-" + uuid.uuid4().hex[:12]
        ldir = self.layout_dir(layout_id)
        if self.exists(layout_id):
            if catalog is not None and catalog.get_packed_layout(layout_id) is None:
                # crash window recovery: the on-disk manifest published
                # but the process died before the catalog rows landed —
                # re-register from LAYOUT.json instead of bricking the id.
                # Only when the disk layout IS the one being requested:
                # recovering a layout with different contents would hand
                # back a success-shaped report for the wrong fleet (and a
                # mismatched request must not mutate catalog state).
                with open(os.path.join(ldir, LAYOUT_MANIFEST), "rb") as f:
                    doc = json.loads(f.read())
                mismatches = []
                if doc["base_id"] != base_id:
                    mismatches.append(
                        f"base {doc['base_id']!r} != {base_id!r}"
                    )
                if sorted(doc["members"]) != sorted(model_ids):
                    mismatches.append(
                        f"members {sorted(doc['members'])} != "
                        f"{sorted(model_ids)}"
                    )
                if int(doc["block_size"]) != block_size:
                    mismatches.append(
                        f"block_size {doc['block_size']} != {block_size}"
                    )
                if doc["options"] != options.to_dict():
                    mismatches.append(
                        f"options {doc['options']} != {options.to_dict()}"
                    )
                if mismatches:
                    raise ValueError(
                        f"packed layout {layout_id!r} already exists on disk "
                        f"with different contents ({'; '.join(mismatches)}); "
                        f"pick a fresh layout id for this repack (or call "
                        f"sync_catalog to adopt the disk layout as-is)"
                    )
                return self.sync_catalog(layout_id, catalog)
            raise ValueError(f"packed layout {layout_id!r} already exists")
        os.makedirs(ldir, exist_ok=True)

        base_reader = self.models.open_model(base_id)
        base_cache = _BaseTensorCache(base_reader)
        # extent table: key -> [offset, physical, logical, encoding, dtype, refs]
        extents: Dict[str, List] = {}
        members: Dict[str, Dict] = {}
        member_rows: List[Tuple[str, int, int]] = []
        block_rows: List[Tuple] = []
        adapter_rows: List[Tuple] = []
        totals = {
            "logical_bytes": 0, "physical_bytes": 0, "elided_blocks": 0,
            "dedup_blocks": 0, "extent_blocks": 0,
        }
        offset = 0
        data_path = os.path.join(ldir, EXTENT_FILE)
        try:
            # w+b: dedup hits pread the stored payload back for byte
            # verification while the file is still being appended
            with open(data_path, "w+b") as data_f, ThreadPoolExecutor(
                max_workers=_ENCODE_THREADS, thread_name_prefix="repack-encode"
            ) as encoders:
                for model_id in model_ids:
                    with self.models.open_model(model_id) as reader:
                        m_logical, m_physical, offset = self._pack_member(
                            model_id, reader, base_reader, base_cache,
                            block_size, options, extents, members,
                            block_rows, adapter_rows, totals, data_f, offset,
                            encoders,
                        )
                    member_rows.append((model_id, m_logical, m_physical))
        finally:
            base_reader.close()

        stats = dict(totals)
        stats["extents"] = len(extents)
        stats["seconds"] = time.time() - t0
        doc = {
            "layout_id": layout_id,
            "base_id": base_id,
            "block_size": block_size,
            "options": options.to_dict(),
            "lossless": options.lossless,
            "stats": stats,
            "extents": {k: v for k, v in extents.items()},
            "members": members,
            # catalog projection that cannot be re-derived from the maps
            # above alone (marginal member attribution, adapter virtual
            # rows) — makes sync_catalog a pure function of this file
            "catalog_rows": {
                "members": member_rows,
                "adapter_blocks": adapter_rows,
            },
        }
        raw_doc = json.dumps(doc, indent=1).encode()
        tmp = os.path.join(ldir, LAYOUT_MANIFEST + ".tmp")
        with open(tmp, "wb") as f:  # publish point: manifest appears last
            f.write(raw_doc)
            f.flush()
            os.fsync(f.fileno())
        # chaos-ok: a layout is derived state — a crash mid-repack leaves
        # no manifest, and the whole repack is re-run from the source
        # snapshots; there is no resume edge for the harness to probe
        os.replace(tmp, os.path.join(ldir, LAYOUT_MANIFEST))
        self.stats.record_write("meta", len(raw_doc))

        if catalog is not None:
            catalog.record_packed_layout(
                layout_id, base_id, block_size, ldir, options.lossless,
                options.to_dict(), stats,
                members=member_rows,
                extents=[
                    (k, v[0], v[1], v[2], v[3], v[5])
                    for k, v in extents.items()
                ],
                blocks=block_rows,
            )
        report = {
            "layout_id": layout_id,
            "base_id": base_id,
            "block_size": block_size,
            "lossless": options.lossless,
            "options": options.to_dict(),
            "members": [m for m, _, _ in member_rows],
            **stats,
        }
        return report

    def sync_catalog(self, layout_id: str, catalog) -> Dict:
        """Re-register an on-disk layout's catalog rows from LAYOUT.json.

        The manifest ``os.replace`` is the layout's publish point; a
        crash before :meth:`Catalog.record_packed_layout` leaves a
        readable layout the planner cannot see.  Everything the catalog
        needs is (re)derivable from the manifest — block rows from the
        member maps + extent table, plus the stored ``catalog_rows``
        projection for marginal member attribution and adapter virtual
        rows.  Idempotent; returns a repack-shaped report with
        ``recovered=True``.
        """
        ldir = self.layout_dir(layout_id)
        with open(os.path.join(ldir, LAYOUT_MANIFEST), "rb") as f:
            raw = f.read()
        self.stats.record_read("meta", len(raw))
        doc = json.loads(raw)
        block_size = int(doc["block_size"])
        extents = doc["extents"]
        block_rows: List[Tuple] = []
        for model_id, member in doc["members"].items():
            kind = member.get("kind", "full")
            for tensor_id, entries in member["blocks"].items():
                nbytes = member["tensors"][tensor_id]["nbytes"]
                for i, e in enumerate(entries):
                    logical = blk.block_range(nbytes, i, block_size).nbytes
                    if e[0] == "z":
                        block_rows.append(
                            (model_id, tensor_id, i, "elided", None, 0,
                             logical)
                        )
                    elif kind != "adapter":
                        block_rows.append(
                            (model_id, tensor_id, i, "extent", e[1],
                             extents[e[1]][1], logical)
                        )
        crows = doc.get("catalog_rows", {})
        block_rows.extend(tuple(r) for r in crows.get("adapter_blocks", []))
        # dedupe defensively: rows violating the member primary key would
        # make this recovery path itself unrecoverable
        member_rows = list(
            dict.fromkeys(tuple(r) for r in crows.get("members", []))
        )
        options = RepackOptions.from_dict(doc["options"])
        catalog.record_packed_layout(
            layout_id, doc["base_id"], block_size, ldir,
            bool(doc["lossless"]), options.to_dict(), doc.get("stats", {}),
            members=member_rows,
            extents=[
                (k, v[0], v[1], v[2], v[3], v[5]) for k, v in extents.items()
            ],
            blocks=block_rows,
        )
        return {
            "layout_id": layout_id,
            "base_id": doc["base_id"],
            "block_size": block_size,
            "lossless": bool(doc["lossless"]),
            "options": options.to_dict(),
            "members": [m for m, _, _ in member_rows],
            "recovered": True,
            **doc.get("stats", {}),
        }

    def _pack_member(
        self,
        model_id: str,
        reader,
        base_reader,
        base_cache: "_BaseTensorCache",
        block_size: int,
        options: RepackOptions,
        extents: Dict[str, List],
        members: Dict[str, Dict],
        block_rows: List[Tuple],
        adapter_rows: List[Tuple],
        totals: Dict[str, int],
        data_f,
        offset: int,
        encoders: ThreadPoolExecutor,
    ) -> Tuple[int, int, int]:
        """Pack one member checkpoint; returns (logical, marginal physical,
        new extent-file offset).  ``block_rows`` gains the catalog's
        physical cost rows (virtual base-grid rows for adapters).

        A tensor's blocks go in chunks of :data:`_ENCODE_CHUNK`: each
        chunk is read and elision-checked in block order, its kept blocks
        are encoded on ``encoders`` at once (zlib releases the GIL), then
        deduplicated and appended in block order — so the layout's bytes
        are those of a block-by-block pass."""
        kind = reader.meta.get("kind", "full")
        member = {
            "meta": dict(reader.meta),
            "kind": kind,
            "tensors": {},
            "blocks": {},
        }
        m_logical = 0
        m_physical = 0
        factor_physical: Dict[str, int] = {}  # adapter target -> packed bytes
        for tensor_id in reader.tensor_names():
            spec = reader.spec(tensor_id)
            member["tensors"][tensor_id] = {
                "shape": list(spec.shape),
                "dtype": spec["dtype"],
                "nbytes": spec.nbytes,
            }
            is_float = spec["dtype"] in _FLOAT_DTYPES
            # elision applies to merge-delta semantics only: full-kind
            # blocks byte-identical to base, delta-kind all-zero blocks
            base_spec = None
            if kind == "full" and tensor_id in base_reader.specs:
                bs = base_reader.spec(tensor_id)
                if bs.nbytes == spec.nbytes and bs["dtype"] == spec["dtype"]:
                    base_spec = bs
            entries: List = []
            t_physical = 0
            ranges = list(blk.partition(spec.nbytes, block_size))
            chunks = [ranges[i:i + _ENCODE_CHUNK]
                      for i in range(0, len(ranges), _ENCODE_CHUNK)]
            for chunk in chunks:
                raws, elided = [], []
                for rng in chunk:
                    raw = reader.read_range(
                        tensor_id, rng.offset, rng.nbytes, "repack"
                    )
                    m_logical += rng.nbytes
                    totals["logical_bytes"] += rng.nbytes
                    raws.append(raw)
                    elided.append(
                        is_float and kind in ("full", "delta")
                        and self._elide(
                            raw, rng, tensor_id, kind, base_spec,
                            base_cache, spec.dtype, options,
                        )
                    )
                encoded = iter(list(encoders.map(
                    lambda r: encode_extent(r, spec["dtype"], options),
                    [r for r, e in zip(raws, elided) if not e],
                )))
                for rng, raw, is_elided in zip(chunk, raws, elided):
                    if is_elided:
                        entries.append(["z"])
                        block_rows.append(
                            (model_id, tensor_id, rng.block_idx, "elided",
                             None, 0, rng.nbytes)
                        )
                        totals["elided_blocks"] += 1
                        continue
                    payload, encoding = next(encoded)
                    base_key = content_hash(raw)
                    key, ent = base_key, extents.get(base_key)
                    suffix = 0
                    while ent is not None:
                        # verify a dedup hit byte-for-byte against the
                        # stored payload (64-bit content hashes alias
                        # eventually; a silent collision would substitute
                        # one block's weights for another's).  A mismatch
                        # — collision or dtype-dependent encoding — gets a
                        # disambiguated key.
                        data_f.flush()
                        stored = os.pread(data_f.fileno(), ent[1], ent[0])
                        if ent[3] == encoding and stored == payload:
                            break
                        suffix += 1
                        key = f"{base_key}~{suffix}"
                        ent = extents.get(key)
                    if ent is None:
                        data_f.write(payload)
                        self.stats.record_write("repack", len(payload))
                        ent = extents[key] = [
                            offset, len(payload), rng.nbytes, encoding,
                            spec["dtype"], 0,
                        ]
                        offset += len(payload)
                        m_physical += len(payload)
                        totals["physical_bytes"] += len(payload)
                    else:
                        totals["dedup_blocks"] += 1
                    ent[5] += 1
                    totals["extent_blocks"] += 1
                    t_physical += ent[1]
                    entries.append(["x", key])
                    if kind != "adapter":
                        # adapters get costing rows on the *virtual*
                        # base-grid below (factor extents are
                        # reading-map-only, so the catalog never
                        # double-counts their bytes)
                        block_rows.append(
                            (model_id, tensor_id, rng.block_idx, "extent",
                             key, ent[1], rng.nbytes)
                        )
            member["blocks"][tensor_id] = entries
            if kind == "adapter" and tensor_id.endswith(
                ("::lora_A", "::lora_B")
            ):
                target = tensor_id.rsplit("::", 1)[0]
                factor_physical[target] = (
                    factor_physical.get(target, 0) + t_physical
                )
        if kind == "adapter":
            # costing rows on the base tensor's virtual block grid, packed
            # factor bytes prorated exactly like ANALYZE prorates logical
            # factor bytes — planner candidates index (target, block).
            rows = list(self._adapter_cost_rows(
                model_id, base_reader, block_size, factor_physical, reader,
            ))
            block_rows.extend(rows)
            adapter_rows.extend(rows)
        members[model_id] = member
        return m_logical, m_physical, offset

    @staticmethod
    def _elide(
        raw: bytes,
        rng,
        tensor_id: str,
        kind: str,
        base_spec,
        base_cache: "_BaseTensorCache",
        np_dtype,
        options: RepackOptions,
    ) -> bool:
        if kind == "delta":
            if raw == b"\x00" * len(raw):
                return True
            if options.elide_threshold > 0:
                x = dtypes.to_float32(np.frombuffer(raw, dtype=np_dtype))
                return bool(
                    np.isfinite(x).all()
                    and np.linalg.norm(x) <= options.elide_threshold
                )
            return False
        if base_spec is None:
            return False
        base_raw = base_cache.block_bytes(tensor_id, rng)
        if raw == base_raw:
            # byte-identical to base => delta is exactly zero, *provided*
            # the values are finite (NaN - NaN != 0); non-finite blocks
            # fall through to normal dedup
            x = np.frombuffer(raw, dtype=np_dtype)
            return bool(np.isfinite(dtypes.to_float32(x)).all())
        if options.elide_threshold > 0:
            x = dtypes.to_float32(np.frombuffer(raw, dtype=np_dtype))
            x0 = dtypes.to_float32(np.frombuffer(base_raw, dtype=np_dtype))
            d = x - x0
            return bool(
                np.isfinite(d).all()
                and np.linalg.norm(d) <= options.elide_threshold
            )
        return False

    @staticmethod
    def _adapter_cost_rows(
        model_id: str,
        base_reader,
        block_size: int,
        factor_physical: Dict[str, int],
        reader,
    ):
        for target, phys in sorted(factor_physical.items()):
            if target not in base_reader.specs:
                continue  # tensor-level fallback expert; planner uses logical
            a_spec = reader.spec(f"{target}::lora_A")
            b_spec = reader.spec(f"{target}::lora_B")
            logical = a_spec.nbytes + b_spec.nbytes
            ranges = blk.partition(base_reader.spec(target).nbytes, block_size)
            if not ranges:
                continue
            per_phys = phys // len(ranges)
            per_log = logical // len(ranges)
            for i, rng in enumerate(ranges):
                last = i == len(ranges) - 1
                yield (
                    model_id, target, rng.block_idx, "adapter", None,
                    phys - per_phys * (len(ranges) - 1) if last else per_phys,
                    logical - per_log * (len(ranges) - 1) if last else per_log,
                )


class PackedLayout:
    """One opened packed layout: extent file + member block maps.

    Thread-safe: extent reads use ``pread`` on a shared fd; multi-consumer
    extents are read once (a per-extent in-flight latch makes concurrent
    first readers wait instead of double-reading) and pinned for the
    layout's lifetime so later consumers are served from memory with zero
    I/O — matching the planner's read-each-extent-once cost model.
    """

    def __init__(
        self,
        ldir: str,
        stats: IOStats,
        models: Optional[CheckpointStore] = None,
        max_pinned_bytes: Optional[int] = None,
    ):
        self.dir = ldir
        self.stats = stats
        self.models = models
        self.max_pinned_bytes = max_pinned_bytes
        path = os.path.join(ldir, LAYOUT_MANIFEST)
        with open(path, "rb") as f:
            raw = f.read()
        stats.record_read("meta", len(raw))
        doc = json.loads(raw)
        self.layout_id: str = doc["layout_id"]
        self.base_id: str = doc["base_id"]
        self.block_size: int = int(doc["block_size"])
        self.options = RepackOptions.from_dict(doc["options"])
        self.lossless: bool = bool(doc["lossless"])
        self.layout_stats: Dict = doc.get("stats", {})
        #: key -> (offset, physical, logical, encoding, dtype, refs)
        self.extents: Dict[str, Tuple] = {
            k: tuple(v) for k, v in doc["extents"].items()
        }
        self.members: Dict[str, Dict] = doc["members"]
        self._fd = os.open(os.path.join(ldir, EXTENT_FILE), os.O_RDONLY)
        self._lock = threading.Lock()
        self._cache: Dict[str, bytes] = {}  # guarded-by: _lock
        self._inflight: Dict[str, threading.Event] = {}  # guarded-by: _lock
        self.pinned_bytes = 0  # guarded-by: _lock
        #: physical bytes recorded for extents this open already read
        #: once (only possible when ``max_pinned_bytes`` evicts a
        #: multi-consumer extent before all consumers were served); the
        #: executor widens its budget-soundness slack by this amount —
        #: the planner charged each extent once, honestly-accounted
        #: rereads are a memory-cap tradeoff, not a plan violation
        self.reread_bytes = 0  # guarded-by: _lock
        self._read_keys: set = set()  # guarded-by: _lock
        self._base_reader = None  # guarded-by: _base_lock
        self._base_lock = threading.Lock()
        self._closed = False  # guarded-by: _lock
        #: verify decoded extents against their content-hash key
        #: (repro_torch.store.integrity contract; lossless encodings only —
        #: a downcast extent cannot reproduce its pre-encoding hash)
        self.verify = True
        #: flat-source bytes read to serve quarantined/corrupt extents;
        #: folded into executor budget slack like reread_bytes
        self.repair_bytes = 0  # guarded-by: _lock
        #: extent keys verified corrupt — never served again; loaded
        #: from QUARANTINE.json, persisted on every new quarantine
        self.quarantined: set = set()  # guarded-by: _lock
        try:
            with open(os.path.join(ldir, QUARANTINE_FILE), "rb") as f:
                self.quarantined = set(json.loads(f.read()).get("extents", []))
        except (FileNotFoundError, ValueError):
            pass
        self._quar_write_lock = threading.Lock()
        self._flat_readers: Dict[str, object] = {}  # guarded-by: _flat_lock
        self._flat_lock = threading.Lock()

    # -- members -----------------------------------------------------------
    def member_ids(self) -> List[str]:
        return sorted(self.members)

    def open_member(self, model_id: str) -> "PackedModelReader":
        if model_id not in self.members:
            raise KeyError(
                f"model {model_id!r} is not a member of layout "
                f"{self.layout_id!r} (members: {self.member_ids()})"
            )
        return PackedModelReader(self, model_id)

    # -- physical reads ----------------------------------------------------
    # unaccounted-ok: raw extent fetch — every caller (_read_decode,
    # read_extents, base_block) tags the bytes per extent with
    # expert_packed/base plus decode waste, which this helper cannot know
    def _pread(self, off: int, nbytes: int) -> bytes:
        chunks = []
        got = 0
        while got < nbytes:
            chunk = os.pread(self._fd, nbytes - got, off + got)
            if not chunk:
                break
            chunks.append(chunk)
            got += len(chunk)
        data = chunks[0] if len(chunks) == 1 else b"".join(chunks)
        if len(data) != nbytes:
            raise IOError(
                f"short extent read in layout {self.layout_id} "
                f"[{off}:{off+nbytes}]: got {len(data)}"
            )
        # at-rest bit-rot in extents.bin lands here, after the short-read
        # check: a corrupt payload has plausible framing and is only
        # caught by decode/content-hash verification downstream
        return chaos_corrupt("packed:extent", data)

    def _note_read(self, key: str, phys: int) -> None:
        with self._lock:
            if key in self._read_keys:
                self.reread_bytes += phys
            else:
                self._read_keys.add(key)

    def _decode_verified(self, key: str, ent: Tuple, payload: bytes) -> bytes:
        """Decode one extent payload and enforce the integrity contract:
        the decoded logical bytes must hash back to the extent's own
        content-hash key (lossless encodings only — a ``cast:`` extent
        cannot reproduce its pre-encoding hash).  Undecodable or
        hash-mismatched extents are quarantined and raise
        :class:`~repro_torch.store.integrity.CorruptBlockError` so the member
        reader can fall back to the flat source."""
        _off, _phys, logical, encoding, dtype_name, _refs = ent
        try:
            raw = decode_extent(payload, encoding, dtype_name, logical)
        except (IOError, ValueError, zlib.error) as e:
            self.quarantine_extent(key)
            raise CorruptBlockError(
                f"undecodable extent {key} in layout {self.layout_id} "
                f"(encoding {encoding!r}): {e}",
                tier="packed",
                extent_key=key,
            ) from e
        if self.verify and "cast:" not in encoding:
            expected = key.split("~", 1)[0]
            actual = content_hash(raw)
            if actual != expected:
                self.quarantine_extent(key)
                raise CorruptBlockError(
                    f"corrupt extent {key} in layout {self.layout_id}: "
                    f"decoded bytes hash {actual}, key says {expected}",
                    tier="packed",
                    extent_key=key,
                    expected=expected,
                    actual=actual,
                )
        return raw

    def _read_decode(self, key: str, ent: Tuple, category: str) -> bytes:
        off, phys, _logical, _encoding, _dtype_name, _refs = ent
        payload = self._pread(off, phys)
        # the *physical* (possibly compressed/downcast) bytes are what
        # moved from storage — that is what the category counts
        self.stats.record_read(
            "expert_packed" if category == "expert" else category, phys
        )
        self._note_read(key, phys)
        return self._decode_verified(key, ent, payload)

    def read_extent(self, key: str, category: str) -> bytes:
        """Logical raw bytes of one extent; multi-consumer extents are
        physically read once per opened layout and pinned."""
        ent = self.extents[key]
        if ent[5] <= 1:  # single consumer: no fan-out to coordinate
            return self._read_decode(key, ent, category)
        while True:
            with self._lock:
                hit = self._cache.get(key)
                if hit is not None:
                    return hit  # fan-out: zero I/O, zero accounting
                ev = self._inflight.get(key)
                if ev is None:
                    ev = self._inflight[key] = threading.Event()
                    break
            ev.wait()  # another thread is reading this extent
        try:
            raw = self._read_decode(key, ent, category)
            with self._lock:
                if (
                    self.max_pinned_bytes is None
                    or self.pinned_bytes + len(raw) <= self.max_pinned_bytes
                ):
                    self._cache[key] = raw
                    self.pinned_bytes += len(raw)
            return raw
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            ev.set()

    def read_extents(self, keys: Sequence[str], category: str) -> Dict[str, bytes]:
        """Batch extent read.  Multi-consumer extents go through the
        pinned fan-out cache; single-consumer extents that sit adjacent
        in ``extents.bin`` (a member's unique blocks are appended in
        repack order, so selections over one tensor usually do) coalesce
        into one ``pread`` per run — the packed counterpart of the flat
        reader's run-granular streaming."""
        out: Dict[str, bytes] = {}
        direct: List[Tuple[int, str]] = []
        for k in dict.fromkeys(keys):  # preserve order, drop duplicates
            ent = self.extents[k]
            if ent[5] > 1:
                out[k] = self.read_extent(k, category)
            else:
                direct.append((ent[0], k))
        direct.sort()
        cat = "expert_packed" if category == "expert" else category
        i = 0
        while i < len(direct):
            start = direct[i][0]
            end = start + self.extents[direct[i][1]][1]
            j = i + 1
            while j < len(direct) and direct[j][0] == end:
                end += self.extents[direct[j][1]][1]
                j += 1
            data = self._pread(start, end - start)
            self.stats.record_read(cat, end - start)
            for off, k in direct[i:j]:
                ent = self.extents[k]
                lo = off - start
                self._note_read(k, ent[1])
                out[k] = self._decode_verified(k, ent, data[lo:lo + ent[1]])
            i = j
        return out

    # -- quarantine + flat-source fallback ----------------------------------
    def expected_hash(self, key: str) -> Optional[str]:
        """The content hash a repaired read must reproduce for this
        extent — None for lossy (``cast:``) extents, whose key hashes
        pre-encoding bytes the layout can no longer produce."""
        ent = self.extents[key]
        return None if "cast:" in ent[3] else key.split("~", 1)[0]

    def quarantine_extent(self, key: str) -> None:
        """Mark one extent corrupt, durably: it is dropped from the
        pinned cache, excluded from every future read (this open and
        later ones — QUARANTINE.json persists next to the manifest), and
        its consumers fall back to their flat source checkpoints."""
        with self._lock:
            if key in self.quarantined:
                return
            self.quarantined.add(key)
            hit = self._cache.pop(key, None)
            if hit is not None:
                self.pinned_bytes -= len(hit)
        with self._quar_write_lock:
            with self._lock:
                snapshot = sorted(self.quarantined)
            qpath = os.path.join(self.dir, QUARANTINE_FILE)
            tmp = qpath + ".tmp"
            with open(tmp, "w") as f:
                json.dump(
                    {"layout_id": self.layout_id, "extents": snapshot}, f
                )
                f.flush()
                os.fsync(f.fileno())
            # chaos-ok: losing a quarantine record on crash only means the
            # same corrupt extent is re-detected (and re-quarantined) on
            # its next read — the verify contract, not this file, is the
            # integrity boundary
            os.replace(tmp, qpath)

    def _flat_reader(self, model_id: str):
        with self._flat_lock:
            reader = self._flat_readers.get(model_id)
            if reader is None:
                if self.models is None:
                    raise CorruptBlockError(
                        f"layout {self.layout_id} cannot repair member "
                        f"{model_id}: no source CheckpointStore attached",
                        tier="packed",
                        model_id=model_id,
                    )
                try:
                    reader = self.models.open_model(model_id)
                except (OSError, KeyError, ValueError, RuntimeError) as e:
                    raise CorruptBlockError(
                        f"layout {self.layout_id} member {model_id} has a "
                        f"corrupt extent and no readable flat source to "
                        f"fall back to: {e}",
                        tier="packed",
                        model_id=model_id,
                    ) from e
                self._flat_readers[model_id] = reader
            return reader

    def flat_fallback(
        self,
        model_id: str,
        tensor_id: str,
        block_idx: int,
        block_size: int,
        category: str,
        expected: Optional[str] = None,
    ) -> np.ndarray:
        """Serve one block of a quarantined extent from the member's
        flat source checkpoint (the member's own kind semantics hold:
        full/delta/adapter flat sources all store the same logical bytes
        the extent did).  The bytes are verified against ``expected``
        when the extent was lossless; repair traffic is billed to
        ``expert_repair`` and tracked in :attr:`repair_bytes`.  Raises
        :class:`~repro_torch.store.integrity.CorruptBlockError` when no flat
        source exists or it disagrees with the contract — an
        unrepairable block must fail the job, never approximate it."""
        reader = self._flat_reader(model_id)
        cat = (
            "expert_repair" if category in ("expert", "expert_packed")
            else category
        )
        try:
            arr = reader.read_block(tensor_id, block_idx, block_size, cat)
        except (OSError, KeyError, ValueError) as e:
            raise CorruptBlockError(
                f"flat fallback failed for {model_id}/{tensor_id}"
                f"[{block_idx}] (layout {self.layout_id}): {e}",
                tier="packed",
                model_id=model_id,
                tensor_id=tensor_id,
                block_idx=block_idx,
            ) from e
        raw = np.ascontiguousarray(arr).tobytes()
        if expected is not None and content_hash(raw) != expected:
            raise CorruptBlockError(
                f"flat fallback for {model_id}/{tensor_id}[{block_idx}] "
                f"does not match the cataloged extent hash {expected} "
                f"(got {content_hash(raw)}): source checkpoint diverged "
                f"or is itself corrupt",
                tier="packed",
                model_id=model_id,
                tensor_id=tensor_id,
                block_idx=block_idx,
                expected=expected,
                actual=content_hash(raw),
            )
        with self._lock:
            self.repair_bytes += len(raw)
        return arr

    def base_block(
        self, tensor_id: str, block_idx: int, block_size: int, category: str
    ) -> np.ndarray:
        """Synthesize an elided full-kind block from the base checkpoint
        (only used when reading a packed member *outside* a merge; the
        executor's DeltaIterator synthesizes the zero delta itself from
        the base block it already read)."""
        with self._base_lock:
            if self._base_reader is None:
                if self.models is None:
                    raise RuntimeError(
                        f"layout {self.layout_id} cannot synthesize elided "
                        f"blocks: no source CheckpointStore attached"
                    )
                self._base_reader = self.models.open_model(self.base_id)
            reader = self._base_reader
        # these are base-checkpoint bytes: never charge them as expert
        # reads — elided blocks move zero expert bytes by contract
        return reader.read_block(
            tensor_id, block_idx, block_size,
            "base" if category == "expert" else category,
        )

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._cache.clear()
            self.pinned_bytes = 0
        os.close(self._fd)
        with self._base_lock:
            if self._base_reader is not None:
                self._base_reader.close()
                self._base_reader = None
        with self._flat_lock:
            for reader in self._flat_readers.values():
                reader.close()
            self._flat_readers.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackedModelReader:
    """ModelReader-compatible view over one member of a packed layout.

    Implements the exact read surface the executor and
    :class:`~repro_torch.core.delta_iterator.DeltaIterator` use (plus
    :meth:`elided_blocks`, which the iterator consults to synthesize
    zero deltas without any I/O), so it can be passed anywhere a flat
    :class:`~repro_torch.store.tensorstore.ModelReader` is expected — including
    wrapped in a :class:`~repro_torch.store.blockcache.CachingModelReader`.
    """

    def __init__(self, layout: PackedLayout, model_id: str):
        self.layout = layout
        self.model_id = model_id
        member = layout.members[model_id]
        self.meta: Dict = member.get("meta", {})
        self.specs: Dict[str, TensorSpec] = {
            name: TensorSpec({**spec, "file": EXTENT_FILE})
            for name, spec in member["tensors"].items()
        }
        self._blocks: Dict[str, List] = member["blocks"]
        self._elided: Dict[str, frozenset] = {
            t: frozenset(
                i for i, e in enumerate(entries) if e and e[0] == "z"
            )
            for t, entries in self._blocks.items()
        }

    # -- structure ---------------------------------------------------------
    def tensor_names(self) -> List[str]:
        return list(self.specs.keys())

    def spec(self, tensor_id: str) -> TensorSpec:
        return self.specs[tensor_id]

    def total_nbytes(self) -> int:
        return sum(s.nbytes for s in self.specs.values())

    def num_blocks(self, tensor_id: str, block_size: int) -> int:
        return blk.num_blocks(self.specs[tensor_id].nbytes, block_size)

    def elided_blocks(self, tensor_id: str) -> frozenset:
        """Blocks whose delta is (near-)zero: metadata-only, zero read
        cost — the DeltaIterator synthesizes their contribution."""
        return self._elided.get(tensor_id, frozenset())

    def _check_block_size(self, block_size: int) -> None:
        if block_size != self.layout.block_size:
            raise ValueError(
                f"layout {self.layout.layout_id} is packed at block_size="
                f"{self.layout.block_size}, cannot read at {block_size}"
            )

    # -- reads -------------------------------------------------------------
    def read_block(
        self, tensor_id: str, block_idx: int, block_size: int, category: str
    ) -> np.ndarray:
        self._check_block_size(block_size)
        spec = self.specs[tensor_id]
        entry = self._blocks[tensor_id][block_idx]
        if entry[0] == "z":
            kind = self.meta.get("kind", "full")
            if kind == "delta":
                rng = blk.block_range(spec.nbytes, block_idx, block_size)
                n = rng.nbytes // spec.dtype.itemsize
                return np.zeros(n, dtype=spec.dtype)
            return self.layout.base_block(
                tensor_id, block_idx, block_size, category
            )
        key = entry[1]
        if key in self.layout.quarantined:
            return self.layout.flat_fallback(
                self.model_id, tensor_id, block_idx, block_size, category,
                expected=self.layout.expected_hash(key),
            )
        try:
            raw = self.layout.read_extent(key, category)
        except CorruptBlockError:
            # the read just quarantined this extent; serve the block from
            # the flat source (raises again if none exists — unrepairable)
            return self.layout.flat_fallback(
                self.model_id, tensor_id, block_idx, block_size, category,
                expected=self.layout.expected_hash(key),
            )
        return np.frombuffer(raw, dtype=spec.dtype)

    def read_blocks_coalesced(
        self,
        tensor_id: str,
        block_idxs: Sequence[int],
        block_size: int,
        category: str,
        gap_bytes: int = 0,
    ) -> Dict[int, np.ndarray]:
        """Batched block read: dedup fan-out for shared extents, plus
        run coalescing of adjacent unique extents (see
        :meth:`PackedLayout.read_extents`).  ``gap_bytes`` is accepted
        for flat-reader surface compatibility; extent runs coalesce only
        when exactly adjacent (there are no unselected bytes between
        extents to skip)."""
        self._check_block_size(block_size)
        out: Dict[int, np.ndarray] = {}
        want_keys: List[str] = []
        key_blocks: Dict[str, List[int]] = {}
        entries = self._blocks[tensor_id]
        for b in block_idxs:
            entry = entries[b]
            if entry[0] == "z":
                out[b] = self.read_block(tensor_id, b, block_size, category)
            else:
                want_keys.append(entry[1])
                key_blocks.setdefault(entry[1], []).append(b)
        if want_keys:
            spec = self.specs[tensor_id]
            pending = list(dict.fromkeys(want_keys))
            while pending:
                # quarantined keys (pre-existing, or added by a failed
                # batch below) serve their blocks from the flat source
                for k in pending:
                    if k in self.layout.quarantined:
                        expected = self.layout.expected_hash(k)
                        for b in key_blocks[k]:
                            out[b] = self.layout.flat_fallback(
                                self.model_id, tensor_id, b, block_size,
                                category, expected=expected,
                            )
                pending = [
                    k for k in pending if k not in self.layout.quarantined
                ]
                if not pending:
                    break
                try:
                    raws = self.layout.read_extents(pending, category)
                except CorruptBlockError:
                    # every failure quarantines >= 1 key, so this loop
                    # strictly shrinks ``pending`` and terminates; clean
                    # extents re-read on retry are honestly re-recorded
                    continue
                for k in pending:
                    arr = np.frombuffer(raws[k], dtype=spec.dtype)
                    for b in key_blocks[k]:
                        out[b] = arr
                break
        return out

    def read_tensor(self, tensor_id: str, category: str) -> np.ndarray:
        spec = self.specs[tensor_id]
        n = self.num_blocks(tensor_id, self.layout.block_size)
        if n == 0:
            return np.zeros(spec.shape, dtype=spec.dtype)
        parts = [
            self.read_block(tensor_id, b, self.layout.block_size, category)
            for b in range(n)
        ]
        flat = parts[0] if n == 1 else np.concatenate(parts)
        return flat.reshape(spec.shape)

    def read_range(self, *a, **kw):  # pragma: no cover - guard rail
        raise NotImplementedError(
            "PackedModelReader has no byte-offset surface; read blocks"
        )

    def close(self) -> None:
        # the layout owns the fd / cache; member views are lightweight
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
