"""Byte-accurate I/O accounting.

Every physical read/write in the storage layer is tagged with a *category*
mirroring the paper's cost decomposition (§3.2):

    base    — reads of the base model          (C_base)
    expert  — reads of expert checkpoints      (C_expert, the O(K) term)
    expert_packed — physical extent reads serving expert blocks from a
              packed layout (dedup-/elision-/compression-aware; see
              repro_torch.store.packed).  Counted into C_expert — it is the
              same cost term, just with smaller bytes behind each read —
              but kept as its own category so packed-vs-flat physical
              volume stays directly comparable.
    expert_remote — expert bytes fetched from a remote object store
              (repro_torch.store.remote) on a tiered-cache miss.  Counted into
              C_expert: these are the cold moved bytes the budget B
              governs.
    expert_disk — expert bytes served from the local-disk extent cache
              (repro_torch.store.tiered).  Like RAM-cache hits these are NOT
              part of the budget-enforced C_expert term (the budget
              bounds cold fetches, §3.2) but they are real local I/O, so
              they appear in ``total_expert_bytes``.
    expert_repair — expert bytes refetched/re-read to *repair* a block
              that failed verify-on-read (repro_torch.store.integrity): a
              corrupt disk-cache extent refilled from remote, or a
              quarantined packed extent served from its flat source.
              Counted into C_expert (they are cold moved bytes) but kept
              separate so repair traffic is directly visible and never
              double-counted with ``expert_remote`` — each physical
              fetch is billed to exactly one category.
    out     — writes of the merged output      (C_out)
    meta    — catalog / manifest / hash I/O    (C_meta)
    repack  — one-time PackedStore repack I/O (amortized, like analyze)
    journal — progress-journal appends + recovery validation re-reads
              (repro_torch.store.journal).  Counted into C_meta — it is
              bookkeeping I/O, not parameter movement — but kept as its
              own category so the crash-resumability overhead is
              directly measurable.

Resumed runs additionally track *skipped* bytes: logical volume a
resumed merge did NOT move because the journal proved those blocks were
already staged (``record_skip`` / ``resumed_skipped_bytes``).  Skips are
bookkeeping only — they never enter any C_* cost term — but they let
tests assert residual-read accounting exactly: bytes(full run) ==
bytes(crashed run) + bytes(resumed run) + 0·skipped.

The benchmark harness reads these counters to reproduce the paper's
tables; the executor's budget-soundness property test asserts
``expert_bytes_read <= B`` directly against them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from typing import Dict, Iterator

CATEGORIES = (
    "base", "expert", "expert_packed", "expert_remote", "expert_disk",
    "expert_repair", "out", "meta", "analyze", "repack", "journal", "other",
)

#: every category that serves plan-selected expert blocks, regardless of
#: which storage tier the bytes physically came from
EXPERT_CATEGORIES = (
    "expert", "expert_packed", "expert_remote", "expert_disk", "expert_repair",
)

#: cache tiers record_cache accepts — tier names, NOT categories
TIERS = ("ram", "disk")


class IOStatsError(ValueError):
    """Debug-mode accounting violation: unknown category/tier or a
    broken totals decomposition."""


@dataclasses.dataclass
class Counter:
    bytes: int = 0
    calls: int = 0

    def add(self, nbytes: int) -> None:
        self.bytes += nbytes
        self.calls += 1


class IOStats:
    """Thread-safe tagged byte counters.

    With ``debug=True`` every ``record_*`` call validates its category
    (tier for ``record_cache``) against the closed sets above, so a
    typo'd category fails at the call site instead of silently leaking
    bytes out of every C_* cost term.  The test suite's ``stats``
    fixture runs in debug mode and calls :meth:`self_check` at
    teardown; production paths default to ``debug=False`` and skip the
    membership test on the hot path.
    """

    def __init__(self, debug: bool = False) -> None:
        self.debug = debug
        self._lock = threading.Lock()
        self.read: Dict[str, Counter] = defaultdict(Counter)  # guarded-by: _lock
        self.written: Dict[str, Counter] = defaultdict(Counter)  # guarded-by: _lock
        # per-tier cache effectiveness ("ram" / "disk"): a hit is a read
        # served without touching the next tier down
        self.cache_hits: Dict[str, Counter] = defaultdict(Counter)  # guarded-by: _lock
        self.cache_misses: Dict[str, Counter] = defaultdict(Counter)  # guarded-by: _lock
        # logical bytes a resumed run skipped thanks to journaled progress
        self.skipped: Dict[str, Counter] = defaultdict(Counter)  # guarded-by: _lock
        # per-shard read/write rollup absorbed from distributed workers:
        # shard key -> {"read"|"written": {category: bytes}}; every byte
        # here is ALSO in the flat counters above (shards is a view for
        # billing/explain, never a second source of truth)
        self.shards: Dict[str, Dict[str, Dict[str, int]]] = {}  # guarded-by: _lock

    # -- recording -----------------------------------------------------
    def _validate(self, name: str, allowed, kind: str) -> None:
        if self.debug and name not in allowed:
            raise IOStatsError(
                "unknown %s %r (expected one of %s)"
                % (kind, name, ", ".join(allowed))
            )

    def record_read(self, category: str, nbytes: int) -> None:
        self._validate(category, CATEGORIES, "category")
        with self._lock:
            self.read[category].add(nbytes)

    def record_write(self, category: str, nbytes: int) -> None:
        self._validate(category, CATEGORIES, "category")
        with self._lock:
            self.written[category].add(nbytes)

    def record_cache(self, tier: str, nbytes: int, hit: bool) -> None:
        self._validate(tier, TIERS, "cache tier")
        with self._lock:
            (self.cache_hits if hit else self.cache_misses)[tier].add(nbytes)

    def record_skip(self, category: str, nbytes: int) -> None:
        """Logical bytes NOT moved because a resume state proved the work
        already done (journal high-water mark).  Never part of C_*."""
        self._validate(category, CATEGORIES, "category")
        with self._lock:
            self.skipped[category].add(nbytes)

    def absorb(self, snap: Dict[str, Dict[str, Dict[str, int]]],
               shard: str = None) -> None:
        """Fold another :meth:`snapshot` into this instance — the
        coordinator-side rollup for per-worker stats in sharded
        execution.  Adds bytes AND call counts (so rates and
        per-request costs stay meaningful after the merge); with
        ``shard`` set, the same bytes are also accumulated under
        ``self.shards[shard]`` so billing and ``explain()`` can report
        the per-shard decomposition.  Debug mode validates the
        absorbed categories against the closed sets, exactly as if the
        worker had recorded into this instance directly."""
        if self.debug:
            for kind, allowed in (
                ("read", CATEGORIES), ("written", CATEGORIES),
                ("skipped", CATEGORIES),
                ("cache_hits", TIERS), ("cache_misses", TIERS),
            ):
                for key in snap.get(kind, {}):
                    self._validate(key, allowed, "absorbed " + kind)
        with self._lock:
            for kind, target in (
                ("read", self.read), ("written", self.written),
                ("cache_hits", self.cache_hits),
                ("cache_misses", self.cache_misses),
                ("skipped", self.skipped),
            ):
                for key, ctr in snap.get(kind, {}).items():
                    target[key].bytes += int(ctr.get("bytes", 0))
                    target[key].calls += int(ctr.get("calls", 0))
            if shard is not None:
                rollup = self.shards.setdefault(
                    str(shard), {"read": {}, "written": {}})
                for kind in ("read", "written"):
                    for key, ctr in snap.get(kind, {}).items():
                        rollup[kind][key] = (
                            rollup[kind].get(key, 0) + int(ctr.get("bytes", 0))
                        )

    def shard_rollup(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """Deep copy of the per-shard byte rollup (empty for
        single-process runs)."""
        with self._lock:
            return {
                s: {kind: dict(cats) for kind, cats in roll.items()}
                for s, roll in self.shards.items()
            }

    # -- queries (paper cost terms) -------------------------------------
    # Queries must not mutate the defaultdicts (a bare ``self.read[cat]``
    # inserts a key) — the pipelined executor reads these counters while
    # prefetch/write-behind threads are recording into them.
    def bytes_read(self, category: str) -> int:
        with self._lock:
            c = self.read.get(category)
            return c.bytes if c is not None else 0

    def bytes_written(self, category: str) -> int:
        with self._lock:
            c = self.written.get(category)
            return c.bytes if c is not None else 0

    @property
    def c_base(self) -> int:
        return self.bytes_read("base")

    @property
    def c_expert(self) -> int:
        """Budget-enforced expert-read cost term: flat checkpoint reads,
        physical packed-extent reads, cold remote fetches, and
        read-repair refetches (all move bytes the budget B governs —
        repair traffic widens executor slack the way evict-refetches
        do).  Warm-tier hits — RAM (recorded as zero I/O) and
        local-disk extent-cache reads (``expert_disk``) — are
        deliberately excluded: the budget bounds cold moved bytes."""
        return (
            self.bytes_read("expert")
            + self.bytes_read("expert_packed")
            + self.bytes_read("expert_remote")
            + self.bytes_read("expert_repair")
        )

    @property
    def total_expert_bytes(self) -> int:
        """All bytes that served expert blocks, across every tier —
        the full physical expert-side volume (>= ``c_expert``)."""
        return sum(self.bytes_read(c) for c in EXPERT_CATEGORIES)

    def cache_counters(self, tier: str) -> Dict[str, int]:
        """Hit/miss counters for one cache tier (``"ram"`` / ``"disk"``)."""
        with self._lock:
            h = self.cache_hits.get(tier)
            m = self.cache_misses.get(tier)
            return {
                "hits": h.calls if h else 0,
                "hit_bytes": h.bytes if h else 0,
                "misses": m.calls if m else 0,
                "miss_bytes": m.bytes if m else 0,
            }

    @property
    def c_out(self) -> int:
        return self.bytes_written("out")

    @property
    def c_meta(self) -> int:
        return (
            self.bytes_read("meta")
            + self.bytes_written("meta")
            + self.bytes_read("other")
            + self.bytes_written("other")
            + self.c_journal
        )

    @property
    def c_journal(self) -> int:
        """Progress-journal overhead: appended records plus recovery
        validation re-reads.  A component of C_meta, broken out so the
        crash-resumability tax is directly visible."""
        return self.bytes_read("journal") + self.bytes_written("journal")

    @property
    def resumed_skipped_bytes(self) -> int:
        """Logical bytes a resumed run avoided moving (all categories)."""
        with self._lock:
            return sum(c.bytes for c in self.skipped.values())

    @property
    def c_analyze(self) -> int:
        """One-time ANALYZE reads — amortized across iterative merges,
        reported separately from the per-merge budgeted expert reads."""
        return self.bytes_read("analyze")

    @property
    def c_total(self) -> int:
        """Total I/O volume — C_base + C_expert + C_out + C_meta (§3.2)."""
        return self.c_base + self.c_expert + self.c_out + self.c_meta

    def snapshot(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {
                "read": {k: dataclasses.asdict(v) for k, v in self.read.items()},
                "written": {k: dataclasses.asdict(v) for k, v in self.written.items()},
                "cache_hits": {
                    k: dataclasses.asdict(v) for k, v in self.cache_hits.items()
                },
                "cache_misses": {
                    k: dataclasses.asdict(v) for k, v in self.cache_misses.items()
                },
                "skipped": {
                    k: dataclasses.asdict(v) for k, v in self.skipped.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self.read.clear()
            self.written.clear()
            self.cache_hits.clear()
            self.cache_misses.clear()
            self.skipped.clear()
            self.shards.clear()

    def self_check(self) -> None:
        """Accounting-completeness invariant.  Raises
        :class:`IOStatsError` if any recorded counter sits outside the
        closed category/tier sets (bytes that no C_* cost term would
        count), if a counter went negative or recorded bytes without a
        call, or if the documented totals decomposition broke:
        ``total_expert_bytes == c_expert + expert_disk`` and the C_*
        terms together cover every recorded byte."""
        snap = self.snapshot()
        problems = []
        for kind, allowed in (
            ("read", CATEGORIES), ("written", CATEGORIES),
            ("skipped", CATEGORIES),
            ("cache_hits", TIERS), ("cache_misses", TIERS),
        ):
            for key, ctr in snap[kind].items():
                if key not in allowed:
                    problems.append(
                        "%s counter for unknown key %r (%d bytes would "
                        "escape every cost term)" % (kind, key, ctr["bytes"])
                    )
                if ctr["bytes"] < 0 or ctr["calls"] < 0:
                    problems.append(
                        "%s[%r] went negative: %r" % (kind, key, ctr))
                if ctr["bytes"] > 0 and ctr["calls"] == 0:
                    problems.append(
                        "%s[%r] has bytes without calls: %r"
                        % (kind, key, ctr))
        if self.total_expert_bytes != (
            self.c_expert + self.bytes_read("expert_disk")
        ):
            problems.append(
                "expert decomposition broke: total_expert_bytes=%d != "
                "c_expert=%d + expert_disk=%d"
                % (self.total_expert_bytes, self.c_expert,
                   self.bytes_read("expert_disk"))
            )
        declared = (
            self.c_base + self.c_expert + self.c_out + self.c_meta
            + self.bytes_read("expert_disk") + self.c_analyze
            + self.bytes_read("repack") + self.bytes_written("repack")
        )
        accounted = sum(c["bytes"] for c in snap["read"].values()) + sum(
            c["bytes"] for c in snap["written"].values())
        if declared != accounted:
            problems.append(
                "cost terms do not cover recorded volume: terms=%d "
                "recorded=%d" % (declared, accounted))
        # the shard rollup is a view over the flat counters: per
        # category, the sum across shards can never exceed the total
        # (coordinator-side bytes make the totals strictly larger)
        rollup = self.shard_rollup()
        for kind in ("read", "written"):
            per_cat: Dict[str, int] = {}
            for roll in rollup.values():
                for key, nbytes in roll.get(kind, {}).items():
                    per_cat[key] = per_cat.get(key, 0) + nbytes
            for key, nbytes in per_cat.items():
                if key not in CATEGORIES:
                    problems.append(
                        "shard rollup has unknown %s category %r" % (kind, key))
                    continue
                total = snap[kind].get(key, {}).get("bytes", 0)
                if nbytes > total:
                    problems.append(
                        "shard rollup exceeds flat counter: %s[%r] "
                        "shards=%d total=%d" % (kind, key, nbytes, total))
        if problems:
            raise IOStatsError("; ".join(problems))

    def delta_since(self, before: Dict[str, Dict[str, int]]) -> Dict[str, int]:
        now = self.snapshot()

        def _get(snap, kind, cat):
            return snap[kind].get(cat, {}).get("bytes", 0)

        return {
            "base_read": _get(now, "read", "base") - _get(before, "read", "base"),
            # total expert-serving bytes across every tier (matches
            # ``total_expert_bytes``); warm disk hits included — use
            # ``expert_remote_read`` for cold remote volume alone
            "expert_read": sum(
                _get(now, "read", c) - _get(before, "read", c)
                for c in EXPERT_CATEGORIES
            ),
            "expert_packed_read": (
                _get(now, "read", "expert_packed")
                - _get(before, "read", "expert_packed")
            ),
            "expert_remote_read": (
                _get(now, "read", "expert_remote")
                - _get(before, "read", "expert_remote")
            ),
            "expert_disk_read": (
                _get(now, "read", "expert_disk")
                - _get(before, "read", "expert_disk")
            ),
            "expert_repair_read": (
                _get(now, "read", "expert_repair")
                - _get(before, "read", "expert_repair")
            ),
            "out_written": _get(now, "written", "out") - _get(before, "written", "out"),
            # "meta" keeps its historical definition (meta + other + now
            # journal, so benchmark totals stay complete); "waste_read"
            # breaks out the 'other' read component — e.g. gap-coalescing
            # bytes — so data-path waste is not misread as catalog overhead
            "meta": (
                sum(_get(now, k, c) for k in ("read", "written")
                    for c in ("meta", "other", "journal"))
                - sum(_get(before, k, c) for k in ("read", "written")
                      for c in ("meta", "other", "journal"))
            ),
            "waste_read": _get(now, "read", "other") - _get(before, "read", "other"),
            # crash-resumability accounting: journal overhead (also inside
            # "meta"-adjacent totals via c_meta) and the logical bytes a
            # resumed run proved it could skip
            "journal_write": (
                _get(now, "written", "journal") - _get(before, "written", "journal")
            ),
            "journal_read": (
                _get(now, "read", "journal") - _get(before, "read", "journal")
            ),
            "resumed_skipped": (
                sum(v.get("bytes", 0) for v in now.get("skipped", {}).values())
                - sum(v.get("bytes", 0) for v in before.get("skipped", {}).values())
            ),
        }


#: Process-global stats used by default; benchmarks may create private ones.
GLOBAL_STATS = IOStats()


@contextlib.contextmanager
def measure(stats: IOStats = GLOBAL_STATS) -> Iterator[Dict[str, int]]:
    """``with measure() as d: ...`` — fills ``d`` with the I/O delta."""
    before = stats.snapshot()
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        out.update(stats.delta_since(before))
