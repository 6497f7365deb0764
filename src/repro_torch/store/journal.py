"""Durable block-level progress journal — crash-resumable merges.

The transactional story used to be discard-only: a crash at block N of a
large merge threw away every expert byte already read and re-paid the
full O(K·model) cost on retry.  The journal makes a crash cost
O(remaining work) instead: as the staging writer streams output blocks,
it appends one fsync'd record per block (content hash + the experts that
contributed), so recovery can prove exactly how far the dead run got and
hand the executor a residual read set.

One journal file per snapshot id, JSONL, append-only, living *outside*
the staging directory (``<workspace>/journals/<sid>.journal``) so the
publish rename and the staging GC never race with it:

    {"k":"begin","sid":…,"plan_id":…,"plan_digest":…,"dir":…,
     "block_size":…,"attempt":1}
    {"k":"tensor","t":"layer0/w","file":"tensors/00000.bin",
     "shape":[64,96],"dtype":"float32"}
    {"k":"block","t":"layer0/w","i":0,"n":4096,"h":"<blake2b-8>",
     "e":"ex0,ex2"}              # "e" present iff experts contributed
    {"k":"finish","t":"layer0/w","n":24576,"h":"<blake2b-16>"}

Records are buffered and fsync'd every ``sync_every`` blocks (and at
every tensor boundary), so journal overhead is a bounded, accounted
(``IOStats`` category ``journal``) fraction of C_out.  Durability is NOT
assumed for the tail: recovery trusts a journaled block only after
re-hashing the staged bytes, so torn journal lines and torn data writes
both simply shorten the resumable prefix.

A resumed attempt appends to the same journal (a fresh ``begin`` record
bumps ``attempt``); later records supersede earlier ones, so a journal
that has survived multiple crashes still parses to a single coherent
high-water mark per tensor.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Dict, List, Optional, Tuple

from repro_torch.store.iostats import GLOBAL_STATS, IOStats
from repro_torch.testing.chaos import chaos_point

JOURNAL_SUFFIX = ".journal"
#: fsync cadence for block records; tensor/finish records always sync
DEFAULT_SYNC_EVERY = 32


def journal_path(journal_root: str, sid: str) -> str:
    safe = sid.replace(os.sep, "_")
    return os.path.join(journal_root, f"{safe}{JOURNAL_SUFFIX}")


class ProgressJournal:
    """Append-only writer side of the journal (one merge attempt)."""

    def __init__(
        self,
        path: str,
        stats: Optional[IOStats] = None,
        sync_every: int = DEFAULT_SYNC_EVERY,
    ):
        self.path = path
        self.stats = stats or GLOBAL_STATS
        self.sync_every = max(1, int(sync_every))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "ab")
        self._since_sync = 0
        self._closed = False

    def _append(self, rec: Dict, sync: bool = False) -> None:
        chaos_point("journal:append")
        raw = json.dumps(rec, separators=(",", ":")).encode() + b"\n"
        self._f.write(raw)
        self._since_sync += 1
        if sync or self._since_sync >= self.sync_every:
            self._f.flush()
            os.fsync(self._f.fileno())
            self._since_sync = 0
        self.stats.record_write("journal", len(raw))

    # -- record kinds ------------------------------------------------------
    def begin(
        self,
        sid: str,
        plan_id: str,
        plan_digest: str,
        staging_dir: str,
        block_size: int,
        attempt: int = 1,
    ) -> None:
        self._append(
            {
                "k": "begin",
                "sid": sid,
                "plan_id": plan_id,
                "plan_digest": plan_digest,
                "dir": staging_dir,
                "block_size": int(block_size),
                "attempt": int(attempt),
            },
            sync=True,
        )

    def tensor(self, tensor_id: str, file: str, shape, dtype_name: str) -> None:
        self._append(
            {
                "k": "tensor",
                "t": tensor_id,
                "file": file,
                "shape": list(shape),
                "dtype": dtype_name,
            },
            sync=True,
        )

    def block(
        self,
        tensor_id: str,
        block_idx: int,
        nbytes: int,
        block_hash: str,
        experts: Optional[str] = None,
    ) -> None:
        rec = {"k": "block", "t": tensor_id, "i": int(block_idx),
               "n": int(nbytes), "h": block_hash}
        if experts:
            rec["e"] = experts
        self._append(rec)

    def finish(self, tensor_id: str, nbytes: int, tensor_hash: str) -> None:
        self._append(
            {"k": "finish", "t": tensor_id, "n": int(nbytes), "h": tensor_hash},
            sync=True,
        )

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._f.flush()
            os.fsync(self._f.fileno())
        except (OSError, ValueError):
            pass
        self._f.close()

    def remove(self) -> None:
        """Close and delete — the merge published (or aborted), so the
        journal has nothing left to say."""
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


# ======================================================================
# Reader side: parse + validate into a ResumeState
# ======================================================================

@dataclasses.dataclass
class ParsedJournal:
    """Raw journal contents, torn-tail tolerant, latest-record-wins."""

    path: str
    sid: str
    plan_id: str
    plan_digest: str
    staging_dir: str
    block_size: int
    attempt: int
    #: tensor_id -> (file, shape, dtype) in first-seen order
    tensors: Dict[str, Tuple[str, List[int], str]]
    #: tensor_id -> {block_idx: (nbytes, hash, experts-or-"")}
    blocks: Dict[str, Dict[int, Tuple[int, str, str]]]
    #: tensor_id -> (nbytes, hash) for tensors whose finish record landed
    finished: Dict[str, Tuple[int, str]]


def parse_journal(path: str, stats: Optional[IOStats] = None) -> Optional[ParsedJournal]:
    """Parse a journal file; ``None`` if it has no usable begin record.
    A torn tail (partial last line) truncates parsing, never fails it."""
    stats = stats or GLOBAL_STATS
    try:
        with open(path, "rb") as f:
            raw = f.read()
    except OSError:
        return None
    stats.record_read("journal", len(raw))
    header: Optional[Dict] = None
    tensors: Dict[str, Tuple[str, List[int], str]] = {}
    blocks: Dict[str, Dict[int, Tuple[int, str, str]]] = {}
    finished: Dict[str, Tuple[int, str]] = {}
    for line in raw.split(b"\n"):
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            break  # torn tail: everything before it is still good
        kind = rec.get("k")
        if kind == "begin":
            if header is None:
                header = rec
            else:
                header["attempt"] = rec.get("attempt", header.get("attempt", 1))
        elif kind == "tensor":
            tensors.setdefault(rec["t"], (rec["file"], rec["shape"], rec["dtype"]))
            finished.pop(rec["t"], None)  # re-begun on a later attempt
        elif kind == "block":
            blocks.setdefault(rec["t"], {})[int(rec["i"])] = (
                int(rec["n"]), rec["h"], rec.get("e", "")
            )
        elif kind == "finish":
            finished[rec["t"]] = (int(rec["n"]), rec["h"])
    if header is None:
        return None
    return ParsedJournal(
        path=path,
        sid=header["sid"],
        plan_id=header["plan_id"],
        plan_digest=header["plan_digest"],
        staging_dir=header["dir"],
        block_size=int(header["block_size"]),
        attempt=int(header.get("attempt", 1)),
        tensors=tensors,
        blocks=blocks,
        finished=finished,
    )


@dataclasses.dataclass
class TensorResume:
    """Validated progress for one staged tensor: a contiguous prefix of
    blocks whose journaled hashes match the bytes actually on disk."""

    file: str
    n_validated: int
    validated_nbytes: int
    #: streaming blake2b-16 over the validated prefix — the resumed
    #: writer seeds its tensor hash from a copy of this object
    hash_obj: object
    block_hashes: List[str]
    block_nbytes: List[int]
    #: (block_idx, experts) pairs for validated blocks with contributions
    coverage: List[Tuple[int, str]]


class ResumeState:
    """The residual read set handed to the executor: per-tensor validated
    high-water marks plus everything needed to re-seed the staging writer
    (file names, streaming hash state, coverage already earned)."""

    def __init__(self, parsed: ParsedJournal):
        self.sid = parsed.sid
        self.plan_id = parsed.plan_id
        self.plan_digest = parsed.plan_digest
        self.staging_dir = parsed.staging_dir
        self.block_size = parsed.block_size
        self.journal_file = parsed.path
        self.attempt = parsed.attempt
        self.tensors: Dict[str, TensorResume] = {}
        #: distinct tensor files the dead run created — the resumed
        #: writer continues file numbering after them
        self.n_tensor_files = len(parsed.tensors)

    # -- executor-facing queries ------------------------------------------
    @property
    def completed(self) -> Dict[str, int]:
        """tensor_id -> count of contiguous validated blocks (skip set)."""
        return {t: tr.n_validated for t, tr in self.tensors.items()}

    def coverage(self, tensor_id: str) -> List[Tuple[int, str]]:
        tr = self.tensors.get(tensor_id)
        return list(tr.coverage) if tr is not None else []

    def validated_out_bytes(self) -> int:
        return sum(tr.validated_nbytes for tr in self.tensors.values())

    def skipped_expert_bytes(self, rev: Dict[int, List[str]], tensor_id: str) -> int:
        """Logical expert bytes the resumed run does NOT re-read for this
        tensor: plan-selected contributions to blocks below the validated
        high-water mark, sized from the journaled per-block byte counts."""
        tr = self.tensors.get(tensor_id)
        if tr is None:
            return 0
        total = 0
        for b, experts in rev.items():
            if b < tr.n_validated:
                total += len(experts) * tr.block_nbytes[b]
        return total

    def journaled_expert_bytes(self, plan) -> int:
        """Logical expert bytes the dead attempt(s) already paid for —
        the service refunds these against the budget pool so crash +
        resume charges each expert byte once."""
        total = 0
        for t in self.tensors:
            total += self.skipped_expert_bytes(plan.reverse_index(t), t)
        return total

    def discard(self) -> None:
        """Drop everything: the journal no longer matches reality (plan
        changed, or the caller chose a fresh start)."""
        shutil.rmtree(self.staging_dir, ignore_errors=True)
        try:
            os.unlink(self.journal_file)
        except FileNotFoundError:
            pass


def build_resume_state(
    parsed: ParsedJournal, stats: Optional[IOStats] = None
) -> Optional[ResumeState]:
    """Validate journaled progress against the staged bytes on disk.

    For each journaled tensor, re-hash the staged file block by block and
    keep the longest contiguous prefix whose content hashes match the
    journal — a torn data write, a torn journal line, or a mid-block
    crash all just shorten the prefix.  Returns ``None`` when the staging
    directory is gone (nothing to resume).
    """
    stats = stats or GLOBAL_STATS
    if not os.path.isdir(parsed.staging_dir):
        return None
    state = ResumeState(parsed)
    for tensor_id, (fname, _shape, _dtype) in parsed.tensors.items():
        recs = parsed.blocks.get(tensor_id, {})
        hash_obj = hashlib.blake2b(digest_size=16)
        block_hashes: List[str] = []
        block_nbytes: List[int] = []
        coverage: List[Tuple[int, str]] = []
        validated = 0
        validated_nbytes = 0
        path = os.path.join(parsed.staging_dir, fname)
        try:
            f = open(path, "rb")
        except OSError:
            f = None
        if f is not None:
            with f:
                while True:
                    rec = recs.get(validated)
                    if rec is None:
                        break
                    nbytes, h, experts = rec
                    data = f.read(nbytes)
                    stats.record_read("journal", len(data))
                    if len(data) != nbytes:
                        break  # torn data tail
                    if hashlib.blake2b(data, digest_size=8).hexdigest() != h:
                        break  # corrupt/stale block: stop trusting here
                    hash_obj.update(data)
                    block_hashes.append(h)
                    block_nbytes.append(nbytes)
                    if experts:
                        coverage.append((validated, experts))
                    validated += 1
                    validated_nbytes += nbytes
        state.tensors[tensor_id] = TensorResume(
            file=fname,
            n_validated=validated,
            validated_nbytes=validated_nbytes,
            hash_obj=hash_obj,
            block_hashes=block_hashes,
            block_nbytes=block_nbytes,
            coverage=coverage,
        )
    return state
