"""Persistent catalog — the paper's Table 1 relations, backed by SQLite.

Records:
    TensorMeta  model_id, tensor_id; shape, dtype, nbytes          (for fallback)
    BlockMeta   model_id, tensor_id, block_size, block_idx;
                bytes, hash, sketch (l2/absmax/mean/sign_sig/l2_delta/cos_base)
    TouchMap    sid, tensor_id; touched block ranges
    Coverage    sid, tensor_id, block_idx; expert-set digest
    Plan        plan_id; base_id, expert_ids, op, budget_B,
                selected_blocks_digest, C_expert_hat, payload
    Manifest    sid; plan_id, base_id, expert_ids, op, budget_B,
                realized C_expert, output_root, created_at
    PackedLayout / PackedMember / PackedExtent / PackedBlock
                content-addressed packed physical layouts (store/packed):
                which source checkpoints a layout covers (lineage), the
                unique extents it stores, and the per-(model, tensor,
                block) physical read cost — the planner's post-dedup /
                post-elision / post-compression byte model.

The catalog is metadata-only: ANALYZE writes block statistics once per
checkpoint; planning then never touches parameter bytes (G2).  Catalog I/O
is tagged ``meta`` so C_meta stays visible in every experiment.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.store.iostats import GLOBAL_STATS, IOStats

_SCHEMA = """
CREATE TABLE IF NOT EXISTS tensor_meta (
    model_id  TEXT NOT NULL,
    tensor_id TEXT NOT NULL,
    shape     TEXT NOT NULL,
    dtype     TEXT NOT NULL,
    nbytes    INTEGER NOT NULL,
    PRIMARY KEY (model_id, tensor_id)
);
CREATE TABLE IF NOT EXISTS block_meta (
    model_id   TEXT NOT NULL,
    tensor_id  TEXT NOT NULL,
    block_size INTEGER NOT NULL,
    block_idx  INTEGER NOT NULL,
    bytes      INTEGER NOT NULL,
    hash       TEXT NOT NULL,
    l2         REAL NOT NULL,
    absmax     REAL NOT NULL,
    mean       REAL NOT NULL,
    sign_sig   INTEGER NOT NULL,
    l2_delta   REAL,
    cos_base   REAL,
    PRIMARY KEY (model_id, tensor_id, block_size, block_idx)
);
CREATE TABLE IF NOT EXISTS analysis (
    model_id   TEXT NOT NULL,
    block_size INTEGER NOT NULL,
    base_id    TEXT,
    created_at REAL NOT NULL,
    PRIMARY KEY (model_id, block_size)
);
CREATE TABLE IF NOT EXISTS touch_map (
    sid        TEXT NOT NULL,
    tensor_id  TEXT NOT NULL,
    ranges     TEXT NOT NULL,
    PRIMARY KEY (sid, tensor_id)
);
CREATE TABLE IF NOT EXISTS coverage (
    sid        TEXT NOT NULL,
    tensor_id  TEXT NOT NULL,
    block_idx  INTEGER NOT NULL,
    expert_set TEXT NOT NULL,
    PRIMARY KEY (sid, tensor_id, block_idx)
);
CREATE TABLE IF NOT EXISTS plan (
    plan_id    TEXT PRIMARY KEY,
    base_id    TEXT NOT NULL,
    expert_ids TEXT NOT NULL,
    op         TEXT NOT NULL,
    budget_b   INTEGER NOT NULL,
    selected_blocks_digest TEXT NOT NULL,
    c_expert_hat INTEGER NOT NULL,
    payload    TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS merge_spec (
    spec_id    TEXT PRIMARY KEY,
    name       TEXT,
    op         TEXT NOT NULL,
    payload    TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS dag_edge (
    sid        TEXT NOT NULL,
    input_sid  TEXT NOT NULL,
    role       TEXT NOT NULL,
    ord        INTEGER NOT NULL,
    PRIMARY KEY (sid, input_sid, role)
);
CREATE TABLE IF NOT EXISTS packed_layout (
    layout_id  TEXT PRIMARY KEY,
    base_id    TEXT NOT NULL,
    block_size INTEGER NOT NULL,
    root       TEXT NOT NULL,
    lossless   INTEGER NOT NULL,
    options    TEXT NOT NULL,
    stats      TEXT NOT NULL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS packed_member (
    layout_id  TEXT NOT NULL,
    model_id   TEXT NOT NULL,
    logical_nbytes  INTEGER NOT NULL,
    physical_nbytes INTEGER NOT NULL,
    PRIMARY KEY (layout_id, model_id)
);
CREATE TABLE IF NOT EXISTS packed_extent (
    layout_id  TEXT NOT NULL,
    hash       TEXT NOT NULL,
    offset     INTEGER NOT NULL,
    physical_nbytes INTEGER NOT NULL,
    logical_nbytes  INTEGER NOT NULL,
    encoding   TEXT NOT NULL,
    refs       INTEGER NOT NULL,
    PRIMARY KEY (layout_id, hash)
);
CREATE TABLE IF NOT EXISTS packed_block (
    layout_id  TEXT NOT NULL,
    model_id   TEXT NOT NULL,
    tensor_id  TEXT NOT NULL,
    block_idx  INTEGER NOT NULL,
    kind       TEXT NOT NULL,
    hash       TEXT,
    physical_nbytes INTEGER NOT NULL,
    logical_nbytes  INTEGER NOT NULL,
    PRIMARY KEY (layout_id, model_id, tensor_id, block_idx)
);
CREATE TABLE IF NOT EXISTS merge_job (
    job_id     TEXT PRIMARY KEY,
    spec_id    TEXT NOT NULL,
    sid        TEXT,
    tenant     TEXT NOT NULL,
    priority   INTEGER NOT NULL,
    deadline   REAL,
    state      TEXT NOT NULL,
    admission  TEXT,
    window_id  TEXT,
    error      TEXT,
    submitted_at REAL NOT NULL,
    finished_at  REAL,
    attempts   INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS manifest (
    sid        TEXT PRIMARY KEY,
    plan_id    TEXT NOT NULL,
    base_id    TEXT NOT NULL,
    expert_ids TEXT NOT NULL,
    op         TEXT NOT NULL,
    budget_b   INTEGER NOT NULL,
    c_expert_run INTEGER NOT NULL,
    output_root TEXT NOT NULL,
    created_at REAL NOT NULL
);
"""


class Catalog:
    """SQLite-backed catalog; one file per workspace."""

    def __init__(self, path: str, stats: Optional[IOStats] = None):
        self.path = path
        self.stats = stats or GLOBAL_STATS
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._local = threading.local()
        self._conn().executescript(_SCHEMA)
        self._migrate()
        self._conn().commit()

    def _migrate(self) -> None:
        """Guarded column additions for workspaces created by older
        builds (CREATE TABLE IF NOT EXISTS never alters existing tables)."""
        conn = self._conn()
        cols = {r[1] for r in conn.execute("PRAGMA table_info(merge_job)")}
        if "attempts" not in cols:
            conn.execute(
                "ALTER TABLE merge_job "
                "ADD COLUMN attempts INTEGER NOT NULL DEFAULT 0"
            )

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, "conn", None)
        if conn is None:
            conn = sqlite3.connect(self.path)
            conn.execute("PRAGMA journal_mode=WAL")
            conn.execute("PRAGMA synchronous=NORMAL")
            self._local.conn = conn
        return conn

    def _meta_io(self, payload_rows: int, row_bytes: int = 96) -> None:
        # approximate catalog I/O accounting (exact file deltas are reported
        # separately via catalog_nbytes())
        self.stats.record_write("meta", payload_rows * row_bytes)

    # ----------------------------------------------------------- TensorMeta
    def upsert_tensor_meta(
        self, model_id: str, rows: Iterable[Tuple[str, str, str, int]]
    ) -> None:
        """rows: (tensor_id, shape_json, dtype, nbytes)"""
        rows = list(rows)
        self._conn().executemany(
            "INSERT OR REPLACE INTO tensor_meta VALUES (?,?,?,?,?)",
            [(model_id, t, s, d, n) for t, s, d, n in rows],
        )
        self._conn().commit()
        self._meta_io(len(rows))

    def tensor_metas(self, model_id: str) -> List[sqlite3.Row]:
        cur = self._conn().execute(
            "SELECT tensor_id, shape, dtype, nbytes FROM tensor_meta "
            "WHERE model_id=? ORDER BY tensor_id",
            (model_id,),
        )
        return cur.fetchall()

    # ------------------------------------------------------------ BlockMeta
    def upsert_block_meta(self, rows: Sequence[Tuple]) -> None:
        """rows: (model_id, tensor_id, block_size, block_idx, bytes, hash,
        l2, absmax, mean, sign_sig, l2_delta, cos_base)"""
        self._conn().executemany(
            "INSERT OR REPLACE INTO block_meta VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            rows,
        )
        self._conn().commit()
        self._meta_io(len(rows))

    def block_metas(
        self, model_id: str, block_size: int, tensor_id: Optional[str] = None
    ) -> List[Tuple]:
        q = (
            "SELECT tensor_id, block_idx, bytes, hash, l2, absmax, mean, "
            "sign_sig, l2_delta, cos_base FROM block_meta "
            "WHERE model_id=? AND block_size=?"
        )
        args: List = [model_id, block_size]
        if tensor_id is not None:
            q += " AND tensor_id=?"
            args.append(tensor_id)
        q += " ORDER BY tensor_id, block_idx"
        return self._conn().execute(q, args).fetchall()

    def mark_analyzed(
        self, model_id: str, block_size: int, base_id: Optional[str]
    ) -> None:
        self._conn().execute(
            "INSERT OR REPLACE INTO analysis VALUES (?,?,?,?)",
            (model_id, block_size, base_id, time.time()),
        )
        self._conn().commit()
        self._meta_io(1)

    def has_analysis(self, model_id: str, block_size: int) -> bool:
        cur = self._conn().execute(
            "SELECT 1 FROM analysis WHERE model_id=? AND block_size=?",
            (model_id, block_size),
        )
        return cur.fetchone() is not None

    # -------------------------------------------------------------- TouchMap
    def record_touch_map(
        self, sid: str, touched: Dict[str, List[Tuple[int, int]]]
    ) -> None:
        rows = [(sid, t, json.dumps(ranges)) for t, ranges in touched.items()]
        self._conn().executemany(
            "INSERT OR REPLACE INTO touch_map VALUES (?,?,?)", rows
        )
        self._conn().commit()
        self._meta_io(len(rows))

    def touch_map(self, sid: str) -> Dict[str, List[Tuple[int, int]]]:
        cur = self._conn().execute(
            "SELECT tensor_id, ranges FROM touch_map WHERE sid=?", (sid,)
        )
        return {t: [tuple(r) for r in json.loads(rj)] for t, rj in cur.fetchall()}

    # -------------------------------------------------------------- Coverage
    def record_coverage(
        self, sid: str, rows: Sequence[Tuple[str, int, str]]
    ) -> None:
        """rows: (tensor_id, block_idx, expert_set_digest)"""
        self._conn().executemany(
            "INSERT OR REPLACE INTO coverage VALUES (?,?,?,?)",
            [(sid, t, b, e) for t, b, e in rows],
        )
        self._conn().commit()
        self._meta_io(len(rows), row_bytes=48)

    def coverage(self, sid: str, tensor_id: Optional[str] = None) -> List[Tuple]:
        q = "SELECT tensor_id, block_idx, expert_set FROM coverage WHERE sid=?"
        args: List = [sid]
        if tensor_id is not None:
            q += " AND tensor_id=?"
            args.append(tensor_id)
        return self._conn().execute(q, args).fetchall()

    # ------------------------------------------------------------------ Plan
    def record_plan(
        self,
        plan_id: str,
        base_id: str,
        expert_ids: Sequence[str],
        op: str,
        budget_b: int,
        selected_blocks_digest: str,
        c_expert_hat: int,
        payload: Dict,
    ) -> None:
        self._conn().execute(
            "INSERT OR REPLACE INTO plan VALUES (?,?,?,?,?,?,?,?,?)",
            (
                plan_id,
                base_id,
                json.dumps(list(expert_ids)),
                op,
                budget_b,
                selected_blocks_digest,
                c_expert_hat,
                json.dumps(payload),
                time.time(),
            ),
        )
        self._conn().commit()
        self._meta_io(1, row_bytes=len(json.dumps(payload)) + 128)

    def get_plan(self, plan_id: str) -> Optional[Dict]:
        cur = self._conn().execute(
            "SELECT plan_id, base_id, expert_ids, op, budget_b, "
            "selected_blocks_digest, c_expert_hat, payload, created_at "
            "FROM plan WHERE plan_id=?",
            (plan_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {
            "plan_id": row[0],
            "base_id": row[1],
            "expert_ids": json.loads(row[2]),
            "op": row[3],
            "budget_b": row[4],
            "selected_blocks_digest": row[5],
            "c_expert_hat": row[6],
            "payload": json.loads(row[7]),
            "created_at": row[8],
        }

    def find_reusable_plan(
        self,
        base_id: str,
        expert_ids: Sequence[str],
        op: str,
        budget_b: int,
        layout_id: Optional[str] = None,
    ) -> Optional[Dict]:
        """Plan reuse across iterative merges (§2.2): same inputs, same
        budget, same operator -> identical plan, skip PlanGen entirely.
        A plan is only reusable against the same physical layout — flat
        and packed costings of identical inputs differ (physical vs
        logical bytes), so candidates are filtered by ``layout_id``."""
        cur = self._conn().execute(
            "SELECT plan_id FROM plan WHERE base_id=? AND expert_ids=? AND "
            "op=? AND budget_b=? ORDER BY created_at DESC LIMIT 16",
            (base_id, json.dumps(list(expert_ids)), op, budget_b),
        )
        for (plan_id,) in cur.fetchall():
            plan = self.get_plan(plan_id)
            if plan and plan["payload"].get("layout_id") == layout_id:
                return plan
        return None

    # ------------------------------------------------------------- MergeSpec
    def record_spec(
        self, spec_id: str, name: Optional[str], op: str, payload: Dict
    ) -> None:
        """Persist a declarative MergeSpec (API v2) for audit / replay."""
        self._conn().execute(
            "INSERT OR REPLACE INTO merge_spec VALUES (?,?,?,?,?)",
            (spec_id, name, op, json.dumps(payload), time.time()),
        )
        self._conn().commit()
        self._meta_io(1, row_bytes=len(json.dumps(payload)) + 64)

    def get_spec(self, spec_id: str) -> Optional[Dict]:
        cur = self._conn().execute(
            "SELECT spec_id, name, op, payload, created_at "
            "FROM merge_spec WHERE spec_id=?",
            (spec_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {
            "spec_id": row[0],
            "name": row[1],
            "op": row[2],
            "payload": json.loads(row[3]),
            "created_at": row[4],
        }

    # --------------------------------------------------------------- DagEdge
    def record_dag_edges(
        self, sid: str, edges: Sequence[Tuple[str, str]]
    ) -> None:
        """edges: (input_sid, role) — merge-graph parents of snapshot sid."""
        rows = [(sid, i, r, k) for k, (i, r) in enumerate(edges)]
        self._conn().executemany(
            "INSERT OR REPLACE INTO dag_edge VALUES (?,?,?,?)", rows
        )
        self._conn().commit()
        self._meta_io(len(rows), row_bytes=64)

    def dag_parents(self, sid: str) -> List[Tuple[str, str]]:
        """Inputs of sid that are themselves merge snapshots: (input_sid, role)."""
        cur = self._conn().execute(
            "SELECT input_sid, role FROM dag_edge WHERE sid=? ORDER BY ord",
            (sid,),
        )
        return [(r[0], r[1]) for r in cur.fetchall()]

    def dag_children(self, input_sid: str) -> List[str]:
        """Snapshots that consumed input_sid as a merge-graph input."""
        cur = self._conn().execute(
            "SELECT DISTINCT sid FROM dag_edge WHERE input_sid=?", (input_sid,)
        )
        return [r[0] for r in cur.fetchall()]

    # ---------------------------------------------------------- PackedLayout
    def record_packed_layout(
        self,
        layout_id: str,
        base_id: str,
        block_size: int,
        root: str,
        lossless: bool,
        options: Dict,
        stats: Dict,
        members: Sequence[Tuple[str, int, int]],
        extents: Sequence[Tuple[str, int, int, int, str, int]],
        blocks: Sequence[Tuple[str, str, int, str, Optional[str], int, int]],
    ) -> None:
        """Persist one repacked layout atomically.

        members: (model_id, logical_nbytes, physical_nbytes)
        extents: (hash, offset, physical_nbytes, logical_nbytes, encoding, refs)
        blocks:  (model_id, tensor_id, block_idx, kind, hash,
                  physical_nbytes, logical_nbytes)
        """
        conn = self._conn()
        with conn:  # one transaction: a layout is visible all-or-nothing
            conn.execute(
                "INSERT OR REPLACE INTO packed_layout VALUES (?,?,?,?,?,?,?,?)",
                (
                    layout_id, base_id, block_size, root, int(lossless),
                    json.dumps(options), json.dumps(stats), time.time(),
                ),
            )
            for table in ("packed_member", "packed_extent", "packed_block"):
                conn.execute(
                    f"DELETE FROM {table} WHERE layout_id=?", (layout_id,)
                )
            conn.executemany(
                "INSERT INTO packed_member VALUES (?,?,?,?)",
                [(layout_id, m, ln, pn) for m, ln, pn in members],
            )
            conn.executemany(
                "INSERT INTO packed_extent VALUES (?,?,?,?,?,?,?)",
                [(layout_id, *e) for e in extents],
            )
            conn.executemany(
                "INSERT INTO packed_block VALUES (?,?,?,?,?,?,?,?)",
                [(layout_id, *b) for b in blocks],
            )
        self._meta_io(1 + len(members) + len(extents) + len(blocks), row_bytes=64)

    def get_packed_layout(self, layout_id: str) -> Optional[Dict]:
        cur = self._conn().execute(
            "SELECT layout_id, base_id, block_size, root, lossless, options, "
            "stats, created_at FROM packed_layout WHERE layout_id=?",
            (layout_id,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        members = self._conn().execute(
            "SELECT model_id, logical_nbytes, physical_nbytes "
            "FROM packed_member WHERE layout_id=? ORDER BY model_id",
            (layout_id,),
        ).fetchall()
        return {
            "layout_id": row[0],
            "base_id": row[1],
            "block_size": row[2],
            "root": row[3],
            "lossless": bool(row[4]),
            "options": json.loads(row[5]),
            "stats": json.loads(row[6]),
            "created_at": row[7],
            "members": [
                {"model_id": m, "logical_nbytes": ln, "physical_nbytes": pn}
                for m, ln, pn in members
            ],
        }

    def list_packed_layouts(self) -> List[str]:
        cur = self._conn().execute(
            "SELECT layout_id FROM packed_layout ORDER BY created_at"
        )
        return [r[0] for r in cur.fetchall()]

    def find_packed_layout(
        self,
        model_ids: Sequence[str],
        block_size: int,
        lossless_only: bool = True,
        base_id: Optional[str] = None,
    ) -> Optional[str]:
        """Most recent layout at this block granularity whose member set
        covers *all* of ``model_ids`` (the Session auto-prefer query).

        ``base_id`` restricts to layouts packed against that base —
        elision is only sound relative to the layout's own base (an
        elided block means "delta vs *this* base is zero"), so a merge
        against any other base must never adopt the layout.
        """
        model_ids = list(model_ids)
        if not model_ids:
            return None
        params: List = [block_size]
        q = "SELECT l.layout_id FROM packed_layout l WHERE l.block_size=? "
        if lossless_only:
            q += "AND l.lossless=1 "
        if base_id is not None:
            q += "AND l.base_id=? "
            params.append(base_id)
        q += (
            "AND (SELECT COUNT(*) FROM packed_member m WHERE "
            "m.layout_id=l.layout_id AND m.model_id IN (%s)) = ? "
            "ORDER BY l.created_at DESC LIMIT 1"
            % ",".join("?" * len(model_ids))
        )
        row = self._conn().execute(
            q, [*params, *model_ids, len(model_ids)]
        ).fetchone()
        return row[0] if row else None

    def packed_block_costs(
        self, layout_id: str, model_id: str
    ) -> Dict[Tuple[str, int], Tuple[int, Optional[str], str]]:
        """Physical read-cost model of one member:
        ``{(tensor_id, block_idx): (physical_nbytes, extent_hash, kind)}``.
        Elided blocks cost 0; deduped blocks share an extent hash, so a
        marginal-cost planner charges the extent once per merge."""
        cur = self._conn().execute(
            "SELECT tensor_id, block_idx, physical_nbytes, hash, kind "
            "FROM packed_block WHERE layout_id=? AND model_id=?",
            (layout_id, model_id),
        )
        return {(t, b): (pn, h, k) for t, b, pn, h, k in cur.fetchall()}

    def packed_layout_members(self, layout_id: str) -> List[str]:
        cur = self._conn().execute(
            "SELECT model_id FROM packed_member WHERE layout_id=? "
            "ORDER BY model_id",
            (layout_id,),
        )
        return [r[0] for r in cur.fetchall()]

    # ------------------------------------------------------------ references
    def model_references(self, model_id: str) -> List[str]:
        """Live references that make deleting ``model_id`` unsafe:
        committed snapshots that list it as base/expert input, merge-graph
        edges consuming it, and packed layouts that read or attribute
        blocks from it (the base of a layout serves elided blocks)."""
        refs: List[str] = []
        conn = self._conn()
        for sid, base_id, expert_ids in conn.execute(
            "SELECT sid, base_id, expert_ids FROM manifest"
        ).fetchall():
            if base_id == model_id:
                refs.append(f"manifest:{sid}(base)")
            elif model_id in json.loads(expert_ids):
                refs.append(f"manifest:{sid}(expert)")
        for (sid,) in conn.execute(
            "SELECT DISTINCT sid FROM dag_edge WHERE input_sid=?", (model_id,)
        ).fetchall():
            refs.append(f"dag_edge:{sid}")
        for (lid,) in conn.execute(
            "SELECT layout_id FROM packed_member WHERE model_id=?", (model_id,)
        ).fetchall():
            refs.append(f"packed_layout:{lid}(member)")
        for (lid,) in conn.execute(
            "SELECT layout_id FROM packed_layout WHERE base_id=?", (model_id,)
        ).fetchall():
            refs.append(f"packed_layout:{lid}(base)")
        return refs

    # --------------------------------------------------------------- MergeJob
    _JOB_COLS = (
        "job_id", "spec_id", "sid", "tenant", "priority", "deadline",
        "state", "admission", "window_id", "error", "submitted_at",
        "finished_at", "attempts",
    )

    def record_job(
        self,
        job_id: str,
        spec_id: str,
        tenant: str,
        priority: int,
        state: str,
        sid: Optional[str] = None,
        deadline: Optional[float] = None,
        attempts: int = 0,
    ) -> None:
        """Insert one MergeService job row (audit: who asked for what,
        when, under which tenancy; updated as the job advances).
        ``attempts`` carries the execution count across restarts so a
        re-adopted job keeps its poison-quarantine history."""
        self._conn().execute(
            "INSERT OR REPLACE INTO merge_job "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (
                job_id, spec_id, sid, tenant, int(priority), deadline,
                state, None, None, None, time.time(), None, int(attempts),
            ),
        )
        self._conn().commit()
        self._meta_io(1, row_bytes=128)

    def update_job(self, job_id: str, **fields) -> None:
        """Update job columns (state, sid, admission, window_id, error,
        finished_at).  ``admission`` dicts are JSON-encoded."""
        self.update_jobs([(job_id, fields)])

    def update_jobs(self, updates) -> None:
        """Apply many job-row updates under ONE commit — the scheduler
        batches a window's state transitions so the compatibility
        ``run_all`` path is not taxed per job.  ``updates`` is a sequence
        of ``(job_id, fields)`` pairs."""
        allowed = {"state", "sid", "admission", "window_id", "error",
                   "finished_at", "attempts"}
        conn = self._conn()
        n = 0
        for job_id, fields in updates:
            unknown = set(fields) - allowed
            if unknown:
                raise KeyError(f"unknown merge_job columns {sorted(unknown)}")
            if not fields:
                continue
            fields = dict(fields)
            if isinstance(fields.get("admission"), dict):
                fields["admission"] = json.dumps(fields["admission"])
            cols = sorted(fields)
            conn.execute(
                f"UPDATE merge_job SET {', '.join(c + '=?' for c in cols)} "
                f"WHERE job_id=?",
                [fields[c] for c in cols] + [job_id],
            )
            n += 1
        if n:
            conn.commit()
            self._meta_io(n, row_bytes=64)

    def _job_row(self, row) -> Dict:
        doc = dict(zip(self._JOB_COLS, row))
        if doc.get("admission"):
            doc["admission"] = json.loads(doc["admission"])
        return doc

    def get_job(self, job_id: str) -> Optional[Dict]:
        cur = self._conn().execute(
            f"SELECT {', '.join(self._JOB_COLS)} FROM merge_job "
            f"WHERE job_id=?",
            (job_id,),
        )
        row = cur.fetchone()
        return self._job_row(row) if row else None

    def list_jobs(
        self, state: Optional[str] = None, tenant: Optional[str] = None
    ) -> List[Dict]:
        q = f"SELECT {', '.join(self._JOB_COLS)} FROM merge_job"
        clauses, args = [], []
        if state is not None:
            clauses.append("state=?")
            args.append(state)
        if tenant is not None:
            clauses.append("tenant=?")
            args.append(tenant)
        if clauses:
            q += " WHERE " + " AND ".join(clauses)
        q += " ORDER BY submitted_at"
        return [self._job_row(r) for r in self._conn().execute(q, args)]

    def job_for_sid(self, sid: str) -> Optional[Dict]:
        """Most recent job that committed snapshot ``sid`` (explain())."""
        cur = self._conn().execute(
            f"SELECT {', '.join(self._JOB_COLS)} FROM merge_job "
            f"WHERE sid=? ORDER BY submitted_at DESC LIMIT 1",
            (sid,),
        )
        row = cur.fetchone()
        return self._job_row(row) if row else None

    # --------------------------------------------------------------- Manifest
    def record_manifest(
        self,
        sid: str,
        plan_id: str,
        base_id: str,
        expert_ids: Sequence[str],
        op: str,
        budget_b: int,
        c_expert_run: int,
        output_root: str,
    ) -> None:
        self._conn().execute(
            "INSERT INTO manifest VALUES (?,?,?,?,?,?,?,?,?)",
            (
                sid,
                plan_id,
                base_id,
                json.dumps(list(expert_ids)),
                op,
                budget_b,
                c_expert_run,
                output_root,
                time.time(),
            ),
        )
        self._conn().commit()
        self._meta_io(1, row_bytes=192)

    def get_manifest(self, sid: str) -> Optional[Dict]:
        cur = self._conn().execute(
            "SELECT sid, plan_id, base_id, expert_ids, op, budget_b, "
            "c_expert_run, output_root, created_at FROM manifest WHERE sid=?",
            (sid,),
        )
        row = cur.fetchone()
        if row is None:
            return None
        return {
            "sid": row[0],
            "plan_id": row[1],
            "base_id": row[2],
            "expert_ids": json.loads(row[3]),
            "op": row[4],
            "budget_b": row[5],
            "c_expert_run": row[6],
            "output_root": row[7],
            "created_at": row[8],
        }

    def list_manifests(self) -> List[str]:
        cur = self._conn().execute("SELECT sid FROM manifest ORDER BY created_at")
        return [r[0] for r in cur.fetchall()]

    # ------------------------------------------------------------------ misc
    def catalog_nbytes(self) -> int:
        self._conn().commit()
        total = 0
        for suffix in ("", "-wal", "-shm"):
            p = self.path + suffix
            if os.path.exists(p):
                total += os.path.getsize(p)
        return total

    def close(self) -> None:
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            conn.close()
            self._local.conn = None
