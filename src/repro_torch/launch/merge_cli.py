"""Merge launcher — the port's MergePipe from the command line.

One-shot flags (legacy surface, still supported)::

    PYTHONPATH=src python -m repro_torch.launch.merge_cli \
        --workspace /tmp/ws --base base --experts e0 e1 e2 \
        --op ties --budget 30% --theta trim_frac=0.2 lam=1.0

Declarative spec files (API v2): ``--spec merges.json`` submits one or
many :class:`repro_torch.api.MergeSpec` documents — including nested
merge graphs — and executes them as a batch with cross-job shared expert
reads::

    PYTHONPATH=src python -m repro_torch.launch.merge_cli \
        --workspace /tmp/ws --spec merges.json [--shared-budget 1GiB]

Spec documents are JSON: a mapping, a list of mappings, or
``{"jobs": [...]}``; each mapping has ``base``, ``experts`` (model ids or
nested specs), ``op``, ``theta``, ``budget`` ("30%", "2GiB", bytes), and
optional ``name`` (used as the snapshot id).  YAML spec files are
refused (no PyYAML dependency).

Packed physical layouts (store/packed; docs/STORAGE.md) get three
subcommands::

    merge_cli repack  --workspace WS --base base --models e0 e1 ...
                      [--layout-id ID] [--elide-threshold X]
                      [--compress zlib] [--downcast float16]
    merge_cli layouts --workspace WS            # list layouts + savings
    merge_cli delete  --workspace WS MODEL [--force]

Merges auto-prefer a covering lossless layout; ``--no-packed`` forces
flat reads and ``--layout ID`` forces a specific (possibly lossy) one.

ANALYZE and the merges run on ``--device``: ``cuda`` (the default) uses
the Hopper sketch and merge kernels and fails where there is no card;
``cpu`` runs their plain versions.  ``--pipeline-kernel numpy`` keeps
the pipelined engine's compute on the host (bit-identical to stream).

The asynchronous MergeService (docs/SERVICE.md) gets four subcommands
built on a file spool under ``<workspace>/service/``::

    merge_cli serve   --workspace WS [--budget 2GiB] [--device cpu]
                      [--tenant-weights prod=3,batch=1] [--once]
    merge_cli submit  --workspace WS --spec merges.json
                      [--tenant T] [--priority N] [--deadline SECS]
    merge_cli status  --workspace WS [JOB_ID]
    merge_cli cancel  --workspace WS JOB_ID

``submit`` drops job files into the spool and returns immediately;
``serve`` runs a MergeService that drains the spool continuously
(admission control, weighted-fair budget arbitration, overlap-aware
scheduling windows), honors ``cancel`` markers, and records every job
in the catalog job table that ``status`` reads — from any process.

Remote-backed models (store/remote + store/tiered; docs/STORAGE.md) get
two subcommands::

    merge_cli remote push     --workspace WS MODEL --remote-root DIR
                              [--latency-s X] [--mbps X] [--fail-every N]
                              [--keep-local] [--no-disk-cache]
    merge_cli remote register --workspace WS MODEL --remote-root DIR [...]
    merge_cli cache stats     --workspace WS
    merge_cli cache evict     --workspace WS [--target-bytes N]

``remote push`` uploads a local model and replaces its bytes with a
stub so later reads flow RAM -> local-disk extent cache -> remote;
``cache`` inspects or LRU-shrinks the shared warm tier.

Shard-parallel distributed execution (repro_torch.dist; docs/DISTRIBUTED.md)
gets two subcommands::

    merge_cli shards --workspace WS --base base --experts e0 e1 ...
                     [--op ties] [--budget 30%] [--n-workers 4]
                     [--kernel mesh] [--json] [--device cpu]
    merge_cli worker --workspace WS --lease L.json --result R.json
                     [--device cpu]

``shards`` plans a merge and prints its byte-balanced shard partition
(the exact spans/budgets a sharded run would lease out) without
executing anything; ``worker`` executes one :class:`ShardLease` — the
same entrypoint ``LocalProcessTransport`` launches, exposed for manual
runs and debugging (exit 3 = simulated crash, region + journal kept),
on the lease's device unless ``--device`` names another.

Crash recovery (docs/RECOVERY.md) and model deletion::

    merge_cli resume --workspace WS              # list resumable journals
    merge_cli resume --workspace WS SID          # resume + commit SID
    merge_cli resume --workspace WS SID --discard
    merge_cli delete --workspace WS MODEL [--force]

A merge killed mid-execution (power loss, OOM-kill) leaves a
block-level progress journal; ``resume`` validates the staged prefix
and re-reads only the residual blocks.  The ``--chaos-crash POINT`` /
``--chaos-skip N`` flags inject a simulated worker death into a one-shot
merge — the embedded service requeues and resumes it in-process, so the
run reports the recovery instead of dying.

Integrity scrubbing (docs/STORAGE.md, mergefsck)::

    merge_cli fsck --workspace WS                # detect + repair
    merge_cli fsck --workspace WS --check        # detect only; exit 1
                                                 # on any damage found
    merge_cli fsck --workspace WS --rate-mbps 50 [--json]

``fsck`` re-hashes every store against the catalog/manifest integrity
contract — flat checkpoints and snapshots vs their MODEL.json hashes,
packed extents vs their content-hash keys (corrupt ones are
quarantined so reads fall back to the flat source), disk-cache extents
vs their filename digests (corrupt ones are dropped and refill from
remote), plus orphaned-journal and remote-stub reachability checks.
Exit status is non-zero while unrepaired damage remains.

Also supports ANALYZE reuse, plan inspection (``--explain SID``) and the
naive full-read baseline (``--naive``).

Every subcommand that opens a session takes ``--device``.  A one-shot
or ``--spec`` run in which a job fails exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import uuid

from repro_torch.api import BudgetSpec, MergeService, Session, load_spec_file
from repro_torch.api.jobs import JobState
from repro_torch.core import MergePipe, naive_merge
from repro_torch.core.executor import PipelineConfig
from repro_torch.store.iostats import measure

SUBCOMMANDS = ("repack", "layouts", "delete", "serve", "submit", "status",
               "cancel", "remote", "cache", "resume", "fsck", "shards",
               "worker")
def _add_device(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where ANALYZE and the merge kernels run: 'cuda' "
                         "(default; fails without a card) or 'cpu' (plain "
                         "versions)")


# --------------------------------------------------------------- job spool
def _spool(workspace: str, sub: str) -> str:
    d = os.path.join(workspace, "service", sub)
    os.makedirs(d, exist_ok=True)
    return d


def _cmd_submit(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli submit")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--spec", required=True,
                    help="JSON MergeSpec document (one job per spec)")
    ap.add_argument("--tenant", default="default")
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="relative seconds; the job fails if no window "
                         "ran it in time")
    args = ap.parse_args(argv)
    inbox = _spool(args.workspace, "inbox")
    for spec in load_spec_file(args.spec):
        job_id = "job-" + uuid.uuid4().hex[:12]
        doc = {
            "job_id": job_id,
            "spec": spec.to_dict(),
            # unnamed specs target a job-id-derived sid: a serve-loop
            # crash replay then always adopts the committed snapshot
            # instead of re-executing under a fresh random sid
            "sid": spec.name or f"snap-{job_id}",
            "tenant": args.tenant,
            "priority": args.priority,
            "deadline": args.deadline,
            "submitted_at": time.time(),
        }
        tmp = os.path.join(inbox, f".{job_id}.tmp")
        # fsync before the rename: the serve daemon trusts any *.json in
        # the inbox, and a torn spec surviving a crash would wedge it
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        # chaos-ok: client-side submit, outside the merge pipeline the
        # chaos harness exercises — a crash here just loses the submit
        os.rename(tmp, os.path.join(inbox, f"{job_id}.json"))
        print(f"[submit] {job_id}  spec={spec.spec_id}  "
              f"tenant={args.tenant}  priority={args.priority}")


def _cmd_cancel(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli cancel")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("job_id")
    args = ap.parse_args(argv)
    marker = os.path.join(_spool(args.workspace, "cancel"), args.job_id)
    with open(marker, "w", encoding="utf-8"):
        pass
    # a job still in the inbox never reaches the service: retract it here
    # (the marker above covers the race where serve claims it first)
    inbox_file = os.path.join(
        _spool(args.workspace, "inbox"), f"{args.job_id}.json"
    )
    try:
        os.remove(inbox_file)
        print(f"[cancel] {args.job_id} retracted from the inbox")
    except FileNotFoundError:
        print(f"[cancel] marker written for {args.job_id}")


def _cmd_status(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli status")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("job_id", nargs="?", default=None)
    args = ap.parse_args(argv)
    from repro_torch.core.catalog import Catalog

    catalog = Catalog(os.path.join(args.workspace, "catalog.sqlite"))
    try:
        if args.job_id:
            job = catalog.get_job(args.job_id)
            if job is None:
                raise SystemExit(f"no such job {args.job_id!r}")
            print(json.dumps(job, indent=2, default=str))
            return
        jobs = catalog.list_jobs()
        inbox = _spool(args.workspace, "inbox")
        # a claimed job keeps its spool file until terminal; only files
        # with no catalog row are genuinely waiting for a serve loop
        known = {j["job_id"] for j in jobs}
        waiting = sorted(
            f[:-5] for f in os.listdir(inbox)
            if f.endswith(".json") and f[:-5] not in known
        )
        if not jobs and not waiting:
            print("no jobs")
        for j in jobs:
            wall = (
                f"{j['finished_at'] - j['submitted_at']:.2f}s"
                if j["finished_at"] else "-"
            )
            print(f"{j['job_id']}  {j['state']:<9}  tenant={j['tenant']:<8} "
                  f"prio={j['priority']:<3} window={j['window_id'] or '-':<11} "
                  f"sid={j['sid'] or '-':<14} wall={wall}")
        for job_id in waiting:
            print(f"{job_id}  inbox      (no serve loop has claimed it yet)")
    finally:
        catalog.close()


def _parse_tenant_weights(arg):
    if not arg:
        return None
    out = {}
    for part in arg.split(","):
        name, _, w = part.partition("=")
        out[name.strip()] = float(w) if w else 1.0
    return out


def _cmd_serve(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli serve")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    ap.add_argument("--budget", default=None,
                    help="global physical expert-byte pool ('2GiB', bytes)")
    ap.add_argument("--tenant-weights", default=None, metavar="T=W,...",
                    help="weighted-fair tenant shares, e.g. prod=3,batch=1")
    ap.add_argument("--admission", default="reject",
                    choices=["reject", "queue"],
                    help="over-budget submissions: reject at admission or "
                         "hold queued until the pool frees up")
    ap.add_argument("--max-window-jobs", type=int, default=16)
    ap.add_argument("--poll", type=float, default=0.2,
                    help="spool scan interval (seconds)")
    ap.add_argument("--once", action="store_true",
                    help="drain the current inbox, wait for completion, "
                         "then exit (instead of serving forever)")
    _add_device(ap)
    args = ap.parse_args(argv)

    inbox = _spool(args.workspace, "inbox")
    cancels = _spool(args.workspace, "cancel")
    handles = {}

    def _scan_inbox(svc):
        for fname in sorted(os.listdir(inbox)):
            if not fname.endswith(".json"):
                continue
            path = os.path.join(inbox, fname)
            try:
                with open(path, "r", encoding="utf-8") as f:
                    doc = json.load(f)
            except FileNotFoundError:
                continue  # retracted (cancelled) between listdir and open
            job_id = doc.get("job_id") or fname[:-5]
            if job_id in handles:
                continue  # already submitted; file stays until terminal
            prior = svc.catalog.get_job(job_id)
            if prior is not None and prior["state"] == "done":
                # a previous serve run finished this job but crashed
                # before clearing the spool: don't resurrect the row
                try:
                    os.remove(path)
                except FileNotFoundError:
                    pass
                print(f"[serve] {job_id} already done "
                      f"(sid={prior['sid']}); spool entry cleared",
                      flush=True)
                continue
            # the deadline clock starts at CLI submission, not at claim
            # time: hand the service whatever remains (a negative
            # remainder fails the job with DeadlineExceeded)
            deadline = doc.get("deadline")
            if deadline is not None and doc.get("submitted_at"):
                deadline -= time.time() - doc["submitted_at"]
            handle = svc.submit(
                doc["spec"],
                sid=doc.get("sid"),
                tenant=doc.get("tenant", "default"),
                priority=doc.get("priority", 0),
                deadline=deadline,
                job_id=job_id,
            )
            handles[job_id] = handle
            print(f"[serve] accepted {job_id} "
                  f"(tenant={handle.tenant}, priority={handle.priority})",
                  flush=True)

    def _scan_cancels():
        for job_id in os.listdir(cancels):
            handle = handles.get(job_id)
            if handle is not None and handle.status not in JobState.TERMINAL:
                handle.cancel()
                print(f"[serve] cancel requested for {job_id}", flush=True)
            os.remove(os.path.join(cancels, job_id))

    def _parked(handle):
        return (handle.admission or {}).get("decision") == "hold"

    def _report():
        # a job's inbox file survives until its terminal state is durable
        # in the catalog: a serve crash mid-execution re-submits the job
        # on restart (committed-snapshot adoption makes that idempotent)
        # instead of silently losing it.  Reported handles are pruned so
        # an always-on loop stays O(live jobs) in memory and per poll.
        for job_id in list(handles):
            handle = handles[job_id]
            if handle.status not in JobState.TERMINAL:
                continue
            if handle.status == JobState.DONE:
                st = handle.result.stats
                print(f"[serve] {job_id} done  sid={handle.sid}  "
                      f"expert_read={st['c_expert_run'] / 1e6:.1f}MB  "
                      f"window={handle.window_id}", flush=True)
            else:
                print(f"[serve] {job_id} {handle.status}", flush=True)
            try:
                os.remove(os.path.join(inbox, f"{job_id}.json"))
            except FileNotFoundError:
                pass
            del handles[job_id]

    svc = MergeService(
        args.workspace,
        block_size=args.block_size,
        budget=args.budget,
        tenants=_parse_tenant_weights(args.tenant_weights),
        admission=args.admission,
        max_window_jobs=args.max_window_jobs,
        device=args.device,
    )
    print(f"[serve] MergeService on {args.workspace}  "
          f"pool={args.budget or 'unbounded'}  "
          f"admission={args.admission}", flush=True)
    try:
        while True:
            _scan_inbox(svc)
            _scan_cancels()
            _report()
            live = [h for h in handles.values() if not _parked(h)]
            if args.once and not live and not any(
                f.endswith(".json") and f[:-5] not in handles
                for f in os.listdir(inbox)
            ):
                # admission-held jobs don't block --once: close() below
                # cancels them (recorded 'cancelled' in the job table;
                # resubmit once the pool has room)
                break
            time.sleep(args.poll)
    except KeyboardInterrupt:  # pragma: no cover - interactive exit
        print("[serve] interrupted; draining", flush=True)
    finally:
        svc.close()
        _report()


def _pipeline_config(args) -> PipelineConfig:
    return PipelineConfig(
        window_blocks=args.pipeline_window,
        prefetch_windows=args.pipeline_depth,
        read_threads=args.pipeline_read_threads,
        write_queue_blocks=args.pipeline_write_queue,
        kernel=args.pipeline_kernel,
        coalesce_gap_bytes=args.pipeline_coalesce_gap,
    )


def _prefer_packed(args):
    if args.no_packed:
        return False
    return args.layout if args.layout else True


def _parse_theta(pairs):
    theta = {}
    for p in pairs or []:
        k, v = p.split("=", 1)
        try:
            theta[k] = float(v) if "." in v or "e" in v.lower() else int(v)
        except ValueError:
            theta[k] = v
    return theta


def _cmd_repack(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli repack")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--base", required=True,
                    help="base checkpoint the layout elides against")
    ap.add_argument("--models", nargs="+", required=True,
                    help="expert checkpoints to pack into the layout")
    ap.add_argument("--layout-id", default=None)
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    ap.add_argument("--elide-threshold", type=float, default=0.0,
                    help="L2 bound on a block's delta below which it is "
                         "elided; 0 = byte-exact only (lossless)")
    ap.add_argument("--compress", default="none", choices=["none", "zlib"])
    ap.add_argument("--downcast", default=None,
                    choices=["float16", "bfloat16"],
                    help="store float32 extents downcast (LOSSY)")
    _add_device(ap)
    args = ap.parse_args(argv)
    from repro_torch.store.packed import RepackOptions

    sess = Session(args.workspace, block_size=args.block_size,
                   device=args.device)
    opts = RepackOptions(
        elide_threshold=args.elide_threshold,
        compress=args.compress,
        downcast=args.downcast,
    )
    rep = sess.repack(args.models, args.base, layout_id=args.layout_id,
                      options=opts)
    saved = rep["logical_bytes"] - rep["physical_bytes"]
    print(f"[repack] layout {rep['layout_id']}  "
          f"({'lossless' if rep['lossless'] else 'LOSSY'})")
    print(f"  members={len(rep['members'])}  extents={rep['extents']}  "
          f"elided={rep['elided_blocks']}  dedup={rep['dedup_blocks']}")
    print(f"  logical={rep['logical_bytes']/1e6:.1f}MB  "
          f"physical={rep['physical_bytes']/1e6:.1f}MB  "
          f"saved={saved/1e6:.1f}MB "
          f"({saved/max(rep['logical_bytes'],1)*100:.1f}%)")
    sess.close()


def _cmd_layouts(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli layouts")
    ap.add_argument("--workspace", required=True)
    _add_device(ap)
    args = ap.parse_args(argv)
    sess = Session(args.workspace, device=args.device)
    ids = sess.list_layouts()
    if not ids:
        print("no packed layouts")
    for lid in ids:
        row = sess.catalog.get_packed_layout(lid)
        st = row["stats"]
        print(f"{lid}  base={row['base_id']}  block={row['block_size']}  "
              f"members={len(row['members'])}  "
              f"{'lossless' if row['lossless'] else 'LOSSY'}  "
              f"logical={st.get('logical_bytes', 0)/1e6:.1f}MB  "
              f"physical={st.get('physical_bytes', 0)/1e6:.1f}MB  "
              f"elided={st.get('elided_blocks', 0)}  "
              f"dedup={st.get('dedup_blocks', 0)}")
    sess.close()


def _cmd_delete(argv) -> None:
    ap = argparse.ArgumentParser(prog="merge_cli delete")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("model_id")
    ap.add_argument("--force", action="store_true",
                    help="delete even while catalog lineage or a packed "
                         "layout still references the model")
    _add_device(ap)
    args = ap.parse_args(argv)
    sess = Session(args.workspace, device=args.device)
    try:
        if not sess.snapshots.models.exists(args.model_id):
            raise SystemExit(
                f"no such model {args.model_id!r} in {args.workspace}"
            )
        sess.snapshots.models.delete_model(args.model_id, force=args.force)
        print(f"[delete] removed {args.model_id}")
    except ValueError as e:
        raise SystemExit(str(e))
    finally:
        sess.close()


def _remote_profile(args):
    if not (args.latency_s or args.mbps or args.fail_every):
        return None
    return {
        "latency_s": args.latency_s,
        "mbps": args.mbps,
        "fail_every": args.fail_every,
    }


def _cmd_remote(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="merge_cli remote",
        description="Move models to / register models from a remote "
                    "object store (docs/STORAGE.md, tier hierarchy).",
    )
    ap.add_argument("action", choices=["push", "register"],
                    help="push: upload a local model and replace it with "
                         "a remote stub; register: point at a model "
                         "already published under --remote-root")
    ap.add_argument("model_id")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--remote-root", required=True,
                    help="object-store root directory (the emulated "
                         "endpoint); models live at <root>/<model_id>/")
    ap.add_argument("--latency-s", type=float, default=0.0,
                    help="emulated per-request latency (seconds)")
    ap.add_argument("--mbps", type=float, default=0.0,
                    help="emulated bandwidth (MB/s; 0 = unthrottled)")
    ap.add_argument("--fail-every", type=int, default=0,
                    help="inject a transient fault every Nth request "
                         "(exercises the retry path; 0 = never)")
    ap.add_argument("--keep-local", action="store_true",
                    help="push only: keep the local tensor files instead "
                         "of replacing them with the remote stub")
    ap.add_argument("--no-disk-cache", action="store_true",
                    help="serve reads straight from remote, bypassing "
                         "the local-disk extent cache")
    _add_device(ap)
    args = ap.parse_args(argv)
    sess = Session(args.workspace, device=args.device)
    try:
        profile = _remote_profile(args)
        if args.action == "push":
            sess.publish_model_remote(
                args.model_id, args.remote_root, profile=profile,
                keep_local=args.keep_local,
                disk_cache=not args.no_disk_cache,
            )
            print(f"[remote] pushed {args.model_id} -> {args.remote_root}"
                  f"{'  (local copy kept)' if args.keep_local else ''}")
        else:
            sess.register_remote_model(
                args.model_id, args.remote_root, profile=profile,
                disk_cache=not args.no_disk_cache,
            )
            print(f"[remote] registered {args.model_id} "
                  f"<- {args.remote_root}")
    except (ValueError, FileNotFoundError, IOError) as e:
        raise SystemExit(str(e))
    finally:
        sess.close()


def _cmd_cache(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="merge_cli cache",
        description="Inspect / shrink the workspace's shared local-disk "
                    "extent cache (the warm tier between RAM and remote).",
    )
    ap.add_argument("action", choices=["stats", "evict"])
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--target-bytes", type=int, default=0,
                    help="evict: LRU-shrink usage to this size (0 = clear)")
    _add_device(ap)
    args = ap.parse_args(argv)
    sess = Session(args.workspace, device=args.device)
    try:
        if args.action == "stats":
            st = sess.disk_cache_stats()
            cap = st["max_bytes"]
            print(f"extents={st['extents']}  "
                  f"usage={st['usage_bytes']/1e6:.2f}MB  "
                  f"cap={'unbounded' if not cap else f'{cap/1e6:.2f}MB'}")
            print(f"hits={st['hits']}  misses={st['misses']}  "
                  f"fills={st['fills']}  evictions={st['evictions']}")
        else:
            freed = sess.evict_disk_cache(args.target_bytes)
            st = sess.disk_cache_stats()
            print(f"[cache] freed {freed/1e6:.1f}MB  "
                  f"(now {st['extents']} extents, "
                  f"{st['usage_bytes']/1e6:.1f}MB)")
    finally:
        sess.close()


def _cmd_resume(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="merge_cli resume",
        description="List, resume, or discard crashed merges left "
                    "restartable by their block-level progress journals "
                    "(docs/RECOVERY.md).",
    )
    ap.add_argument("--workspace", required=True)
    ap.add_argument("sid", nargs="?", default=None,
                    help="crashed snapshot id to resume (omit to list)")
    ap.add_argument("--discard", action="store_true",
                    help="drop the journal and staged blocks instead of "
                         "resuming")
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    ap.add_argument("--compute", default="pipelined",
                    choices=["stream", "batched", "pipelined"])
    _add_device(ap)
    args = ap.parse_args(argv)
    from repro_torch.core.executor import execute_merge
    from repro_torch.core.plan import MergePlan
    from repro_torch.store.journal import parse_journal

    mp = MergePipe(args.workspace, block_size=args.block_size,
                   device=args.device)
    try:
        if args.sid is None:
            paths = mp.snapshots.list_journal_paths()
            if not paths:
                print("no resumable merges")
                return
            for path in paths:
                parsed = parse_journal(path, mp.stats)
                if parsed is None:
                    continue
                journaled = sum(len(b) for b in parsed.blocks.values())
                print(f"{parsed.sid}  attempt={parsed.attempt}  "
                      f"tensors_finished={len(parsed.finished)}"
                      f"/{len(parsed.tensors)}  "
                      f"blocks_journaled={journaled}")
            return
        state = mp.txn.prepare_resume(args.sid)
        if state is None:
            raise SystemExit(
                f"no usable journal for {args.sid!r} (already committed, "
                f"or nothing validated)"
            )
        if args.discard:
            state.discard()
            print(f"[resume] discarded journal + staging for {args.sid}")
            return
        plan_row = mp.catalog.get_plan(state.plan_id)
        if plan_row is None:
            raise SystemExit(
                f"journal for {args.sid!r} references plan "
                f"{state.plan_id!r}, which is not in the catalog — "
                f"use --discard and re-merge"
            )
        plan = MergePlan.from_payload(plan_row["payload"])
        t0 = time.time()
        with measure(mp.stats) as io:
            res = execute_merge(
                plan, mp.snapshots, mp.catalog, sid=args.sid, txn=mp.txn,
                compute=args.compute, resume=state, device=mp.device,
            )
        print(f"[resume] committed {res.sid}  "
              f"resumed_blocks={res.stats['resumed_blocks']}  "
              f"expert_read={res.stats['c_expert_run']/1e6:.1f} MB "
              f"(planned {res.stats['c_expert_hat']/1e6:.1f} MB)")
        print(f"wall={time.time()-t0:.2f}s  "
              f"expert_read={io['expert_read']/1e6:.1f}MB  "
              f"out_written={io['out_written']/1e6:.1f}MB")
    finally:
        mp.close()


def _cmd_shards(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="merge_cli shards",
        description="Plan a merge and print its byte-balanced shard "
                    "partition (docs/DISTRIBUTED.md) without executing.",
    )
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--base", required=True)
    ap.add_argument("--experts", nargs="+", required=True)
    ap.add_argument("--op", default="ties",
                    choices=["avg", "ta", "ties", "dare"])
    ap.add_argument("--budget", default=None,
                    help="'30%%', '2GiB', bytes, or a (0,1] fraction")
    ap.add_argument("--theta", nargs="*", help="k=v operator params")
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    ap.add_argument("--n-workers", type=int, default=2)
    ap.add_argument("--kernel", default="torch",
                    choices=["numpy", "torch", "mesh"],
                    help="'mesh' snaps shard cuts to tensor boundaries")
    ap.add_argument("--json", action="store_true")
    _add_device(ap)
    args = ap.parse_args(argv)
    from repro_torch.dist.partition import partition_plan

    budget = None
    if args.budget is not None:
        try:
            budget = float(args.budget)
            if budget > 1:
                budget = int(budget)
        except ValueError:
            budget = args.budget
    mp = MergePipe(args.workspace, block_size=args.block_size,
                   device=args.device)
    try:
        mp.ensure_analyzed(args.base, args.experts)
        pr = mp.plan(args.base, args.experts, args.op,
                     theta=_parse_theta(args.theta), budget=budget,
                     reuse=False)
        align = "tensor" if args.kernel == "mesh" else "block"
        part = partition_plan(pr.plan, mp.catalog, args.n_workers,
                              align=align)
        if args.json:
            print(json.dumps({
                "plan_id": pr.plan.plan_id,
                "align": align,
                "total_expert_bytes": part.total_expert_bytes,
                "duplicate_extent_bytes": part.duplicate_extent_bytes,
                "shards": [
                    {"shard": s.shard, "n_blocks": s.n_blocks,
                     "expert_bytes": s.expert_bytes, "budget": s.budget,
                     "spans": {t: list(span)
                               for t, span in sorted(s.spans.items())}}
                    for s in part.shards
                ],
            }, indent=2))
            return
        print(f"plan {pr.plan.plan_id}  align={align}  "
              f"total_expert={part.total_expert_bytes/1e6:.1f}MB  "
              f"cross-shard extent re-reads="
              f"{part.duplicate_extent_bytes/1e6:.2f}MB")
        for s in part.shards:
            spans = ", ".join(f"{t}[{lo}:{hi})"
                              for t, (lo, hi) in sorted(s.spans.items()))
            print(f"  shard {s.shard}: blocks={s.n_blocks}  "
                  f"expert={s.expert_bytes/1e6:.2f}MB  "
                  f"budget={s.budget/1e6:.2f}MB  {spans or '(empty)'}")
    finally:
        mp.close()


def _cmd_worker(argv) -> None:
    # same entrypoint LocalProcessTransport launches as a subprocess;
    # exposed here for manual lease runs and post-mortem debugging
    from repro_torch.launch.worker import main as worker_main

    raise SystemExit(worker_main(argv))


def _cmd_fsck(argv) -> None:
    ap = argparse.ArgumentParser(
        prog="merge_cli fsck",
        description="mergefsck: scrub every store of a workspace against "
                    "the block-integrity contract (docs/STORAGE.md) — "
                    "models, snapshots, packed layouts, disk cache, "
                    "journals, remote stubs.",
    )
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--check", action="store_true",
                    help="detect only (no cache drops / journal removal); "
                         "exit 1 when any damage is found")
    ap.add_argument("--repair", action="store_true",
                    help="explicit repair mode (the default when --check "
                         "is not given; kept for scripting clarity)")
    ap.add_argument("--rate-mbps", type=float, default=0.0,
                    help="throttle scrub I/O to this many MB/s (0 = "
                         "unthrottled)")
    ap.add_argument("--json", action="store_true",
                    help="emit the full report as JSON instead of text")
    _add_device(ap)
    args = ap.parse_args(argv)
    if args.check and args.repair:
        raise SystemExit("--check and --repair are mutually exclusive")
    sess = Session(args.workspace, device=args.device)
    try:
        report = sess.fsck(repair=not args.check, rate_mbps=args.rate_mbps)
    finally:
        sess.close()
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.summary())
    if report.exit_code():
        raise SystemExit(report.exit_code())


def _run_specs(args) -> None:
    specs = load_spec_file(args.spec)
    sess = Session(args.workspace, block_size=args.block_size,
                   device=args.device)
    handles = [sess.submit(s, sid=s.name) for s in specs]
    cache_max = "auto"
    if args.cache_max_bytes is not None:
        cache_spec = BudgetSpec.parse(args.cache_max_bytes)
        if cache_spec.kind == "fraction":
            raise SystemExit(
                "--cache-max-bytes is a memory size, not a fraction; "
                "use bytes or a unit string like '2GiB'"
            )
        cache_max = cache_spec.resolve()
    t0 = time.time()
    with measure(sess.stats) as io:
        results = sess.run_all(
            shared_reads=not args.no_shared_reads,
            shared_budget=args.shared_budget,
            compute=args.compute,
            cache_max_bytes=cache_max,
            pipeline=_pipeline_config(args),
            prefer_packed=_prefer_packed(args),
        )
    wall = time.time() - t0
    for h, res in zip(handles, results):
        print(f"[mergepipe] committed {res.sid}  "
              f"(spec {h.spec.spec_id}, op={h.spec.op})  "
              f"expert_read={res.stats['c_expert_run']/1e6:.1f} MB "
              f"(planned {res.stats['c_expert_hat']/1e6:.1f} MB)")
    batch = results[0].stats.get("batch") if results else None
    if batch:
        print(f"[batch] jobs={batch['jobs']}  "
              f"union={batch['c_expert_hat_union']/1e6:.1f} MB  "
              f"sum={batch['c_expert_hat_sum']/1e6:.1f} MB  "
              f"sharing={batch['sharing_factor']:.2f}x")
    print(
        f"wall={wall:.2f}s  base_read={io['base_read']/1e6:.1f}MB  "
        f"expert_read={io['expert_read']/1e6:.1f}MB  "
        f"out_written={io['out_written']/1e6:.1f}MB  meta={io['meta']/1e6:.2f}MB"
    )
    sess.close()


def main(argv=None) -> None:
    """Run the CLI on ``argv`` (default ``sys.argv[1:]``); callable in
    process.  Failures raise (``SystemExit`` for usage errors)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in SUBCOMMANDS:
        cmd, argv = argv[0], argv[1:]
        if cmd == "serve":
            return _cmd_serve(argv)
        if cmd == "submit":
            return _cmd_submit(argv)
        if cmd == "status":
            return _cmd_status(argv)
        if cmd == "cancel":
            return _cmd_cancel(argv)
        if cmd == "shards":
            return _cmd_shards(argv)
        if cmd == "worker":
            return _cmd_worker(argv)
        if cmd == "repack":
            return _cmd_repack(argv)
        if cmd == "layouts":
            return _cmd_layouts(argv)
        if cmd == "remote":
            return _cmd_remote(argv)
        if cmd == "cache":
            return _cmd_cache(argv)
        if cmd == "resume":
            return _cmd_resume(argv)
        if cmd == "fsck":
            return _cmd_fsck(argv)
        return _cmd_delete(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--spec", default=None,
                    help="JSON MergeSpec document (single spec, list, "
                         "or {'jobs': [...]}); enables batch execution")
    ap.add_argument("--shared-budget", default=None,
                    help="pooled cap on the batch's union expert reads "
                         "('1GiB', '50%%', bytes); --spec mode only")
    ap.add_argument("--no-shared-reads", action="store_true",
                    help="disable the cross-job block cache (--spec mode)")
    ap.add_argument("--cache-max-bytes", default=None,
                    help="bound on the shared-read cache ('2GiB', bytes; "
                         "default 1GiB, 'unbounded' to disable the cap)")
    ap.add_argument("--base", default=None)
    ap.add_argument("--experts", nargs="+", default=None)
    ap.add_argument("--op", default="ties",
                    choices=["avg", "ta", "ties", "dare"])
    ap.add_argument("--budget", default=None,
                    help="'30%%', '2GiB', absolute bytes, or a (0,1] fraction")
    ap.add_argument("--theta", nargs="*", help="k=v operator params")
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    ap.add_argument("--sid", default=None)
    ap.add_argument("--compute", default="pipelined",
                    choices=["stream", "batched", "pipelined"],
                    help="execution engine: 'pipelined' (overlapped "
                         "prefetch/compute/write-behind, default), "
                         "'stream' (paper-faithful synchronous), or "
                         "'batched' (whole-tensor kernels on --device)")
    pd = PipelineConfig()  # single source of truth for the defaults
    ap.add_argument("--pipeline-window", type=int, default=pd.window_blocks,
                    help="blocks per pipelined compute window")
    ap.add_argument("--pipeline-depth", type=int, default=pd.prefetch_windows,
                    help="prefetched windows in flight (queue depth)")
    ap.add_argument("--pipeline-read-threads", type=int,
                    default=pd.read_threads,
                    help="reader thread-pool size for the prefetch stage")
    ap.add_argument("--pipeline-write-queue", type=int,
                    default=pd.write_queue_blocks,
                    help="bound on write-behind queued output blocks")
    ap.add_argument("--pipeline-kernel", default=pd.kernel,
                    choices=["numpy", "torch"],
                    help="pipelined compute kernel: 'torch' (default) "
                         "runs the merge kernels on --device; 'numpy' "
                         "computes on the host (bit-identical to stream)")
    ap.add_argument("--pipeline-coalesce-gap", type=int,
                    default=pd.coalesce_gap_bytes,
                    help="tolerated unselected bytes between selected "
                         "ranges before a coalesced read splits (0 = "
                         "adjacent-only; gap bytes are accounted as "
                         "'other', never against the expert budget)")
    ap.add_argument("--no-packed", action="store_true",
                    help="always read flat checkpoints even when a "
                         "covering packed layout exists")
    ap.add_argument("--layout", default=None, metavar="LAYOUT_ID",
                    help="force merging from a specific packed layout "
                         "(explicit opt-in required for lossy layouts)")
    ap.add_argument("--chaos-crash", default=None, metavar="POINT",
                    help="fault injection: simulate a worker death at "
                         "this point (e.g. 'executor:block'); the service "
                         "requeues the job and resumes it from the "
                         "progress journal (docs/RECOVERY.md)")
    ap.add_argument("--chaos-skip", type=int, default=0,
                    help="let the crash point pass N times before firing")
    ap.add_argument("--naive", action="store_true",
                    help="run the stateless full-read baseline instead")
    ap.add_argument("--explain", default=None, metavar="SID",
                    help="print the audit record for a snapshot and exit")
    _add_device(ap)
    args = ap.parse_args(argv)

    if args.explain:
        mp = MergePipe(args.workspace, block_size=args.block_size,
                       device=args.device)
        print(json.dumps(mp.explain(args.explain), indent=2, default=str))
        return
    if args.spec:
        _run_specs(args)
        return
    if not args.base or not args.experts:
        raise SystemExit("--base/--experts are required without --spec")

    chaos_inj = None
    if args.chaos_crash:
        from repro_torch.testing import chaos

        chaos_inj = chaos.arm(args.chaos_crash, skip=args.chaos_skip)
    mp = MergePipe(args.workspace, block_size=args.block_size,
                   device=args.device)
    budget = None
    if args.budget is not None:
        try:
            budget = float(args.budget)
            if budget > 1:
                budget = int(budget)
        except ValueError:
            budget = args.budget  # "30%", "2GiB", ... (BudgetSpec notation)
    theta = _parse_theta(args.theta)

    t0 = time.time()
    with measure(mp.stats) as io:
        if args.naive:
            out = naive_merge(
                mp.snapshots.models, args.base, args.experts, args.op, theta,
                out_id=args.sid,
            )
            print(f"[naive] wrote {out}")
        else:
            try:
                res = mp.merge(
                    args.base, args.experts, op=args.op, theta=theta,
                    budget=budget, sid=args.sid, compute=args.compute,
                    pipeline=_pipeline_config(args),
                    prefer_packed=_prefer_packed(args),
                )
            except BaseException as e:
                from repro_torch.testing.chaos import SimulatedCrash

                if not isinstance(e, SimulatedCrash):
                    raise
                # a crash that escaped the service's requeue/resume path
                # (it ran out of attempts, or fired outside execution):
                # like SIGKILL, staging and the journal survive
                print(f"[chaos] {e}; journal kept — run "
                      f"'merge_cli resume --workspace {args.workspace} "
                      f"{args.sid or '<sid>'}' to continue", file=sys.stderr)
                raise SystemExit(3)
            if chaos_inj is not None and chaos_inj.fired:
                print(f"[chaos] injected crash at {chaos_inj.point} was "
                      f"recovered in-process: job requeued and resumed "
                      f"at its journaled high-water mark")
            print(f"[mergepipe] committed {res.sid}  "
                  f"expert_read={res.stats['c_expert_run']/1e6:.1f} MB "
                  f"(planned {res.stats['c_expert_hat']/1e6:.1f} MB)")
    wall = time.time() - t0
    print(
        f"wall={wall:.2f}s  base_read={io['base_read']/1e6:.1f}MB  "
        f"expert_read={io['expert_read']/1e6:.1f}MB  "
        f"out_written={io['out_written']/1e6:.1f}MB  meta={io['meta']/1e6:.2f}MB"
    )


if __name__ == "__main__":
    main()
