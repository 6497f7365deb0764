"""Worker transports — how the coordinator launches and watches shards.

The transport interface is deliberately tiny (launch a lease, poll for
an exit) and passes work by JSON document, so a real RPC backend can
drop in without touching the coordinator: a lease is what you would put
on the wire, a result doc is what would come back.

``LocalProcessTransport`` is the production-shaped default: each worker
is a separate ``python -m repro_torch.launch.worker`` process (its own
interpreter, its own IOStats, its own readers — the honest stand-in for
a remote host).  Exit code 3 means a simulated crash (chaos); the
staged region and shard journal survive for lease re-issue.  A crashed
process takes its partial stats to the grave, exactly like real worker
death.

``InlineTransport`` runs the worker synchronously in the coordinator
process.  It exists for deterministic tests: a simulated crash is
caught and the dead attempt's partial :class:`IOStats` snapshot is
salvaged, so the `[hat, 2*hat)` crash-spend bound can be asserted over
bytes a process transport would lose.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from typing import Dict, Optional

from repro_torch.dist.lease import ShardLease
from repro_torch.store.iostats import IOStats
from repro_torch.testing.chaos import SimulatedCrash

#: process exit code signalling a SimulatedCrash (resumable death)
CRASH_EXIT = 3


@dataclasses.dataclass
class WorkerExit:
    """Terminal state of one lease attempt."""

    shard: int
    attempt: int
    ok: bool
    #: True when the worker died a *resumable* death (chaos crash or
    #: killed process) — the lease may be re-issued
    crashed: bool
    result: Optional[Dict] = None
    detail: str = ""
    #: inline transport only: the dead attempt's IOStats snapshot
    partial_stats: Optional[Dict] = None


class _ProcessHandle:
    def __init__(self, lease: ShardLease, proc: subprocess.Popen,
                 result_path: str, log_path: str):
        self.lease = lease
        self.proc = proc
        self.result_path = result_path
        self.log_path = log_path

    def poll(self) -> Optional[WorkerExit]:
        code = self.proc.poll()
        if code is None:
            return None
        if code == 0 and os.path.exists(self.result_path):
            with open(self.result_path) as f:
                return WorkerExit(self.lease.shard, self.lease.attempt,
                                  ok=True, crashed=False,
                                  result=json.load(f))
        # a 0-exit with no result doc is a commit-window death lookalike;
        # treat any non-clean outcome without a doc as a crash candidate
        crashed = code in (CRASH_EXIT, -9, -15) or (
            code == 0 and not os.path.exists(self.result_path))
        return WorkerExit(
            self.lease.shard, self.lease.attempt, ok=False, crashed=crashed,
            detail="worker exited %s (%s)" % (code, self._log_tail()),
        )

    def terminate(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def _log_tail(self, n: int = 2000) -> str:
        try:
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - n))
                return f.read().decode("utf-8", "replace").strip()
        except OSError:
            return "no log"


class LocalProcessTransport:
    """One subprocess per lease; lease and result travel as JSON files
    under the coordinator's shard control directory."""

    def launch(self, workspace: str, lease: ShardLease, ctl_dir: str):
        os.makedirs(ctl_dir, exist_ok=True)
        tag = "shard%d.attempt%d" % (lease.shard, lease.attempt)
        lease_path = os.path.join(ctl_dir, tag + ".lease.json")
        result_path = os.path.join(ctl_dir, tag + ".result.json")
        log_path = os.path.join(ctl_dir, tag + ".log")
        lease.write(lease_path)
        import repro_torch

        src = os.path.dirname(os.path.dirname(os.path.abspath(
            repro_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = src + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log = open(log_path, "wb")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.worker",
                 "--workspace", workspace,
                 "--lease", lease_path,
                 "--result", result_path],
                stdout=log, stderr=subprocess.STDOUT, env=env,
            )
        finally:
            log.close()
        return _ProcessHandle(lease, proc, result_path, log_path)


class _InlineHandle:
    def __init__(self, exit: WorkerExit):
        self._exit = exit

    def poll(self) -> Optional[WorkerExit]:
        return self._exit

    def terminate(self) -> None:
        pass


class InlineTransport:
    """Synchronous in-process worker (tests).  Crashed attempts keep
    their IOStats snapshot so spend bounds stay assertable."""

    def launch(self, workspace: str, lease: ShardLease, ctl_dir: str):
        from repro_torch.dist.worker import run_worker

        stats = IOStats()
        try:
            doc = run_worker(workspace, lease, stats=stats)
            ex = WorkerExit(lease.shard, lease.attempt, ok=True,
                            crashed=False, result=doc)
        except SimulatedCrash as e:
            ex = WorkerExit(
                lease.shard, lease.attempt, ok=False, crashed=True,
                detail=str(e), partial_stats=stats.snapshot(),
            )
        return _InlineHandle(ex)


def make_transport(name: str):
    if name == "process":
        return LocalProcessTransport()
    if name == "inline":
        return InlineTransport()
    raise ValueError("unknown transport %r" % (name,))
