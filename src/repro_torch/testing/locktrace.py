"""Runtime lock-order tracer — the dynamic companion to mergelint.

While installed, ``threading.Lock`` / ``RLock`` / ``Condition`` objects
allocated from traced source files (default: anything under
``repro_torch/``) are wrapped in recording proxies.  The tracer maintains a
per-thread stack of held traced locks and builds the cross-thread
*acquisition-order graph*: an edge ``A -> B`` means some thread
acquired ``B`` while holding ``A``, keyed by the locks' allocation
sites so every instance of a class shares one node.  A cycle in that
graph is a potential deadlock (the classic lockdep invariant) even if
the run never actually deadlocked, because the two orders can
interleave under different timing.

It also enforces the scheduler-responsiveness invariant: **no blocking
I/O while holding the scheduler lock**.  Locks allocated from
``api/service.py`` (``MergeService._cond``, the arbiter lock) guard
pure queue/budget state; ``submit()`` and ``cancel()`` block on them,
so holding one across a disk read, fsync, or catalog (sqlite) write
would stall the public API behind storage latency.  While tracing,
``os.pread`` / ``os.fsync`` / ``os.replace`` and the catalog's write
methods assert that no scheduler lock is held by the calling thread.

Usage (see the ``lock_tracer`` fixture in ``tests/torch_locktrace.py``)::

    tracer = LockTracer()
    tracer.install()
    try:
        ... run threaded workload ...
    finally:
        tracer.uninstall()
    tracer.check()   # raises LockOrderError on cycles / IO violations
"""
from __future__ import annotations

import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = ["LockTracer", "LockOrderError"]


class LockOrderError(AssertionError):
    """A potential deadlock (acquisition-order cycle) or blocking I/O
    under a scheduler lock was observed."""


def _site_of(frame) -> str:
    path = frame.f_code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    return "%s:%d" % ("/".join(parts[-3:]), frame.f_lineno)


class _TracedLock:
    """Transparent proxy over a real lock primitive that maintains the
    tracer's per-thread held stack and order graph.  Implements the
    private Condition protocol (``_release_save`` etc.) so it can serve
    as the lock inside a ``threading.Condition`` — ``wait()`` then
    correctly pops it from the held stack while blocked."""

    __slots__ = ("_inner", "site", "guard", "_tracer")

    def __init__(self, inner, site: str, guard: bool, tracer: "LockTracer"):
        self._inner = inner
        self.site = site
        self.guard = guard
        self._tracer = tracer

    # ------------------------------------------------------ lock surface
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        stack = self._tracer._stack()
        if not any(e is self for e in stack):
            self._tracer._note_edges(stack, self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            stack.append(self)
        return ok

    def release(self) -> None:
        self._inner.release()
        stack = self._tracer._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is self:
                del stack[i]
                break

    __enter__ = acquire

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # ------------------------------------- Condition protocol delegation
    def _release_save(self):
        stack = self._tracer._stack()
        n = sum(1 for e in stack if e is self)
        stack[:] = [e for e in stack if e is not self]
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), n)
        self._inner.release()
        return (None, n)

    def _acquire_restore(self, saved) -> None:
        state, n = saved
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(state)
        else:
            self._inner.acquire()
        self._tracer._stack().extend([self] * n)

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        return any(e is self for e in self._tracer._stack())

    def __repr__(self) -> str:
        return "<TracedLock %s guard=%s>" % (self.site, self.guard)


#: catalog methods that commit to sqlite — blocking I/O for the purpose
#: of the scheduler-lock invariant
_CATALOG_WRITES = (
    "record_job", "update_job", "update_jobs", "record_spec",
    "record_manifest", "record_coverage", "record_touch_map",
    "record_plan", "record_dag_edges",
)
_OS_IO = ("pread", "fsync", "replace")


class LockTracer:
    def __init__(
        self,
        trace_paths: Tuple[str, ...] = ("repro_torch/", "/tests/"),
        guard_paths: Tuple[str, ...] = ("api/service.py",),
    ):
        self.trace_paths = trace_paths
        self.guard_paths = guard_paths
        #: (site_a, site_b) -> example thread name that took b under a
        self.edges: Dict[Tuple[str, str], str] = {}
        #: (io_name, lock_site, io_site, thread) records
        self.io_violations: List[Tuple[str, str, str, str]] = []
        self._tls = threading.local()
        self._mut = threading.Lock()  # guards edges / io_violations
        self._installed = False
        self._saved: Dict[str, object] = {}

    # ------------------------------------------------------- bookkeeping
    def _stack(self) -> List[_TracedLock]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _note_edges(self, stack: List[_TracedLock], nxt: _TracedLock) -> None:
        if not stack:
            return
        tname = threading.current_thread().name
        with self._mut:
            for held in stack:
                if held.site != nxt.site:
                    self.edges.setdefault((held.site, nxt.site), tname)

    def _note_io(self, io_name: str, io_site: str) -> None:
        for held in self._stack():
            if held.guard:
                with self._mut:
                    self.io_violations.append((
                        io_name, held.site, io_site,
                        threading.current_thread().name,
                    ))

    def _traced_site(self) -> Optional[Tuple[str, bool]]:
        """Allocation site of the caller two frames up, if traced."""
        frame = sys._getframe(2)
        path = frame.f_code.co_filename.replace(os.sep, "/")
        if not any(t in path for t in self.trace_paths):
            return None
        site = _site_of(frame)
        guard = any(g in path for g in self.guard_paths)
        return site, guard

    # ----------------------------------------------------------- install
    def install(self) -> "LockTracer":
        if self._installed:
            return self
        orig_lock = threading.Lock
        orig_rlock = threading.RLock
        orig_cond = threading.Condition
        tracer = self

        def make_lock():
            hit = tracer._traced_site()
            if hit is None:
                return orig_lock()
            return _TracedLock(orig_lock(), hit[0], hit[1], tracer)

        def make_rlock():
            hit = tracer._traced_site()
            if hit is None:
                return orig_rlock()
            return _TracedLock(orig_rlock(), hit[0], hit[1], tracer)

        def make_cond(lock=None):
            if lock is None:
                hit = tracer._traced_site()
                if hit is not None:
                    lock = _TracedLock(orig_rlock(), hit[0], hit[1], tracer)
            return orig_cond(lock)

        self._saved = {
            "Lock": orig_lock, "RLock": orig_rlock, "Condition": orig_cond,
            "os": {name: getattr(os, name) for name in _OS_IO},
        }
        threading.Lock = make_lock
        threading.RLock = make_rlock
        threading.Condition = make_cond

        def wrap_os(name, real):
            def wrapper(*a, **kw):
                tracer._note_io("os." + name, _site_of(sys._getframe(1)))
                return real(*a, **kw)
            wrapper.__name__ = name
            return wrapper

        for name in _OS_IO:
            setattr(os, name, wrap_os(name, self._saved["os"][name]))

        try:
            from repro_torch.core.catalog import Catalog
        except ImportError:  # pragma: no cover — catalog always present
            Catalog = None
        if Catalog is not None:
            saved_cat = {}
            for name in _CATALOG_WRITES:
                real = getattr(Catalog, name, None)
                if real is None:
                    continue
                saved_cat[name] = real

                def wrap_cat(mname, rfunc):
                    def wrapper(cself, *a, **kw):
                        tracer._note_io(
                            "catalog." + mname, _site_of(sys._getframe(1)))
                        return rfunc(cself, *a, **kw)
                    wrapper.__name__ = mname
                    return wrapper

                setattr(Catalog, name, wrap_cat(name, real))
            self._saved["catalog"] = (Catalog, saved_cat)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        threading.Lock = self._saved["Lock"]
        threading.RLock = self._saved["RLock"]
        threading.Condition = self._saved["Condition"]
        for name, real in self._saved["os"].items():
            setattr(os, name, real)
        cat = self._saved.get("catalog")
        if cat:
            Catalog, saved_cat = cat
            for name, real in saved_cat.items():
                setattr(Catalog, name, real)
        self._installed = False

    def __enter__(self) -> "LockTracer":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ------------------------------------------------------------ verdict
    def cycles(self) -> List[List[str]]:
        """Elementary cycles in the acquisition-order graph (DFS)."""
        graph: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        seen_cycles: Set[frozenset] = set()
        for start in sorted(graph):
            path: List[str] = []
            on_path: Set[str] = set()

            def dfs(node: str) -> None:
                if node in on_path:
                    cyc = path[path.index(node):] + [node]
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    return
                path.append(node)
                on_path.add(node)
                for nxt in sorted(graph.get(node, ())):
                    dfs(nxt)
                path.pop()
                on_path.discard(node)

            dfs(start)
        return out

    def check(self) -> None:
        """Raise :class:`LockOrderError` on any cycle or IO violation."""
        problems: List[str] = []
        for cyc in self.cycles():
            chain = " -> ".join(cyc)
            detail = "; ".join(
                "%s->%s by %s" % (a, b, t)
                for (a, b), t in sorted(self.edges.items())
                if a in cyc and b in cyc
            )
            problems.append(
                "lock-order cycle (potential deadlock): %s  [%s]"
                % (chain, detail)
            )
        for io_name, lock_site, io_site, thread in self.io_violations:
            problems.append(
                "blocking I/O under scheduler lock: %s at %s while "
                "thread %r holds lock allocated at %s"
                % (io_name, io_site, thread, lock_site)
            )
        if problems:
            raise LockOrderError("\n".join(problems))
