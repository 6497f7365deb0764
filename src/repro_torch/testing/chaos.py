"""Chaos fault injection: simulated process deaths at named crash points,
and simulated data corruption at named corruption points.

The recovery story (docs/RECOVERY.md) is only credible if every stage of
the execution path has been killed and resumed.  This module provides the
kill switch: production code calls :func:`chaos_point` at the places a
real worker could die, and tests/benchmarks arm an injector with
:func:`inject` to turn exactly one of those points into a simulated
SIGKILL.

The integrity story (docs/STORAGE.md §Integrity) gets the same
treatment: storage code threads payloads through :func:`chaos_corrupt`
at the places real bytes could rot — a remote ranged GET, a disk-cache
extent at rest, a packed extent read — and tests arm a
:class:`CorruptionInjector` with :func:`inject_corruption` to flip a
bit, truncate the payload, or substitute a stale extent at exactly one
of those points.

Design notes:

* :class:`SimulatedCrash` derives from ``BaseException`` **on purpose**:
  the executor's ``except Exception`` abort path must NOT trigger, so the
  staging directory and progress journal stay on disk exactly as a real
  process death would leave them.  Deliberate failures (operator errors,
  cancellation) still abort and discard; only simulated kills leave
  resumable state behind.
* ``chaos_point`` is a single global-load plus ``is None`` check when no
  injector is armed — cheap enough for per-block call sites.
* Injectors fire once (``skip`` earlier visits first) and record that
  they fired, so a sweep can assert the point was actually reached.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

#: every registered crash point, in rough execution order.  The crash
#: sweep test parametrizes over this tuple — adding a call site without
#: registering it here means the sweep silently skips it, so keep them
#: in lockstep.
CRASH_POINTS = (
    "executor:tensor",     # stream/batched: before a tensor begins
    "executor:block",      # stream: before each block's base read
    "executor:prefetch",   # pipelined: reader-pool window staging
    "executor:window",     # pipelined: compute stage, per window
    "writer:drain",        # write-behind thread, before applying a command
    "journal:append",      # before a journal record is written
    "publish:before",      # transaction manager, before the publish rename
    "publish:after",       # after publish, before the catalog commit record
    "cache:fill",          # disk extent cache, before the atomic rename
    "worker:lease",        # shard worker: after accepting a lease, before I/O
    "worker:block",        # shard worker: before each staged block write
    "worker:commit",       # shard worker: before writing the result doc
    "build:publish",       # kernels/build.py: a built library, fsynced,
                           # before the rename that publishes it
)


class SimulatedCrash(BaseException):
    """An injected process death.

    Deliberately NOT an ``Exception``: the executor's abort handler
    (``except Exception: txn.abort()``) must not see it, so staged
    output and the progress journal survive — the same on-disk state a
    kill -9 would leave.
    """

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point}")
        self.point = point


class ChaosInjector:
    """Kills the process-under-test at the ``skip+1``-th visit of one
    crash point (thread-safe: points are visited from reader-pool,
    write-behind, and compute threads alike)."""

    def __init__(self, point: str, skip: int = 0):
        if point not in CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {point!r}; registered: {CRASH_POINTS}"
            )
        self.point = point
        self.skip = int(skip)
        self.hits = 0
        self.fired = False
        self._lock = threading.Lock()

    def visit(self, name: str) -> None:
        if name != self.point:
            return
        with self._lock:
            self.hits += 1
            if self.hits <= self.skip or self.fired:
                return
            self.fired = True
        raise SimulatedCrash(name)


_active: Optional[ChaosInjector] = None


def chaos_point(name: str) -> None:
    """Mark a crash-point call site.  No-op unless an injector is armed."""
    inj = _active
    if inj is not None:
        inj.visit(name)


@contextlib.contextmanager
def inject(point: str, skip: int = 0) -> Iterator[ChaosInjector]:
    """Arm a single-shot crash injector for the duration of the block."""
    global _active
    inj = ChaosInjector(point, skip=skip)
    prev = _active
    _active = inj
    try:
        yield inj
    finally:
        _active = prev


def arm(point: str, skip: int = 0) -> ChaosInjector:
    """Arm an injector without a context manager (CLI chaos flags)."""
    global _active
    inj = ChaosInjector(point, skip=skip)
    _active = inj
    return inj


def disarm() -> None:
    global _active
    _active = None


# -- corruption injection ---------------------------------------------------

#: every registered corruption point, in tier order.  Like CRASH_POINTS,
#: the mergelint durability pass and tests/test_chaos_registry.py hold
#: this tuple and the live ``chaos_corrupt("...")`` call sites in
#: bijection — drift in either direction fails the lint gate.
CORRUPTION_POINTS = (
    "remote:get",      # RemoteObjectStore.get_range payload (wire bit-rot)
    "cache:extent",    # DiskExtentCache.put payload (at-rest bit-rot)
    "packed:extent",   # PackedLayout._pread physical extent bytes
)

#: supported corruption modes
CORRUPTION_MODES = ("bitflip", "truncate", "stale")


class CorruptionInjector:
    """Corrupts the payload of the ``skip+1``-th visit of one corruption
    point (thread-safe), then passes everything else through untouched.

    Modes:

    * ``bitflip`` — flip one bit in the middle byte (checksum-detectable,
      length-preserving);
    * ``truncate`` — drop the final quarter of the payload (caught by
      length validation before hashing);
    * ``stale`` — substitute the *previous* payload seen at this point
      (the stale-extent-substitution failure: right length, wrong
      content), falling back to a bit-flip when no prior payload exists.
    """

    def __init__(self, point: str, mode: str = "bitflip", skip: int = 0):
        if point not in CORRUPTION_POINTS:
            raise ValueError(
                f"unknown corruption point {point!r}; "
                f"registered: {CORRUPTION_POINTS}"
            )
        if mode not in CORRUPTION_MODES:
            raise ValueError(
                f"unknown corruption mode {mode!r}; "
                f"supported: {CORRUPTION_MODES}"
            )
        self.point = point
        self.mode = mode
        self.skip = int(skip)
        self.hits = 0
        self.fired = False
        self._prev: Optional[bytes] = None  # guarded-by: _lock
        self._lock = threading.Lock()

    def visit(self, name: str, data: bytes) -> bytes:
        if name != self.point or not data:
            return data
        with self._lock:
            self.hits += 1
            if self.hits <= self.skip or self.fired:
                self._prev = data
                return data
            self.fired = True
            prev = self._prev
        return corrupt_bytes(data, self.mode, prev=prev)


def corrupt_bytes(data: bytes, mode: str,
                  prev: Optional[bytes] = None) -> bytes:
    """Apply one corruption mode to a payload (pure function, reused by
    the fsck fixtures to damage files on disk)."""
    if not data:
        return data
    if mode == "truncate":
        return data[: max(1, len(data) - max(1, len(data) // 4))]
    if mode == "stale" and prev is not None and prev != data:
        # right length, wrong content — the hardest case: only a
        # content hash catches it
        if len(prev) >= len(data):
            return prev[: len(data)]
        return prev + b"\x00" * (len(data) - len(prev))
    buf = bytearray(data)
    buf[len(buf) // 2] ^= 0x40
    return bytes(buf)


def corrupt_file(path: str, mode: str = "bitflip") -> None:
    """Damage a file on disk in place (fsck test fixtures)."""
    with open(path, "rb") as f:
        data = f.read()
    with open(path, "wb") as f:
        f.write(corrupt_bytes(data, mode))


_active_corruption: Optional[CorruptionInjector] = None


def chaos_corrupt(name: str, data: bytes) -> bytes:
    """Mark a corruption-point call site: payload in, (possibly
    corrupted) payload out.  Identity unless an injector is armed."""
    inj = _active_corruption
    if inj is not None:
        return inj.visit(name, data)
    return data


@contextlib.contextmanager
def inject_corruption(point: str, mode: str = "bitflip",
                      skip: int = 0) -> Iterator[CorruptionInjector]:
    """Arm a single-shot corruption injector for the duration of the
    block."""
    global _active_corruption
    inj = CorruptionInjector(point, mode=mode, skip=skip)
    prev = _active_corruption
    _active_corruption = inj
    try:
        yield inj
    finally:
        _active_corruption = prev


def arm_corruption(point: str, mode: str = "bitflip",
                   skip: int = 0) -> CorruptionInjector:
    """Arm a corruption injector without a context manager (CLI flags)."""
    global _active_corruption
    inj = CorruptionInjector(point, mode=mode, skip=skip)
    _active_corruption = inj
    return inj


def disarm_corruption() -> None:
    global _active_corruption
    _active_corruption = None
