"""Shared fixtures. NOTE: no XLA_FLAGS here — smoke tests and benches
must see the real single CPU device; only launch/dryrun.py forces 512
placeholder devices (in its own process)."""
import numpy as np
import pytest

from repro.core.api import MergePipe
from repro.store.iostats import IOStats
from repro.testing.locktrace import LockTracer


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none"
    )


@pytest.fixture
def stats():
    """Debug-mode stats: every record_* call validates its category and
    the totals decomposition is re-checked after the test."""
    st = IOStats(debug=True)
    yield st
    st.self_check()


@pytest.fixture
def lock_tracer():
    """Runtime lock-order tracer (repro.testing.locktrace): traces every
    repro lock allocated while active; teardown fails the test on an
    acquisition-order cycle or on blocking I/O under the scheduler lock."""
    tracer = LockTracer()
    tracer.install()
    try:
        yield tracer
    finally:
        tracer.uninstall()
    tracer.check()


@pytest.fixture
def workspace(tmp_path, stats):
    mp = MergePipe(str(tmp_path / "ws"), block_size=4096, stats=stats)
    yield mp
    mp.close()


def make_models(rng=None, n_experts=3, shapes=None, scale=0.02):
    """Base + experts with controlled delta magnitude."""
    rng = rng or np.random.default_rng(0)
    shapes = shapes or {"layer0/w": (64, 96), "layer0/b": (96,), "emb": (128, 32)}
    base = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    experts = []
    for _ in range(n_experts):
        experts.append(
            {k: v + scale * rng.normal(size=v.shape).astype(np.float32)
             for k, v in base.items()}
        )
    return base, experts


@pytest.fixture
def populated(workspace):
    """Workspace with base + 3 full-weight experts registered."""
    base, experts = make_models()
    workspace.register_model("base", base)
    ids = []
    for i, e in enumerate(experts):
        workspace.register_model(f"ex{i}", e)
        ids.append(f"ex{i}")
    return workspace, "base", ids, base, experts
