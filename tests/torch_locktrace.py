"""The port's ``lock_tracer`` fixture: the port's own lock-order tracer
(``repro_torch.testing.locktrace``), which traces the locks allocated
under ``repro_torch/`` and the tests and patches the port's ``Catalog``.
A port test file imports it by name to use it in place of the shared
fixture, which traces the JAX package::

    from torch_locktrace import lock_tracer  # noqa: F401
"""
import pytest

from repro_torch.testing.locktrace import LockTracer


@pytest.fixture
def lock_tracer():
    """Traces every port lock allocated while active; teardown fails the
    test on an acquisition-order cycle or on blocking I/O under the
    scheduler lock."""
    tracer = LockTracer()
    tracer.install()
    try:
        yield tracer
    finally:
        tracer.uninstall()
    tracer.check()
