"""mergelint — repo-specific static analysis for MergePipe.

The system's headline claims (transactional materialization,
budget-enforced expert I/O, crash-safe resume) rest on hand-maintained
conventions scattered across ~10 threaded modules: "this dict is guarded
by ``_lock``", "every expert byte lands in an IOStats category", "fsync
before rename", "``SimulatedCrash`` must stay invisible to abort paths".
This package machine-checks those conventions with four AST passes:

* :mod:`repro_torch.analysis.guarded` — ``# guarded-by: <lock>`` field
  discipline (every access under ``with self.<lock>``);
* :mod:`repro_torch.analysis.accounting` — IOStats accounting completeness
  for ``read_range`` / ``pread`` / ``get_range`` call sites;
* :mod:`repro_torch.analysis.exceptions` — exception discipline (no broad
  handler may swallow ``MergeCancelled`` / ``SimulatedCrash`` silently);
* :mod:`repro_torch.analysis.durability` — fsync-before-rename plus
  ``chaos.CRASH_POINTS`` registry/call-site drift.

Run ``python -m repro_torch.analysis`` from the repo root (see
docs/ANALYSIS.md).  The runtime companion is
:mod:`repro_torch.testing.locktrace`, a lock-order tracer used by the test
suite to catch potential deadlocks dynamically.
"""
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.runner import ALL_PASSES, run_paths, run_repo

__all__ = ["Finding", "ALL_PASSES", "run_paths", "run_repo"]
