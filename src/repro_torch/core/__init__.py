"""MergePipe core, ported: blocks, catalog, ANALYZE, planner, executor,
transactions, lineage, the naive full-read baseline and the
:class:`MergePipe` facade."""
from repro_torch.core.blocks import DEFAULT_BLOCK_SIZE, BlockId

__all__ = [
    "MergePipe",
    "MergePlan",
    "MergeResult",
    "BlockId",
    "DEFAULT_BLOCK_SIZE",
    "plan_merge",
    "execute_merge",
    "naive_merge",
]

# Lazy exports: the storage layer imports repro_torch.core.blocks, and the
# rest of core imports the storage layer — eager re-exports here would
# close an import cycle.
_LAZY = {
    "MergePipe": ("repro_torch.core.api", "MergePipe"),
    "MergePlan": ("repro_torch.core.plan", "MergePlan"),
    "MergeResult": ("repro_torch.core.executor", "MergeResult"),
    "plan_merge": ("repro_torch.core.planner", "plan_merge"),
    "execute_merge": ("repro_torch.core.executor", "execute_merge"),
    "naive_merge": ("repro_torch.core.naive", "naive_merge"),
}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch.core' has no attribute {name!r}")
