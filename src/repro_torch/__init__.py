"""repro_torch — MergePipe on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro``, which stays the reference.  This
package imports nothing from it: host-only layers (catalog, planner,
store, journal, transactions) are copies, and every Pallas kernel on the
merge path is a CUDA kernel written for ``sm_90a`` (``csrc/``).

    core/      ANALYZE, planner, executor, MergePipe facade
    store/     block-granular tensor files, snapshots, journal, I/O stats
    kernels/   Hopper merge kernels, their plain versions, merge_blocks
    testing/   chaos crash points
    api/       typed budgets
"""
