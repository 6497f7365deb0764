"""repro_torch — MergePipe on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``repro``, which stays the reference.  This
package imports nothing from it: host-only layers (catalog, planner,
store, journal, transactions, configs) are copies, and every Pallas
kernel on a ported path is a CUDA kernel written for ``sm_90a``
(``csrc/``).

    core/      ANALYZE, planner, executor, MergePipe facade
    store/     block-granular tensor files, snapshots, journal, I/O stats,
               flat named tensors of a model (checkpoint)
    kernels/   Hopper merge and flash-attention kernels, their plain
               versions, merge_blocks, the nvcc builder
    configs/   model configurations (copies)
    models/    dense GQA DecoderLM, attention, layers, build_model
    serve/     ServeEngine
    testing/   chaos crash points
    api/       typed budgets
"""
