"""Kernels for NVIDIA Hopper.

    build.py            — nvcc builder and loader of ``csrc/*.cu``
    merge_block.py      — wrappers of the CUDA kernels in
                          ``csrc/merge_block.cu`` (AVG/TA, TIES, DARE)
    flash_attention.py  — wrapper of ``csrc/flash_attention.cu``
    ops.py              — merge_blocks: staging, TIES thresholds, dispatch
    ref.py              — plain PyTorch versions (CPU path and oracle)
"""
