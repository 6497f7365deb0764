"""Merge kernels for NVIDIA Hopper.

    merge_block.py  — wrappers of the CUDA kernels in ``csrc/merge_block.cu``
                      (AVG/TA, TIES, DARE), built with nvcc on first use
    ops.py          — merge_blocks: staging, TIES thresholds, dispatch
    ref.py          — plain PyTorch versions (CPU path and oracle)
"""
