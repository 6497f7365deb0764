"""Kernels for NVIDIA Hopper.

    build.py            — nvcc builder and loader of ``csrc/*.cu``
    merge_block.py      — wrappers of the CUDA kernels in
                          ``csrc/merge_block.cu`` (AVG/TA, TIES fused
                          and pair, DARE, sketch) and the TIES route
    flash_attention.py  — wrapper of ``csrc/flash_attention.cu`` (forward)
                          and ``csrc/flash_attention_bwd.cu`` (backward)
    ops.py              — merge_blocks: staging, TIES route, dispatch
    ref.py              — plain PyTorch versions (CPU path and oracle)
"""
