#!/usr/bin/env python3
"""Run the smoke's training phase (full Qwen2-1.5B, 28 layers, batch 4 x
1,024, bf16 compute, remat) for several checkouts of this repository on
one NVIDIA card, in turns.

    python3 tools/compare_train_step.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an unpacked
``git archive`` of another commit beside it, in the gitignored
``build/``).  For each tree, in the order given, a fresh process puts
that tree's ``src`` and root first on ``sys.path``, builds its
``csrc/flash_attention.cu`` and runs its ``chip_smoke.phase_train``:
the first step's parity against the plain attention, then 1 + 5 timed
steps and one profiled step.  One JSON line per tree with the phase's
step times, tokens/s, MFU, peak memory, launches and device time (the
flash backward's by kernel where the tree reports it); then the card's
name and power limit.  Give the trees as parent, change, change, parent
to see the spread beside the difference: the step's host part varies
between calls.

Exits 2 without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, os, sys
tree = sys.argv[1]
sys.path[:0] = [os.path.join(tree, "src"), tree]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch
import chip_smoke
from repro_torch.kernels import flash_attention as fa
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
fa.LIBRARY.build()
lines = []
chip_smoke.emit = lines.append
chip_smoke.phase_train(torch.device("cuda", 0), 0)
keep = ("median_step_ms", "step_walls_s", "tokens_per_s", "mfu", "hfu",
        "peak_memory_gb", "launches", "profiled_step_s", "device_busy_ms",
        "device_idle_share", "flash_forward_ms", "flash_backward_ms",
        "flash_backward_by_kernel_ms", "gemm_ms", "parity")
print(json.dumps({"tree": tree, **{k: lines[-1][k] for k in keep
                                   if k in lines[-1]}}), flush=True)
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("compare_train_step: no CUDA device", file=sys.stderr)
        return 2
    for tree in trees:
        proc = subprocess.run([sys.executable, "-c", _CHILD,
                               os.path.abspath(tree)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
