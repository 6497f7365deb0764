#!/usr/bin/env python3
"""Time the flash-attention forward kernels of several checkouts of this
repository on one NVIDIA card, in turns.

    python3 tools/compare_flash_forward.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an unpacked
``git archive`` of another commit beside it).  For each tree, in the
order given, a fresh process imports that tree's ``repro_torch``, builds
its ``csrc/flash_attention.cu`` (into the tree's gitignored ``build/``)
and times ``kernels.flash_attention.launch`` (the serving forward,
``lse`` not written) at CASES, by device time in ``torch.profiler``
(REPS launches, each after an L2 flush) and by CUDA events around the
same launches.  Where the tree's wrapper has ``_forward`` (the training
forward, which writes ``lse``), that is timed too.  One JSON line per
tree, then the card's name and power limit.  Give the trees as parent,
change, change, parent to see the spread beside the difference.

Exits 2 without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

#: (label, (B, Sq, Sk, H, Hkv, hd), dtype, causal, window, route)
CASES = [
    ("prefill", (1, 2048, 2048, 12, 2, 128), "bfloat16", True, 0, "tc"),
    ("train", (2, 1024, 1024, 12, 2, 128), "bfloat16", True, 0, "tc"),
    ("train_window", (2, 1024, 1024, 12, 2, 128), "bfloat16", True, 256, "tc"),
    ("prefill_fma", (1, 2048, 2048, 12, 2, 128), "bfloat16", True, 0, "fma"),
    ("f32_hd8", (1, 512, 512, 4, 2, 8), "float32", True, 0, "fma"),
    ("f32_hd16", (1, 512, 512, 4, 2, 16), "float32", True, 0, "fma"),
]
REPS = 20

_CHILD = r"""
import json, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa

CASES, REPS = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda", 0)
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
fa.LIBRARY.build()
g = torch.Generator(device=dev).manual_seed(0)


def timed(fn):
    # warm up, then REPS launches, each after an L2 flush: device time of
    # the flash kernels (profiler) and CUDA-event time per launch
    for _ in range(3):
        fn()
    events = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            events.append((e0, e1))
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if "flash_attention" in e.key)
    return {"device_ms": us / 1e3 / REPS,
            "event_ms": statistics.median(a.elapsed_time(b)
                                          for a, b in events)}


out = {}
for label, (b, sq, sk, h, hkv, hd), dt, causal, window, route in CASES:
    dtype = getattr(torch, dt)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, hd), generator=g, device=dev).to(dtype)
    row = {"launch": timed(lambda: fa.launch(q, k, v, causal, window, 0,
                                             route))}
    if hasattr(fa, "_forward"):
        row["forward_lse"] = timed(lambda: fa._forward(
            q, k, v, causal, window, 0, route, with_lse=True))
    out[label] = row
print(json.dumps(out))
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("compare_flash_forward: no CUDA device", file=sys.stderr)
        return 2
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(tree),
                                                       "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, json.dumps(CASES), str(REPS)],
            env=env, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        print(json.dumps({"tree": tree, **json.loads(
            proc.stdout.strip().splitlines()[-1])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
