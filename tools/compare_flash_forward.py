#!/usr/bin/env python3
"""Time the flash-attention forward kernels of several checkouts of this
repository on one NVIDIA card, in turns.

    python3 tools/compare_flash_forward.py [--only LABEL,...] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an unpacked
``git archive`` of another commit beside it).  For each tree, in the
order given, a fresh process imports that tree's ``repro_torch``, builds
its ``csrc/flash_attention.cu`` (into the tree's gitignored ``build/``)
and times ``kernels.flash_attention.launch`` (the serving forward,
``lse`` not written) at CASES, by device time in ``torch.profiler``
(REPS launches, each after an L2 flush) and by CUDA events around the
same launches.  Where the tree's wrapper has ``_forward`` (the training
forward, which writes ``lse``), that is timed too, and each case's
output is held against the tree's plain version (``max_abs_err``, bf16
tolerance 2e-2).  The profile's kernel names are listed per case
(``kernels``), so a tree's layout shows beside its time.  One JSON line
per tree, then the card's name and power limit.  Give the trees as
parent, change, change, parent to see the spread beside the difference.
``--only`` times those CASES alone (for example ``--only mla_smoke`` for
the (24, 16) pair's launch-bound shape).

Exits 2 without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

#: (label, (B, Sq, Sk, H, Hkv, hd, hdv), dtype, causal, window, route); the
#: "mla" and "rg" rows are DeepSeek-V2-Lite's (192, 128) and
#: RecurrentGemma-9B's (256, 256) forwards at the smoke's prefill
#: (FA_CASES) and training (train_mla, train_griffin) shapes
CASES = [
    ("prefill", (1, 2048, 2048, 12, 2, 128, 128), "bfloat16", True, 0, "tc"),
    ("train", (2, 1024, 1024, 12, 2, 128, 128), "bfloat16", True, 0, "tc"),
    ("train_window", (2, 1024, 1024, 12, 2, 128, 128), "bfloat16", True, 256,
     "tc"),
    ("prefill_fma", (1, 2048, 2048, 12, 2, 128, 128), "bfloat16", True, 0,
     "fma"),
    ("f32_hd8", (1, 512, 512, 4, 2, 8, 8), "float32", True, 0, "fma"),
    ("f32_hd16", (1, 512, 512, 4, 2, 16, 16), "float32", True, 0, "fma"),
    ("mla_prefill", (1, 2048, 2048, 16, 16, 192, 128), "bfloat16", True, 0,
     "tc"),
    ("mla_train", (2, 2048, 2048, 16, 16, 192, 128), "bfloat16", True, 0,
     "tc"),
    ("rg_prefill", (1, 3072, 3072, 16, 1, 256, 256), "bfloat16", True, 2048,
     "tc"),
    # DeepSeek-V2-Lite's smoke pair at chip_smoke.py's mla_smoke shape, bf16
    # (the narrow CTA up to 256 keys) and float32 (the FMA kernel)
    ("mla_smoke", (2, 256, 256, 4, 4, 24, 16), "bfloat16", True, 0, "tc"),
    ("mla_smoke_f32", (2, 256, 256, 4, 4, 24, 16), "float32", True, 0,
     "fma"),
    # whisper-tiny's serving encoder (the warp-specialised CTA split over
    # a cluster); Llama-3.2-Vision's cross-attention at its longest and
    # shortest prompts and whisper's training encoder, which stay on the
    # one-warpgroup kernel
    ("whisper_encoder", (1, 1500, 1500, 6, 6, 64, 64), "bfloat16", False, 0,
     "tc"),
    ("vlm_cross", (1, 2048, 1024, 64, 8, 128, 128), "bfloat16", False, 0,
     "tc"),
    ("vlm_cross_768", (1, 768, 1024, 64, 8, 128, 128), "bfloat16", False, 0,
     "tc"),
    ("whisper_train_fwd", (8, 1500, 1500, 6, 6, 64, 64), "bfloat16", False,
     0, "tc"),
]
REPS = 20

_CHILD = r"""
import json, re, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

CASES, REPS = json.loads(sys.argv[1]), int(sys.argv[2])
dev = torch.device("cuda", 0)
# 1 GiB: its fill outlasts the wrapper's host time, so the events time
# the launch-bound kernels' card time, not the host (chip_smoke.py Timer)
flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
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
    names = [e.key for e in prof.key_averages()
             if "flash_attention" in e.key]
    us = sum(getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if "flash_attention" in e.key)
    return {"device_ms": us / 1e3 / REPS,
            "event_ms": statistics.median(a.elapsed_time(b)
                                          for a, b in events),
            "kernels": sorted({m.group(0) for n in names for m in
                               [re.search(r"flash_attention_\w*kernel", n)]
                               if m})}


out = {}
for label, (b, sq, sk, h, hkv, hd, hdv), dt, causal, window, route in CASES:
    dtype = getattr(torch, dt)
    q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, hkv, hdv), generator=g, device=dev).to(dtype)
    row = {"launch": timed(lambda: fa.launch(q, k, v, causal, window, 0,
                                             route))}
    if hasattr(fa, "_forward"):
        row["forward_lse"] = timed(lambda: fa._forward(
            q, k, v, causal, window, 0, route, with_lse=True))
        got = fa.launch(q, k, v, causal, window, 0, route).float()
        want = ref.flash_attention_ref(q, k, v, causal, window, 0,
                                       skip_masked_chunks=True).float()
        row["max_abs_err"] = float((got - want).abs().max())
        tol = 2e-2 if dt == "bfloat16" else 2e-5
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise SystemExit(f"{label}: the kernel disagrees with the plain "
                             f"version, max abs err {row['max_abs_err']}")
        del got, want
    out[label] = row
    del q, k, v
print(json.dumps(out))
"""


def main() -> int:
    args = sys.argv[1:]
    cases = CASES
    if args[:1] == ["--only"] and len(args) > 1:
        labels = args[1].split(",")
        cases = [c for c in CASES if c[0] in labels]
        args = args[2:]
    trees = args
    if not trees or not cases:
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
            [sys.executable, "-c", _CHILD, json.dumps(cases), str(REPS)],
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
