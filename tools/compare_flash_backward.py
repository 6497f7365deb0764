#!/usr/bin/env python3
"""Check and time the flash-attention backward's tensor-core route of
several checkouts of this repository on one NVIDIA card, in turns.

    python3 tools/compare_flash_backward.py [--only LABEL,...] TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an unpacked
``git archive`` of another commit beside it).  For each tree, in the
order given, a fresh process imports that tree's ``repro_torch``, builds
its ``csrc/flash_attention_bwd.cu`` (into the tree's gitignored
``build/``) and reports, as one JSON line:

- ``ptxas``: each tensor-core backward kernel's registers and spill
  bytes (``-Xptxas -v``), and every note of ptxas that serialises a
  kernel's wgmma (by the kernel it names);
- ``checks``: at CHECKS, ``kernels.flash_attention.backward`` on the
  tensor-core route against autograd through the plain
  ``flash_attention_ref`` (TOL, the bf16 tolerance of the card tests
  and of chip_smoke.py), with the largest error of dq, dk and dv, and
  whether two runs give the same bits;
- ``times``: at TIMES, the route's device time by kernel in
  ``torch.profiler`` (REPS calls, each after an L2 flush), and the
  median of CUDA events around the same calls.  A row that names
  ``one_grid`` (the dK / dV and dQ CTAs in one grid, or the separate
  launches) times that launch where the tree's ``backward`` takes the
  word, and reports ``"skipped"`` where it does not.

Then the card's name and power limit.  Give the trees as parent, change,
change, parent to see the spread beside the difference.  ``--only``
keeps those labels of CHECKS and TIMES alone (for example ``--only
mla_smoke,mla_smoke_gqa`` for the (24, 16) pair).  A tree that
does not build or run gets a line with its error, and the rest go on.
Exits 1 if a check or a tree fails, 2 without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

#: (label, (B, Sq, Sk, H, Hkv, hd, hdv), causal, window)
CHECKS = [
    ("mla_ragged", (2, 130, 130, 4, 4, 192, 128), True, 0),
    ("mla_cross", (1, 100, 160, 2, 2, 192, 128), False, 0),
    ("mla_160", (1, 160, 160, 4, 2, 192, 128), True, 0),
    ("mla_window", (1, 200, 200, 4, 2, 192, 128), True, 48),
    ("rg_ragged", (2, 130, 130, 4, 1, 256, 256), True, 0),
    ("rg_cross", (1, 100, 160, 4, 4, 256, 256), False, 0),
    ("rg_160_g4", (1, 160, 160, 8, 2, 256, 256), True, 0),
    ("rg_window", (1, 300, 300, 16, 1, 256, 256), True, 80),
    ("hd128", (1, 256, 256, 12, 2, 128, 128), True, 0),
    # DeepSeek-V2-Lite's smoke pair: the one-launch kernel up to 256
    # queries and keys (with GQA, a window), three kernels past it
    ("mla_smoke", (2, 256, 256, 4, 4, 24, 16), True, 0),
    ("mla_smoke_gqa", (1, 256, 256, 8, 2, 24, 16), True, 70),
    ("mla_smoke_257", (2, 257, 257, 4, 4, 24, 16), True, 0),
    # hd 64 with H == Hkv (the one-grid launch): ragged, Sq != Sk, one
    # key tile, whisper's causal decoder
    ("hd64_ragged", (1, 200, 333, 2, 2, 64, 64), False, 0),
    ("whisper_cross_small", (2, 448, 1500, 2, 2, 64, 64), False, 0),
    ("hd64_one_block", (2, 65, 64, 3, 3, 64, 64), False, 0),
    ("whisper_dec_small", (2, 448, 448, 2, 2, 64, 64), True, 0),
]
#: (label, (B, S, S, H, Hkv, hd, hdv), causal, window[, one_grid]): the
#: training phases' attention (chip_smoke.py BWD_CASES); one_grid names
#: the launch where the plan would take the other
TIMES = [
    ("mla_train", (2, 2048, 2048, 16, 16, 192, 128), True, 0),
    ("rg_train", (1, 3072, 3072, 16, 1, 256, 256), True, 2048),
    ("train", (2, 1024, 1024, 12, 2, 128, 128), True, 0),
    ("mla_smoke", (2, 256, 256, 4, 4, 24, 16), True, 0),
    # whisper-tiny's training step (train_whisper): the encoder, the
    # decoder's self-attention (causal) and its cross-attention
    ("whisper_train", (8, 1500, 1500, 6, 6, 64, 64), False, 0),
    ("whisper_dec_self", (8, 448, 448, 6, 6, 64, 64), True, 0),
    ("whisper_dec_cross", (8, 448, 1500, 6, 6, 64, 64), False, 0),
    # the same three on the separate launches, and the one grid at the
    # other one-warpgroup row with H == Hkv, (24, 16) past 256 keys
    ("whisper_train_separate", (8, 1500, 1500, 6, 6, 64, 64), False, 0,
     False),
    ("whisper_dec_self_separate", (8, 448, 448, 6, 6, 64, 64), True, 0,
     False),
    ("whisper_dec_cross_separate", (8, 448, 1500, 6, 6, 64, 64), False, 0,
     False),
    ("mla_smoke_257", (2, 257, 257, 4, 4, 24, 16), True, 0),
    ("mla_smoke_257_one_grid", (2, 257, 257, 4, 4, 24, 16), True, 0, True),
]
TOL = {"rtol": 2e-2, "atol": 2e-2}
REPS = 20

_CHILD = r"""
import inspect, json, re, statistics, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

CHECKS, TIMES, TOL, REPS = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
# 1 GiB: its fill outlasts the wrapper's host time, so the events time
# the launch-bound kernels' card time, not the host (chip_smoke.py Timer)
flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
fa.BWD_LIBRARY.build()
out = {"ptxas": {}, "serialised": [], "checks": {}, "times": {}}
with open(fa.BWD_LIBRARY.log_path()) as f:
    log = f.read()
for name, body in re.findall(
        r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)", log,
        re.S):
    if "tc_kernel" in name:
        regs = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          body)
        out["ptxas"][name] = [int(regs.group(1)) if regs else None,
                              int(spill.group(1)) if spill else None,
                              int(spill.group(2)) if spill else None]
out["serialised"] = [ln.strip() for ln in log.splitlines()
                     if "Potential Performance Loss" in ln]
g = torch.Generator(device=dev).manual_seed(0)


def inputs(b, sq, sk, h, hkv, hd, hdv):
    def rand(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = rand(b, sq, h, hd), rand(b, sk, hkv, hd), rand(b, sk, hkv, hdv)
    return q, k, v, rand(b, sq, h, hdv)


ok = True
for label, (b, sq, sk, h, hkv, hd, hdv), causal, window in CHECKS:
    q, k, v, do = inputs(b, sq, sk, h, hkv, hd, hdv)
    o, lse = fa._forward(q, k, v, causal, window, 0, "tc", with_lse=True)
    got = fa.backward(do, q, k, v, o, lse, causal, window, route="tc")
    again = fa.backward(do, q, k, v, o, lse, causal, window, route="tc")
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(
        ref.flash_attention_ref(*qkv, causal, window, 0), qkv, do)
    torch.cuda.synchronize()
    row = {"equal_bits": all(torch.equal(x.view(torch.int16),
                                         y.view(torch.int16))
                             for x, y in zip(got, again))}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        row[name] = [float((a.float() - w.float()).abs().max()),
                     bool(torch.allclose(a.float(), w.float(), **TOL))]
    ok &= row["equal_bits"] and all(row[n][1] for n in ("dq", "dk", "dv"))
    out["checks"][label] = row

takes = "one_grid" in inspect.signature(fa.backward).parameters
for label, (b, sq, sk, h, hkv, hd, hdv), causal, window, *named in TIMES:
    if named and not takes:
        out["times"][label] = "skipped"
        continue
    kw = {"one_grid": named[0]} if named else {}
    q, k, v, do = inputs(b, sq, sk, h, hkv, hd, hdv)
    o, lse = fa._forward(q, k, v, causal, window, 0, "tc", with_lse=True)

    def fn():
        return fa.backward(do, q, k, v, o, lse, causal, window, route="tc",
                           **kw)

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
    by = {}
    for e in prof.key_averages():
        if "fa_bwd" in e.key:
            us = (getattr(e, "self_device_time_total", 0)
                  or getattr(e, "self_cuda_time_total", 0))
            kind = re.search(r"fa_bwd_\w+_kernel", e.key).group(0)
            by[kind] = by.get(kind, 0.0) + us / 1e3 / REPS
    out["times"][label] = {
        "device_ms": sum(by.values()), "by_kernel": by,
        "event_ms": statistics.median(a.elapsed_time(b) for a, b in events)}
out["ok"] = ok
print(json.dumps(out))
"""


def run_tree(tree: str, checks=CHECKS, times=TIMES) -> dict:
    """One tree's line: build, ptxas, checks and times in a fresh process
    (``{"tree", "ok": False, "error"}`` where it does not build or run)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(tree),
                                                   "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, json.dumps([checks, times, TOL, REPS])],
        env=env, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        return {"tree": tree, "ok": False, "error": proc.stderr[-2000:]}
    return {"tree": tree, **json.loads(proc.stdout.strip().splitlines()[-1])}


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                           "power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True,
                          check=True).stdout.strip()


def main() -> int:
    args = sys.argv[1:]
    checks, times = CHECKS, TIMES
    if args[:1] == ["--only"] and len(args) > 1:
        labels = args[1].split(",")
        checks = [c for c in CHECKS if c[0] in labels]
        times = [c for c in TIMES if c[0] in labels]
        args = args[2:]
    trees = args
    if not trees or not (checks or times):
        print(__doc__, file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("compare_flash_backward: no CUDA device", file=sys.stderr)
        return 2
    ok = True
    for tree in trees:
        row = run_tree(tree, checks, times)
        ok &= row["ok"]
        print(json.dumps(row), flush=True)
    print(card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
