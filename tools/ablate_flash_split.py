#!/usr/bin/env python3
"""Ablate the warp-specialised forward's split at (64, 64) on one NVIDIA
card: where does its time go?

    python3 tools/ablate_flash_split.py      # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/flash_attention.cu``
(``flash_attention_ws_kernel`` split over a cluster), each the committed
source changed by text substitutions (VARIANTS below), as copies of
``src/repro_torch`` under ``build/ablate_split/`` (gitignored), all at
once; then, in the order base, variants, base, times each variant at
whisper-tiny's serving encoder, (1, 1500, 1500, 6, 6) bf16 without a
mask, as routed (a split over 3 CTAs) and split over 2 and 4
(``_split`` forced), by the kernel's mean device time
(``torch.profiler``, REPS calls, each after a 1 GiB L2 flush).  A variant
that leaves a part of the work out computes a wrong result by design;
only its time is read.  One JSON line a variant, then the card's name
and power limit.  Exits 2 without a card, 1 if a variant does not build
or run.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(HERE, "src", "repro_torch")
OUT_DIR = os.path.join(HERE, "build", "ablate_split")
FWD = "flash_attention.cu"

#: name -> (source, [(old, new, count)])
VARIANTS = {
    "fwd_base": (FWD, []),
    # S_j and P_{j-1}.V_{j-1} issued as one group, as past hd 128
    "fwd_one_group": (FWD, [("      if constexpr (WARP_PRODUCER) {\n"
                             "        mbar_wait(v_full",
                             "      if constexpr (false) {\n"
                             "        mbar_wait(v_full", 1)]),
    # rank 0 writes its own O, m and l: no merge of the others'
    "fwd_no_merge": (FWD, [("      for (int w = 1; w < nrank; ++w) {",
                            "      for (int w = 1; w < 1; ++w) {", 2)]),
    # the consumers issue without taking turns
    "fwd_no_turns": (FWD, [("named_sync(mine, TURN);", ";", 5)]),
}
REPS = 20

_CHILD = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa

src, reps = sys.argv[1], int(sys.argv[2])
dev = torch.device("cuda", 0)
flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
g = torch.Generator(device=dev).manual_seed(0)


def rand(*shape):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


def device_ms(f, match):
    for _ in range(3):
        f()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            f()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if match(e.key))
    return us / 1e3 / reps


out = {}
q, k, v = rand(1, 1500, 6, 64), rand(1, 1500, 6, 64), rand(1, 1500, 6, 64)
routed = fa._split
for label, force in (("whisper_encoder", None),
                     ("whisper_encoder_split2", 2),
                     ("whisper_encoder_split4", 4)):
    fa._split = routed if force is None else (lambda *a, f=force: f)
    out[label] = device_ms(
        lambda: fa.launch(q, k, v, False, 0, 0, "tc"),
        lambda n: "flash_attention_ws_kernel" in n)
print(json.dumps(out))
"""

_BUILD = r"""
from repro_torch.kernels import flash_attention as fa
fa.LIBRARY.build()
"""


def make_variant(name: str) -> str:
    """A copy of the package with ``name``'s substitutions; its root."""
    src, subs = VARIANTS[name]
    root = os.path.join(OUT_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, os.path.join(root, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(root, "src", "repro_torch", "csrc", src)
    with open(path) as f:
        text = f.read()
    for old, new, count in subs:
        if text.count(old) != count:
            raise SystemExit(f"{name}: {old[:60]!r} found "
                             f"{text.count(old)} times, want {count}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return root


def run(root: str, code: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, check=False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_split: no CUDA device", file=sys.stderr)
        return 2
    names = list(VARIANTS)
    roots = {name: make_variant(name) for name in names}
    with ThreadPoolExecutor(len(roots)) as ex:  # one nvcc a variant
        builds = dict(zip(roots, ex.map(
            lambda n: run(roots[n], _BUILD, VARIANTS[n][0]), roots)))
    bad = {n: p.stderr[-2000:] for n, p in builds.items() if p.returncode}
    if bad:
        print(json.dumps({"build_failed": bad}))
        return 1
    order = names + ["fwd_base"]
    ok = True
    for name in order:
        proc = run(roots[name], _CHILD, VARIANTS[name][0], str(REPS))
        if proc.returncode:
            ok = False
            print(json.dumps({"variant": name, "error": proc.stderr[-2000:]}))
            continue
        print(json.dumps({"variant": name, **json.loads(
            proc.stdout.strip().splitlines()[-1])}), flush=True)
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
