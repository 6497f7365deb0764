#!/usr/bin/env python3
"""Ablate the fused TIES kernel on one NVIDIA card: where does its time go?

    python3 tools/ablate_ties_fused.py            # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/merge_block.cu``, each the
committed source with one part of ``ties_fused_kernel`` switched off or
changed by a text substitution (VARIANTS below), into ``build/ablate/``
(gitignored), all at once.  Then, per shape, it times every variant's
``ties_fused_kernel`` and the pair (``ties_threshold_kernel`` +
``ties_kernel``) by their device time in ``torch.profiler``, L2 flushed
before each launch, and prints one JSON line per shape.  Only the
unchanged source ("base") computes TIES; the others are timings of
partial work, so only "base" is checked against the plain version.

Exits 2 without a card, 1 if a variant does not build or "base"
disagrees with its plain version.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "src", "repro_torch", "csrc", "merge_block.cu")
OUT_DIR = os.path.join(HERE, "build", "ablate")
SHAPES = [(5, 3, 65536), (1, 4, 65536), (13, 2, 65536), (32, 4, 65536)]
TRIM = 0.3
REPS = 20

_SELECT = ("const bool select = keep < W;", "const bool select = false;")
_APPLY = ("for (int i = tid; i < n4; i += kFusedThreads) {\n    float xv[4], o[4];",
          "for (int i = tid; i < 0; i += kFusedThreads) {\n    float xv[4], o[4];")
#: name -> (what it measures, text substitutions on the source)
VARIANTS = {
    "base": ("the committed kernel", []),
    "stage_only": ("bulk-copy staging and the launch: no select, no apply",
                   [_SELECT, _APPLY]),
    "no_select": ("staging and the apply (threshold -inf)", [_SELECT]),
    "pass1_only": ("one radix pass instead of four",
                   [("for (int pass = 0; pass < 4; ++pass) {",
                     "for (int pass = 0; pass < 1; ++pass) {")]),
    "no_histogram": ("four rounds without the local histogram loops (so "
                     "nothing to sum either)",
                     [("for (int base = 0; base < n4; base += kFusedThreads) {",
                       "for (int base = 0; base < 0; base += kFusedThreads) {")]),
    "no_scan": ("four rounds without the scans of the cluster histograms",
                [("for (int k = warp; k < K; k += kFusedWarps) {",
                  "for (int k = warp; k < 0; k += kFusedWarps) {")]),
    "no_cluster_barrier": ("the per-pass cluster barrier replaced by a CTA "
                           "barrier",
                           [("      cluster.sync();\n      for (int k = warp",
                             "      __syncthreads();\n      for (int k = warp")]),
    "one_owner": ("every cluster histogram summed at CTA 0",
                  [("__device__ __forceinline__ int group_owner(int g, int C) "
                    "{ return (g * C) >> 5; }",
                    "__device__ __forceinline__ int group_owner(int g, int C) "
                    "{ return 0; }"),
                   ("__device__ __forceinline__ int group_first(int c, int C) "
                    "{ return (32 * c + C - 1) / C; }",
                    "__device__ __forceinline__ int group_first(int c, int C) "
                    "{ return 0; }"),
                   ("static int groups_per_cta(int c) { return (32 + c - 1) / c; }",
                    "static int groups_per_cta(int c) { return 32; }")]),
    "threads_512x2": ("512-thread CTAs, two an SM",
                      [("constexpr int kFusedThreads = 384;",
                        "constexpr int kFusedThreads = 512;"),
                       ("__launch_bounds__(kFusedThreads, 3)",
                        "__launch_bounds__(kFusedThreads, 2)")]),
}


def build(name, text):
    """Compile one variant; returns its library path."""
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc

    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    cu, so = os.path.join(OUT_DIR, f"{name}.cu"), os.path.join(OUT_DIR, f"{name}.so")
    with open(cu, "w") as f:
        f.write(text)
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"variant {name}: nvcc failed:\n{proc.stderr[-2000:]}")
    return so


def device_ms(fn, flush):
    """Mean device time per call of the kernels ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if "ties_" in e.key:
            us = getattr(e, "self_device_time_total", None)
            total += us if us is not None else e.self_cuda_time_total
    return total / REPS / 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_ties_fused: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(),
          flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(SOURCE) as f:
        text = f.read()
    with ThreadPoolExecutor(len(VARIANTS)) as ex:  # one nvcc per variant
        paths = dict(zip(VARIANTS, ex.map(lambda n: build(n, text), VARIANTS)))
    libs = {}
    for name, path in paths.items():
        lib = ctypes.CDLL(path)
        mb._declare(lib)
        libs[name] = lib
    print(json.dumps({"variants": {n: v[0] for n, v in VARIANTS.items()}}),
          flush=True)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    for nb, k, w in SHAPES:
        x0 = torch.randn((nb, w), generator=g, device=dev)
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=dev)
        out = torch.empty_like(x0)
        keep = ref.ties_keep(TRIM, w)
        row = {"shape": [nb, k, w], "ties_route": mb.ties_route(nb, k, w),
               "ms": {}}
        for name, lib in libs.items():
            def fn(lib=lib):
                rc = lib.mb_ties_fused(
                    x0.data_ptr(), D.data_ptr(), out.data_ptr(), None, nb, k,
                    w, keep, 1.0,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA status {rc}")

            fn()
            if name == "base":
                want = ref.ties_ref(x0, D, TRIM, 1.0)
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                    print(f"base disagrees with its plain version at "
                          f"{(nb, k, w)}", file=sys.stderr)
                    return 1
            row["ms"][name] = device_ms(fn, flush)
        row["ms"]["pair"] = device_ms(
            lambda: mb.ties_merge(x0, D, mb.ties_thresholds(D, TRIM), 1.0),
            flush)
        print(json.dumps(row), flush=True)
        del x0, D, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
