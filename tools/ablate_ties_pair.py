#!/usr/bin/env python3
"""Ablate the TIES pair route's threshold on one NVIDIA card: where does
its time go?

    python3 tools/ablate_ties_pair.py            # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/merge_block.cu``, each the
committed source changed by text substitutions (VARIANTS below), into
``build/ablate_pair/`` (gitignored), all at once: "base" as committed
(the shape picks the threshold's kernels), "sliced" and "row" with the
choice forced (the sliced kernels at every shape; one CTA a row wherever
W <= 131,072), and, on the sliced kernels, one part of a pass (or of the
apply) switched off or changed.  Then, per shape, it times every
variant's threshold launch (each library's own plan) and its apply
kernel (given torch.kthvalue thresholds) by device time in
``torch.profiler``, kernel by kernel, L2 flushed before each call, and
prints one JSON line per shape.  The variants in EXACT compute the
threshold and are checked against ``torch.kthvalue``; the others time
partial work.

Exits 2 without a card, 1 if a variant does not build or one in EXACT
disagrees with its plain version.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(HERE, "src", "repro_torch", "csrc", "merge_block.cu")
OUT_DIR = os.path.join(HERE, "build", "ablate_pair")
SHAPES = [(32, 4, 65536), (1, 4, 1 << 20), (5, 3, 65536), (4, 16, 65536),
          (32, 2, 32768)]
TRIM = 0.3
REPS = 20
#: variants that still compute the threshold, checked against kthvalue
EXACT = ("base", "sliced", "row", "no_hints", "unroll8", "ctas528",
         "apply_v4_whole", "apply_tile_double", "apply_tile_half")
_ROW_MIN = "constexpr long long kSelRowMinRows = 16;"
#: the sliced kernels at every shape
SLICED = [(_ROW_MIN, "constexpr long long kSelRowMinRows = 1LL << 62;")]

#: name -> (what it measures, text substitutions on the source)
VARIANTS = {
    "base": ("the committed kernels", []),
    "sliced": ("the sliced kernels at every shape", SLICED),
    "row": ("one CTA a row wherever W <= 131,072",
            [(_ROW_MIN, "constexpr long long kSelRowMinRows = 1;")]),
    "no_hints": ("sliced; plain loads: no L2 eviction-priority hints",
                 SLICED + [("for_keys<kKeep>(", "for_keys<kPlain>("),
                           ("for_keys<kLast>(", "for_keys<kPlain>(")]),
    "unroll8": ("sliced; eight 16-byte loads a thread in flight, not four",
                SLICED + [("constexpr int kSelUnroll = 4;",
                           "constexpr int kSelUnroll = 8;")]),
    "ctas528": ("sliced; slices for about 528 CTAs a pass, not 264",
                SLICED + [("constexpr long long kSelTargetCtas = 264;",
                           "constexpr long long kSelTargetCtas = 528;")]),
    "apply_v4_whole": ("the apply's 16-byte shared loads only from tiles of "
                       "1,024 columns or more (every thread busy)",
                       [("if (apply_tile(k) >= 2 * kApplyThreads)",
                         "if (apply_tile(k) >= 4 * kApplyThreads)")]),
    "apply_tile_double": ("the apply's tiles doubled (K T <= 12,288 floats)",
                          [("constexpr long long kApplyStageFloats = 6144;",
                            "constexpr long long kApplyStageFloats = 12288;")]),
    "apply_tile_half": ("the apply's tiles halved (K T <= 3,072 floats)",
                        [("constexpr long long kApplyStageFloats = 6144;",
                          "constexpr long long kApplyStageFloats = 3072;")]),
    "p2_load_only": ("sliced; pass 2 reads its slice, no filter, no append",
                     SLICED + [("if (!__any_sync(0xffffffffu, any)) return;",
                       """{
      unsigned a = 0;
      for (int e = 0; e < kSelKeys; ++e) a |= u[e];
      if (a == 0x7FFFFFFFu && in[0]) stage[0] = a;
      return;
    }""")]),
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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("ablate_ties_pair: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import device_time_ms
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
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for nb, k, w in SHAPES:
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=dev)
        keep = ref.ties_keep(TRIM, w)
        out = torch.empty((nb, k), device=dev)
        x0 = torch.randn((nb, w), generator=g, device=dev)
        res = torch.empty_like(x0)
        want = ref.ties_thresholds(D, TRIM)
        plain = ref.ties_apply_ref(x0, D, want, 1.0)
        row = {"shape": [nb, k, w], "plans": {}, "ms": {}}
        for name, lib in libs.items():
            plan = (ctypes.c_longlong * 7)()
            if lib.mb_ties_threshold_plan(nb * k, w, plan) != 0:
                raise RuntimeError(f"{name}: no plan for {(nb, k, w)}")
            row["plans"][name] = {"row": bool(plan[6]), "ctas": plan[2],
                                  "scratch": plan[4]}
            scratch = torch.empty(max(plan[4], 16) // 4, dtype=torch.int32,
                                  device=dev)

            def fn(lib=lib, scratch=scratch, nbytes=plan[4]):
                rc = lib.mb_ties_threshold(
                    D.data_ptr(), out.data_ptr(), scratch.data_ptr(), nbytes,
                    nb * k, w, keep,
                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc != 0:
                    raise RuntimeError(f"{name}: CUDA status {rc}")

            fn()
            if name in EXACT:
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32), want.view(torch.int32)):
                    print(f"{name} disagrees with kthvalue at {(nb, k, w)}",
                          file=sys.stderr)
                    return 1
            for _ in range(3):
                fn()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    flush.zero_()
                    fn()
                torch.cuda.synchronize()
            row["ms"][name] = {
                re.search(r"ties_\w+", n).group(0): t / REPS
                for n, t in device_time_ms(prof).items() if "ties" in n}

            def apply(lib=lib):
                rc = lib.mb_ties(x0.data_ptr(), D.data_ptr(), want.data_ptr(),
                                 res.data_ptr(), nb, k, w, 1.0,
                                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if rc != 0:
                    raise RuntimeError(f"{name} apply: CUDA status {rc}")

            apply()
            if name in EXACT:
                torch.cuda.synchronize()
                if not torch.equal(res.view(torch.int32), plain.view(torch.int32)):
                    print(f"{name}: the apply disagrees at {(nb, k, w)}",
                          file=sys.stderr)
                    return 1
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    flush.zero_()
                    apply()
                torch.cuda.synchronize()
            row["ms"][name]["ties_kernel (apply)"] = sum(
                t for n, t in device_time_ms(prof).items()
                if re.search(r"\bties_kernel\b", n)) / REPS
        print(json.dumps(row), flush=True)
        del D, out, scratch, x0, res, plain
    return 0


if __name__ == "__main__":
    sys.exit(main())
