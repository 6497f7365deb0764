#!/usr/bin/env python3
"""Check and time TIES's pair route (threshold kernel, then apply kernel)
on one NVIDIA card, optionally against another tree's pair in turns.

    python3 tools/compare_ties_pair.py                 # needs one CUDA card
    python3 tools/compare_ties_pair.py --parent DIR    # DIR: another checkout

Builds ``src/repro_torch/csrc/merge_block.cu`` (and, with ``--parent``,
DIR's copy of it, whose C entry points ``mb_ties_threshold(D, out, rows,
W, keep, stream)`` and ``mb_ties(...)`` are those of the tree before the
grid-wide threshold) into ``build/`` (gitignored), both at once, and
prints each library's registers and spills (``ptxas -v``).

Checks, then times:
  * the threshold bit for bit against ``torch.kthvalue`` on |D| (NaN
    thresholds by NaN-ness: the card's kthvalue returns every NaN as
    0x7FFFFFFF, the kernel keeps the payload) on Gaussian rows, all-zero,
    all-equal and two-valued rows (the dense path), rows with ±0, ±inf and
    NaN, keep 1 and W - 1, and a storage offset, at CHECK_SHAPES;
  * the apply bit for bit against its plain version at K in APPLY_KS;
  * at TIME_SHAPES, in turns (parent, change, change, parent): median
    CUDA-event ms of each tree's threshold and apply (1 GiB written
    between calls, so L2 is cold and the events time the card, not the
    wrapper's host delay), their profiler device time, a device copy of
    the same bytes, ``torch.kthvalue`` on |D|, and the bound (bytes over
    the H100 SXM's 3.35 TB/s).

One JSON line per shape; the card's name and power limit first.  Exits 2
without a card, 1 if a check fails.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRIM = 0.3
BYTES_PER_S = 3.35e12
CHECK_SHAPES = [(1, 4, 1 << 20), (1, 1, 1 << 20), (4, 16, 65536),
                (4, 20, 65536), (5, 3, 65536), (32, 4, 65536), (3, 2, 1001)]
APPLY_KS = [1, 2, 4, 13, 16, 20, 32]
TIME_SHAPES = [(1, 4, 1 << 20), (4, 16, 65536), (32, 2, 32768),
               (32, 4, 65536), (5, 3, 65536), (16, 4, 65536), (24, 4, 65536),
               (64, 2, 32768)]


def rows_of_kinds(nb, k, w, g, device):
    """(NB, K, W) float32 deltas: Gaussian rows, with the first rows
    replaced by the edge kinds (as many as fit)."""
    import torch

    D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
    flat = D.view(nb * k, w)
    kinds = [
        lambda r: r.zero_(),                                  # all zero
        lambda r: r.fill_(0.25),                              # all equal
        lambda r: r.copy_(torch.where(torch.rand(w, generator=g, device=device)
                                      < 0.5, 0.5, -0.125)),   # two values
        lambda r: (r.__setitem__(slice(None, None, 7), float("inf")),
                   r.__setitem__(slice(3, None, 11), float("-inf")),
                   r.__setitem__(slice(5, None, 13), -0.0),
                   r.__setitem__(w // 2, float("nan"))),
        lambda r: r.view(torch.int32).__setitem__(
            slice(1, None, 97), torch.tensor(0x7FA00001, dtype=torch.int32,
                                             device=device)),  # payload NaNs
    ]
    for i, kind in enumerate(kinds[: nb * k]):
        kind(flat[i])
    return D


def same_thresholds(got, want):
    import torch

    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan)
                and torch.equal(got.view(torch.int32)[~nan],
                                want.view(torch.int32)[~nan]))


def kernel_breakdown(fn, timer, reps=20):
    """Mean device ms per call of ``fn`` by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import device_time_ms

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {n: t / reps for n, t in device_time_ms(prof).items()
            if "ties" in n}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="a checkout of the tree to compare with")
    ap.add_argument("--reps", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("compare_ties_pair: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    from chip_smoke import Timer, kernel_device_ms, ptxas_report
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import CudaLibrary

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(),
          flush=True)
    libs = {"change": mb.LIBRARY}
    if args.parent:
        def declare_parent(lib):
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.mb_ties_threshold.argtypes = [p, p, i, ll, i, p]
            lib.mb_ties.argtypes = [p, p, p, p, i, i, ll, ctypes.c_double, p]
            lib.mb_ties_threshold.restype = lib.mb_ties.restype = i

        libs["parent"] = CudaLibrary(os.path.join(
            os.path.abspath(args.parent), "src", "repro_torch", "csrc",
            "merge_block.cu"), declare_parent)
    with ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source
        list(ex.map(lambda lib: lib.build(), libs.values()))
    print(json.dumps({"ptxas": {
        name: {n: r for n, r in ptxas_report(lib.log_path()).items()
               if "ties_" in n and "fused" not in n}
        for name, lib in libs.items()}}), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def parent_thresholds(D, keep):
        nb, k, w = D.shape
        out = torch.empty((nb, k), device=dev)
        rc = libs["parent"].load().mb_ties_threshold(
            D.data_ptr(), out.data_ptr(), nb * k, w, keep, stream())
        if rc:
            raise RuntimeError(f"parent threshold: CUDA status {rc}")
        return out

    def parent_apply(x0, D, t):
        nb, k, w = D.shape
        out = torch.empty_like(x0)
        rc = libs["parent"].load().mb_ties(
            x0.data_ptr(), D.data_ptr(), t.data_ptr(), out.data_ptr(), nb, k,
            w, 1.0, stream())
        if rc:
            raise RuntimeError(f"parent apply: CUDA status {rc}")
        return out

    failures = []
    # the threshold: every kind of row, several trims, rows off 16 bytes
    for nb, k, w in CHECK_SHAPES:
        D = rows_of_kinds(nb, k, w, g, dev)
        for trim in (TRIM, 1.0 / w, 1.0 - 1.0 / w):  # keep W * 0.3, 1, W - 1
            for offset in (0, 1):
                buf = torch.zeros(D.numel() + offset, device=dev)
                Dc = buf[offset:].view(D.shape)
                Dc.copy_(D)
                want = ref.ties_thresholds(Dc, trim)
                got = mb.ties_thresholds(Dc, trim)
                torch.cuda.synchronize()
                if not same_thresholds(got, want):
                    failures.append(("threshold", (nb, k, w), trim, offset))
        del D
    # the apply: K up to 32, its plain version bit for bit
    for k in APPLY_KS:
        for nb, w, offset in ((3, 65536, 0), (2, 1001, 0), (2, 65536, 1)):
            x0 = torch.randn((nb, w), generator=g, device=dev)
            D = rows_of_kinds(nb, k, w, g, dev).nan_to_num_(0.0, 1.0, -1.0)
            t = ref.ties_thresholds(D, TRIM).contiguous()
            buf = torch.zeros(D.numel() + offset, device=dev)
            Dc = buf[offset:].view(D.shape)
            Dc.copy_(D)
            got = mb.ties_merge(x0, Dc, t, 0.9)
            want = ref.ties_apply_ref(x0, D, t, 0.9)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                failures.append(("apply", (nb, k, w), offset))
    print(json.dumps({"checks_failed": failures}), flush=True)
    if failures:
        return 1

    timer = Timer(dev)
    for nb, k, w in TIME_SHAPES:
        x0 = torch.randn((nb, w), generator=g, device=dev)
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=dev)
        keep = ref.ties_keep(TRIM, w)
        t = mb.ties_thresholds(D, TRIM)
        fns = {"change": (lambda: mb.ties_thresholds(D, TRIM),
                          lambda: mb.ties_merge(x0, D, t, 1.0))}
        if args.parent:
            fns["parent"] = (lambda: parent_thresholds(D, keep),
                             lambda: parent_apply(x0, D, t))
            pt, pa = fns["parent"][0](), fns["parent"][1]()
            torch.cuda.synchronize()
            if not (torch.equal(pt.view(torch.int32), t.view(torch.int32))
                    and torch.equal(pa.view(torch.int32),
                                    mb.ties_merge(x0, D, t, 1.0).view(torch.int32))):
                print(f"parent and change disagree at {(nb, k, w)}",
                      file=sys.stderr)
                return 1
        order = (["parent", "change", "change", "parent"] if args.parent
                 else ["change", "change"])
        ms = {name: {"threshold": [], "apply": [], "threshold_device": [],
                     "apply_device": []} for name in fns}
        for name in order:
            thr, app = fns[name]
            ms[name]["threshold"].append(timer(thr, reps=args.reps))
            ms[name]["apply"].append(timer(app, reps=args.reps))
            ms[name]["threshold_device"].append(kernel_device_ms(
                thr, r"ties_threshold", timer))
            ms[name]["apply_device"].append(kernel_device_ms(
                app, r"\bties_kernel\b", timer))
        thr_bytes = nb * k * w * 4 + nb * k * 4
        app_bytes = (2 * nb * w + nb * k * w + nb * k) * 4
        copies = {}
        for label, nbytes in (("threshold", thr_bytes), ("apply", app_bytes)):
            src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
            dst = torch.empty_like(src)
            copies[label] = timer(lambda: dst.copy_(src), reps=args.reps)
            del src, dst
        by_kernel = kernel_breakdown(fns["change"][0], timer)
        absd = D.abs()
        kth = timer(lambda: torch.kthvalue(absd, w - keep + 1, dim=-1),
                    reps=args.reps)
        print(json.dumps({
            "shape": [nb, k, w], "rows": nb * k, "trim_frac": TRIM,
            "threshold_plan": mb.ties_threshold_plan(nb * k, w),
            "apply_plan": mb.ties_apply_plan(nb, k, w),
            "ms": {n: {m: statistics.median(v) for m, v in d.items()}
                   for n, d in ms.items()},
            "turns": ms, "threshold_device_by_kernel": by_kernel,
            "copy_ms": copies, "kthvalue_ms": kth,
            "bound_ms": {"threshold": thr_bytes / BYTES_PER_S * 1e3,
                         "apply": app_bytes / BYTES_PER_S * 1e3}}), flush=True)
        del x0, D, t, absd
    return 0


if __name__ == "__main__":
    sys.exit(main())
