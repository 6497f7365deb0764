#!/usr/bin/env python3
"""Ablate the (24, 16) pair's narrow CTAs on one NVIDIA card: where does
the time of the narrow forward and of the one-launch backward go?

    python3 tools/ablate_flash_narrow.py      # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` (forward)
and ``flash_attention_bwd.cu`` (backward), each the committed source
changed by text substitutions (VARIANTS below), as copies of
``src/repro_torch`` under ``build/ablate_narrow/`` (gitignored), all at
once; then, in the order base, variants, base, times each variant's
kernel at chip_smoke.py's ``mla_smoke`` shape, (2, 256, 256, 4, 4) bf16
causal at (24, 16): the mean device time of the narrow kernel
(``torch.profiler``, REPS calls, each after a 1 GiB L2 flush) beside
that of an empty launch (``torch.cuda._sleep(0)``) under the same
timer.  Every variant but ``base`` leaves a part of the work out, so its
output is wrong by design; only its time is read.  One JSON line a
variant, then the card's name and power limit.

Exits 2 without a card, 1 if a variant does not build or run.
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
OUT_DIR = os.path.join(HERE, "build", "ablate_narrow")
FWD, BWD = "flash_attention.cu", "flash_attention_bwd.cu"

_FWD_S = """#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wgmma_ss_n64(s, desc_row<2 * HDP>(qs + kk * 32, 16, 16 * HDP),
                 desc_row<2 * HDP>(ks + kk * 32, 16, 16 * HDP), kk > 0);
"""
_FWD_PV = """#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n16(acc, a[kk],
                 desc_row<2 * HDVP>(vs + kk * 32 * HDVP, VT, 16 * HDVP));
"""
_FWD_SOFTMAX = """  if (edge_tile(p, qpos_lo, rows, k0))
    ws::softmax_tile_fma<true>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                               k0 + 2 * t4, sl2);
  else
    ws::softmax_tile_fma<false>(s, m_r, l_r, alpha, p, qpos_lo + wrow + g,
                                k0 + 2 * t4, sl2);
"""
_FWD_KV = """  load_narrow<HD, HDP, THREADS>(ks, live ? k + k0 * p.k_ss : k, p.k_ss,
                                live ? p.sk - k0 : 0, BK, tid);
  load_narrow<HDV, HDVP, THREADS>(vs, live ? v + k0 * p.v_ss : v, p.v_ss,
                                  live ? p.sk - k0 : 0, BK, tid);
"""
_BWD_D = "    if (tid < 2 * B64) {  // lse and D of the tile's rows"

#: name -> (source, [(old, new, count)]): each a part of the narrow CTA
#: left out
VARIANTS = {
    "fwd_base": (FWD, []),
    "fwd_no_s": (FWD, [(_FWD_S, "", 1)]),
    "fwd_no_softmax": (FWD, [(_FWD_SOFTMAX, "  alpha[0] = alpha[1] = 1.f;\n",
                              1)]),
    "fwd_no_pv": (FWD, [(_FWD_PV, "", 1)]),
    "fwd_no_kv_loads": (FWD, [(_FWD_KV, "  (void)live;\n", 1)]),
    # CTAs 1..3 keep their O, m and l: no distributed stores
    "fwd_no_handover": (FWD, [("  if (rank > 0) {", "  if (rank < 0) {", 1)]),
    "fwd_no_combine": (FWD, [("  for (int w = 1; w < WG; ++w)",
                              "  for (int w = 1; w < 1; ++w)", 2)]),
    "bwd_base": (BWD, []),
    # S^T and dP^T of both halves: the scores stay zero
    "bwd_no_scores": (BWD, [
        ("for (int kk = 0; kk < HDP / 16; ++kk)",
         "for (int kk = 0; kk < 0; ++kk)", 1),
        ("for (int kk = 0; kk < HDVP / 16; ++kk)",
         "for (int kk = 0; kk < 0; ++kk)", 1)]),
    # dV, dK and dQ's partial: the gradients stay zero
    "bwd_no_products": (BWD, [
        ("    for (int kk = 0; kk < 4; ++kk)\n      tc::wgmma_ss_n16_bmn",
         "    for (int kk = 0; kk < 0; ++kk)\n      tc::wgmma_ss_n16_bmn", 1),
        ("    for (int kk = 0; kk < 8; ++kk)\n      tc::wgmma_ss_n32_bmn",
         "    for (int kk = 0; kk < 0; ++kk)\n      tc::wgmma_ss_n32_bmn", 2)]),
    "bwd_no_d": (BWD, [(_BWD_D,
                        "    if (tid < 0) {  // lse and D of the tile's rows",
                        1)]),
    "bwd_no_dq_sum": (BWD, [("      for (int w = 0; w < WG; ++w)",
                             "      for (int w = 0; w < 1; ++w)", 1)]),
    # each warpgroup stores its dK / dV partial into its own CTA: no
    # distributed stores
    "bwd_no_push": (BWD, [("cluster.map_shared_rank(kv, wg)",
                           "(wg < 0 ? nullptr : kv)", 1)]),
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
b, s, h, hd, hdv = 2, 256, 4, 24, 16


def rand(*shape):
    return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)


q, k, v, do = rand(b, s, h, hd), rand(b, s, h, hd), rand(b, s, h, hdv), \
    rand(b, s, h, hdv)
o, lse = fa._forward(q, k, v, True, 0, 0, "tc", with_lse=True)
if src == "flash_attention.cu":
    fn, name = (lambda: fa.launch(q, k, v, True, 0, 0, "tc"),
                "flash_attention_narrow_kernel")
else:
    fn, name = (lambda: fa.backward(do, q, k, v, o, lse, True, 0),
                "fa_bwd_narrow_tc_kernel")


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


out = {"device_ms": device_ms(fn, lambda n: name in n),
       "empty_launch_device_ms": device_ms(
           lambda: torch.cuda._sleep(0),
           lambda n: "FillFunctor<unsign" not in n)}
print(json.dumps(out))
"""

_BUILD = r"""
import sys
from repro_torch.kernels import flash_attention as fa
fa.LIBRARY.build()  # the backward's variants time it from the forward's lse
if sys.argv[1] == "flash_attention_bwd.cu":
    fa.BWD_LIBRARY.build()
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
        print("ablate_flash_narrow: no CUDA device", file=sys.stderr)
        return 2
    roots = {name: make_variant(name) for name in VARIANTS}
    with ThreadPoolExecutor(len(roots)) as ex:  # one nvcc a variant
        builds = dict(zip(roots, ex.map(
            lambda n: run(roots[n], _BUILD, VARIANTS[n][0]), roots)))
    bad = {n: p.stderr[-2000:] for n, p in builds.items() if p.returncode}
    if bad:
        print(json.dumps({"build_failed": bad}))
        return 1
    order = (["fwd_base"] + [n for n in VARIANTS if n.startswith("fwd_")
                             and n != "fwd_base"] + ["fwd_base", "bwd_base"]
             + [n for n in VARIANTS if n.startswith("bwd_")
                and n != "bwd_base"] + ["bwd_base"])
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
