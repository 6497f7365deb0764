#!/usr/bin/env python3
"""Ablate the tensor-core flash backward past hd 128 on one NVIDIA card:
where does the time of its two-warpgroup dK / dV and dQ CTAs go?

    python3 tools/ablate_flash_backward.py      # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/flash_attention_bwd.cu``, each
the committed source changed by text substitutions (VARIANTS below), as
copies of ``src/repro_torch`` under ``build/ablate_bwd/`` (gitignored),
all at once; then runs ``tools/compare_flash_backward.py``'s checks and
times (device time by kernel at its TIMES, the training phases' shapes)
on each, in the order base, variants, base, and prints one JSON line a
variant.  The variants in EXACT compute the gradient and must pass the
checks; the others leave a part of the tile's work out and time the
rest (their checks fail by design).  Last, the card's name and power
limit.

Exits 2 without a card, 1 if a variant does not build or one in EXACT
fails a check.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import compare_flash_backward as cmp  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(HERE, "src", "repro_torch")
OUT_DIR = os.path.join(HERE, "build", "ablate_bwd")
#: variants that still compute the gradient, held to the checks
EXACT = ("base", "turns", "interleave")

_DKDV_SDP = """    mma_ss_n32<HD>(s, ks, qst + qh * 128);
    tc::wgmma_commit();
    mma_ss_n32<HDV>(dp, vs, dost + qh * 128);
    tc::wgmma_commit();
"""
_DQ_SDP = """    mma_ss_n32<HD>(s, qs, kst);
    tc::wgmma_commit();
    mma_ss_n32<HDV>(dp, dos, vst);
    tc::wgmma_commit();
"""
_DQ_PRODUCTS = """    tc::wgmma_fence();
    mma_rs<HD>(dq, as, kst);  // dQ += dS.K, dS as hi + lo
    mma_rs<HD>(dq, al, kst);
    tc::wgmma_commit();
"""
_DV_RS = """      tc::wgmma_fence();
      mma_rs<HDV>(dv, ap, dost + qh * 128);  // dV += P^T.dO, its queries
      tc::wgmma_commit();
"""
_DK_RS = """      tc::wgmma_fence();
      mma_rs<HD>(dk, as, qst + qh * 128);  // dK += dS^T.Q, hi + lo
      mma_rs<HD>(dk, al, qst + qh * 128);
      tc::wgmma_commit();
"""
_PROBS = """#pragma unroll
  for (int i = 0; i < F; ++i) {
    const float pe = exp2f(fmaf(s[i], sl2, -lse2(i)));
    s[i] = ((valid >> i) & 1u) ? pe : 0.f;
  }"""
_DSCORES = ("#pragma unroll\n"
            "  for (int i = 0; i < F; ++i) dp[i] = pr[i] * (dp[i] - d(i));")
_TURN_HELPERS = """// Turn-taking between a CTA's two warpgroups (barriers 3 and 4)
__device__ __forceinline__ void wait_turn(int wg) {
  asm volatile("bar.sync %0, 256;\\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\\n" ::"r"(4 - wg) : "memory");
}

// A barrier over the 128 threads of warpgroup wg"""


def _turns(block: str) -> tuple[str, str]:
    """Issue ``block`` (products) in this warpgroup's turn."""
    return block, "    wait_turn(wg);\n" + block + "    pass_turn(wg);\n"


#: name -> (what it measures, text substitutions on the source)
VARIANTS = {
    "base": ("the committed kernels", []),
    "no_accumulate": (
        "past hd 128, dV, dK (hi + lo) and dQ (hi + lo) left out: S, dP, "
        "the softmax math and the copies only",
        [(_DV_RS, ""), (_DK_RS, ""), (_DQ_PRODUCTS, ""),
         ("      mma_ss_n128_mn(dv, pts, dost + wg * 2 * 8192);  "
          "// dV += P^T.dO\n", ""),
         ("      mma_ss_n128_mn(dk, pts + PTILE, qst + wg * 2 * 8192);\n", ""),
         ("      mma_ss_n128_mn(dk, pts + 2 * PTILE, qst + wg * 2 * 8192);\n",
          "")]),
    "no_sdp": ("past hd 128, S and dP left out (their accumulators stay 0)",
               [(_DKDV_SDP, "    tc::wgmma_commit();\n"
                            "    tc::wgmma_commit();\n"),
                (_DQ_SDP, "    tc::wgmma_commit();\n"
                          "    tc::wgmma_commit();\n")]),
    "no_softmax": ("P = exp(scale S - lse) and dS = P (dP - D) left out "
                   "(every kernel)",
                   [(_PROBS, ""), (_DSCORES, "")]),
    "turns": (
        "past hd 128, the warpgroups take turns to issue each block of "
        "products (two named barriers), so that one's softmax math may run "
        "under the other's products",
        [("// A barrier over the 128 threads of warpgroup wg",
          _TURN_HELPERS),
         _turns(_DQ_SDP),
         _turns(_DQ_PRODUCTS),
         ("  for (int kt = ktr.x; kt < ktr.y; ++kt) {\n",
          "  if (wg == 1) pass_turn(wg);  // warpgroup 0 goes first\n"
          "  for (int kt = ktr.x; kt < ktr.y; ++kt) {\n"),
         ("  tc::fence_regs(dq);\n",
          "  if (wg == 0) wait_turn(wg);  // balances warpgroup 1's first\n"
          "  tc::fence_regs(dq);\n"),
         (_DKDV_SDP, "    if (!COLS) wait_turn(wg);\n" + _DKDV_SDP
          + "    if (!COLS) pass_turn(wg);\n"),
         (_DV_RS, "      wait_turn(wg);\n" + _DV_RS
          + "      pass_turn(wg);\n"),
         (_DK_RS, "      wait_turn(wg);\n" + _DK_RS
          + "      pass_turn(wg);\n"),
         ("  for (int qt = qtr.x; qt < qtr.y; ++qt) {\n"
          "    const int st = (qt - qtr.x) & 1;\n"
          "    tc::cp_async_wait<0>();\n"
          "    tc::fence_async_smem();\n"
          "    // tile qt has landed",
          "  if (!COLS && wg == 1) pass_turn(wg);\n"
          "  for (int qt = qtr.x; qt < qtr.y; ++qt) {\n"
          "    const int st = (qt - qtr.x) & 1;\n"
          "    tc::cp_async_wait<0>();\n"
          "    tc::fence_async_smem();\n"
          "    // tile qt has landed"),
         ("  tc::fence_regs(dk);\n",
          "  if (!COLS && wg == 0) wait_turn(wg);\n"
          "  tc::fence_regs(dk);\n")]),
    "interleave": (
        "past hd 128, S's and dP's k-steps interleaved (two independent "
        "accumulator chains, one commit group)",
        [(_DKDV_SDP,
          "#pragma unroll\n"
          "    for (int kk = 0; kk < (HD > HDV ? HD : HDV) / 16; ++kk) {\n"
          "      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;\n"
          "      if (kk < HD / 16)\n"
          "        tc::wgmma_ss_n32(s, tc::desc(ks + off, 16, 1024),\n"
          "          tc::desc(qst + qh * 128 + off, 16, 1024), kk > 0);\n"
          "      if (kk < HDV / 16)\n"
          "        tc::wgmma_ss_n32(dp, tc::desc(vs + off, 16, 1024),\n"
          "          tc::desc(dost + qh * 128 + off, 16, 1024), kk > 0);\n"
          "    }\n"
          "    tc::wgmma_commit();\n"
          "    tc::wgmma_commit();\n"),
         (_DQ_SDP,
          "#pragma unroll\n"
          "    for (int kk = 0; kk < (HD > HDV ? HD : HDV) / 16; ++kk) {\n"
          "      const uint32_t off = (kk / 4) * 8192 + (kk % 4) * 32;\n"
          "      if (kk < HD / 16)\n"
          "        tc::wgmma_ss_n32(s, tc::desc(qs + off, 16, 1024),\n"
          "          tc::desc(kst + off, 16, 1024), kk > 0);\n"
          "      if (kk < HDV / 16)\n"
          "        tc::wgmma_ss_n32(dp, tc::desc(dos + off, 16, 1024),\n"
          "          tc::desc(vst + off, 16, 1024), kk > 0);\n"
          "    }\n"
          "    tc::wgmma_commit();\n"
          "    tc::wgmma_commit();\n")]),
}


def make(name: str) -> str:
    """The variant's tree under OUT_DIR: a copy of the package with the
    substitutions applied to the backward's source (each must match)."""
    tree = os.path.join(OUT_DIR, name)
    pkg = os.path.join(tree, "src", "repro_torch")
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(PACKAGE, pkg, ignore=shutil.ignore_patterns(
        "build", "__pycache__"))
    src = os.path.join(pkg, "csrc", "flash_attention_bwd.cu")
    with open(src) as f:
        text = f.read()
    for old, new in VARIANTS[name][1]:
        if old not in text:
            raise SystemExit(f"ablate_flash_backward: {name}: substitution "
                             f"does not match: {old[:60]!r}")
        text = text.replace(old, new)
    with open(src, "w") as f:
        f.write(text)
    return tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_backward: no CUDA device", file=sys.stderr)
        return 2
    trees = {name: make(name) for name in VARIANTS}
    # one nvcc a variant, all at once
    builds = [subprocess.Popen(
        [sys.executable, "-c", "from repro_torch.kernels import "
         "flash_attention as fa; fa.BWD_LIBRARY.build()"],
        env=dict(os.environ, PYTHONPATH=os.path.join(tree, "src")),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        for tree in trees.values()]
    for proc in builds:
        proc.wait()
    ok = True
    for name in ["base", *[n for n in VARIANTS if n != "base"], "base"]:
        row = cmp.run_tree(trees[name])
        if name in EXACT and not row["ok"]:
            ok = False
        if name not in EXACT:  # partial work: its checks fail by design
            row.pop("checks", None)
        print(json.dumps({"variant": name, "measures": VARIANTS[name][0],
                          **row}), flush=True)
    print(cmp.card())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
