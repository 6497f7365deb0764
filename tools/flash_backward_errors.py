#!/usr/bin/env python3
"""Count how often the flash backward misses the card tests' tolerance,
beside SDPA's backward, over many random draws on one NVIDIA card.

    python3 tools/flash_backward_errors.py [--draws N]

For each shape of SHAPES and each of N seeds, q, k, v and the upstream
gradient are drawn N(0, 1) in bfloat16; the reference is autograd
through the port's plain ``flash_attention_ref`` (float32 inside).  The
backward's two routes (``kernels.flash_attention.backward``, route "tc"
and "fma", from the tensor-core forward's lse) and SDPA's backward are
each held to TOL (``torch.allclose``, the bf16 tolerance of
tests/test_torch_cuda.py and chip_smoke.py).  One JSON line per shape:
for dq, dk and dv of each, the draws that missed, the elements that
missed, the mean and the largest absolute error; then the card's name
and power limit.

Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

#: (label, (B, S, H, Hkv, hd), causal, window)
SHAPES = [
    ("train", (2, 1024, 12, 2, 128), True, 0),
    ("train_window", (2, 1024, 12, 2, 128), True, 256),
    ("ragged", (2, 1000, 12, 2, 128), True, 0),
    ("hd64", (2, 1024, 8, 2, 64), True, 0),
]
TOL = {"rtol": 2e-2, "atol": 2e-2}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--draws", type=int, default=12)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("flash_backward_errors: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src"))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    dev = torch.device("cuda", 0)
    for label, (b, s, h, hkv, hd), causal, window in SHAPES:
        tally = {}
        for seed in range(args.draws):
            g = torch.Generator(device=dev).manual_seed(seed)
            q, k, v, do = (torch.randn(shape, generator=g, device=dev)
                           .bfloat16() for shape in
                           ((b, s, h, hd), (b, s, hkv, hd), (b, s, hkv, hd),
                            (b, s, h, hd)))
            o, lse = fa._forward(q, k, v, causal, window, 0, "tc",
                                 with_lse=True)
            qkv = [t.clone().requires_grad_() for t in (q, k, v)]
            want = torch.autograd.grad(
                ref.flash_attention_ref(*qkv, causal, window, 0), qkv, do)
            got = {r: fa.backward(do, q, k, v, o, lse, causal, window,
                                  route=r) for r in ("tc", "fma")}
            lq, lk, lv = (t.transpose(1, 2).detach().clone()
                          .requires_grad_() for t in (q, k, v))
            i = torch.arange(s, device=dev)
            mask = (i[:, None] >= i[None, :]) & (
                (i[:, None] - i[None, :] < window) if window else True)
            out = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=None if window == 0 else mask,
                is_causal=causal and window == 0, enable_gqa=True)
            got["sdpa"] = [t.transpose(1, 2) for t in torch.autograd.grad(
                out, (lq, lk, lv), do.transpose(1, 2))]
            torch.cuda.synchronize()
            for who, grads in got.items():
                for name, a, w in zip(("dq", "dk", "dv"), grads, want):
                    a, w = a.float(), w.float()
                    err = (a - w).abs()
                    bad = int((err > TOL["atol"] + TOL["rtol"]
                               * w.abs()).sum())
                    t = tally.setdefault(who, {}).setdefault(name, {
                        "draws_missed": 0, "elements_missed": 0,
                        "mean_abs_err": 0.0, "max_abs_err": 0.0})
                    t["draws_missed"] += bad > 0
                    t["elements_missed"] += bad
                    t["mean_abs_err"] += float(err.mean()) / args.draws
                    t["max_abs_err"] = max(t["max_abs_err"], float(err.max()))
        print(json.dumps({"shape": label, "dims": [b, s, h, hkv, hd],
                          "causal": causal, "window": window,
                          "draws": args.draws, "tolerance": TOL, **tally}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
