#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's merge, service and serve paths once on
one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card; exits 2 without

Configuration: Qwen2-1.5B at its published widths (d_model 1536, 12 heads
/ 2 KV heads, head_dim 128, d_ff 8960, vocab 151936, QKV bias, tied
embedding, rope_theta 1e6), stored in bfloat16, depth cut to 4 of 28
decoder layers plus the embedding and the final norm, in the model's own
layout: the port's ``flatten_tree`` of ``DecoderLM`` (layer-stacked
tensors named as the JAX package names them, e.g. ``attn/wq`` of shape
(L, 1536, 12, 128)).  A base model (``DecoderLM`` init) and K = 4 "full"
experts (expert = base + 0.02 * N(0, 1) per tensor) are made on the card
from ``--seed``; nothing is downloaded.  Default 128 KiB blocks.

Phases, one JSON line each:

  build    nvcc builds src/repro_torch/csrc/merge_block.cu (merge,
           TIES threshold and sketch kernels) and flash_attention.cu
           (sm_90a), both at once; then each kernel's registers, spills
           and static shared memory from ptxas -v
  kernels  each Hopper kernel against its plain PyTorch version: the
           merge kernels at the merge path's largest window group (NB =
           32, K = 4, W = 65,536 float32; rtol = atol = 1e-5), the TIES
           threshold (radix select) there and at the merge's median
           launch (5, 3, 65,536) against torch.kthvalue (bit for bit),
           the ANALYZE sketch kernel at ANALYZE's largest launch (NB =
           1,024, W = 65,536 float32) and a ragged (3, 1,001) (max|x|
           bit-equal; Σx² rtol 2e-4, Σx rtol 1e-3 / atol 1e-6·W: the
           l2 and mean bars of tests/test_kernels.py), flash attention
           at the prefill shape (B, Sq, Sk, H, Hkv, hd) = (1, 2048, 2048,
           12, 2, 128) bf16 causal through both kernels (the tensor-core
           route, "tc", and the float32-FMA route, "fma"), the tensor-core
           route with window 512 and at Sq = Sk = 256 and 1,000, the FMA
           route in float32 with window 512, and a decode-style (1, 1,
           2048, ...) with q_offset 2047 (tolerance 2e-5 float32, 2e-2
           bf16): max abs error, median CUDA-event times of kernel, plain
           version, a device copy of the same bytes (merge, threshold
           and sketch kernels) and one PyTorch library call where one
           computes the same function, and the bound
  parity   one full-width decoder layer: ANALYZE on the card against
           ANALYZE on the CPU into a second catalog (bytes, hashes, sign
           signatures and max|x| equal; l2, l2_delta, mean within rtol
           1e-5 / atol 1e-6; the same plan selection and c_expert_hat for
           every operator at a 50% budget); then MergePipe.merge on the
           card (pipelined engine, torch kernels) against the numpy
           stream engine, for avg / ta / ties / dare: bf16 outputs within
           one ulp, equal per-category I/O bytes
  merge    the whole configuration: ANALYZE on the card (sketch kernel),
           then 50% budget, all four operators through MergePipe.merge
           (the v2 Session shim) on the card: ANALYZE's wall, bytes,
           sketch launches and device time; each merge's wall time, I/O
           bytes, budget soundness, windows, kernel launches, and from
           torch.profiler the kernels' device time (the TIES threshold
           kernel's apart; no kthvalue kernel may run), the device's busy
           time by activity and its idle share
  service  merge_cli --spec on the merge workspace, in process, on the
           card: a JSON spec of TIES and DARE over the four experts and a
           nested job (AVG of a TA child with expert-0), under a shared
           budget: every job commits and verifies, c_expert_run <=
           c_expert_hat <= budget, the level's union of expert bytes
           below the per-job sum; wall, bytes by category, launches
  serve    the TIES snapshot of ``merge``, loaded into the port's
           DecoderLM (``load_flat``) and served by ServeEngine(batch_slots
           = 4, max_len = 4096): 8 requests, prompts of 256-2048 tokens
           drawn from ``--seed``, 32 greedy tokens each.  First a parity
           check in float32 compute, flash-attention kernel against its
           plain version on the card (prefill logits within tolerance,
           identical tokens; float32 runs the FMA kernel); then the bf16
           run: prefill and decode rates, flash-attention launches (every
           one on the tensor-core route), and from torch.profiler the
           kernel's device time, busy time by activity and idle share

Then the kernels' contract line, and last {"ok": true, "device": ...}.
Any failure raises and exits non-zero.  The workspace lives under
build/ (gitignored) and is removed at the end.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]
# H100 data sheet (SXM): HBM bytes/s, float32 and float64 vector FLOP/s,
# bf16 dense tensor-core FLOP/s
PEAK = {"bytes": 3.35e12, "f32": 67e12, "f64": 34e12, "bf16": 989e12}
TOL = 1e-5
# tests/test_kernels.py:133,149: float32 sums in another order; bf16
# outputs one rounding apart
FA_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (label, (B, Sq, Sk, H, Hkv, hd), dtype, causal, window, q_offset, route);
# the first is the serving path's prefill shape and the contract line's
# row; "tc" is the tensor-core kernel, "fma" the float32-FMA kernel
FA_CASES = [
    ("prefill", (1, 2048, 2048, 12, 2, 128), "bfloat16", True, 0, 0, "tc"),
    ("prefill", (1, 2048, 2048, 12, 2, 128), "bfloat16", True, 0, 0, "fma"),
    ("prefill_window", (1, 2048, 2048, 12, 2, 128), "bfloat16", True, 512,
     0, "tc"),
    ("prefill_256", (1, 256, 256, 12, 2, 128), "bfloat16", True, 0, 0, "tc"),
    ("prefill_1000", (1, 1000, 1000, 12, 2, 128), "bfloat16", True, 0, 0,
     "tc"),
    ("prefill_window_f32", (1, 2048, 2048, 12, 2, 128), "float32", True, 512,
     0, "fma"),
    ("decode", (1, 1, 2048, 12, 2, 128), "bfloat16", True, 0, 2047, "tc"),
]
# (label, (NB, K, W)) float32 TIES threshold launches: the merge path's
# largest window group and its median launch by rows (the merge phase
# reports the launches' shapes: 15 rows of 128 KiB blocks, 1 to 46)
THRESH_CASES = [("group", (32, 4, 65536)), ("median", (5, 3, 65536))]
TRIM = 0.3
SERVE = {"requests": 8, "min_prompt": 256, "max_prompt": 2048,
         "new_tokens": 32, "batch_slots": 4, "max_len": 4096}
# (NB, W) float32 sketch launches: ANALYZE's largest (core/sketch.py
# LAUNCH_BYTES of full 128 KiB bf16 blocks) and a ragged one
SKETCH_CASES = [("analyze", (1024, 65536)), ("ragged", (3, 1001))]
# ANALYZE on the card against the CPU: sums in another order
ANALYZE_TOL = {"rtol": 1e-5, "atol": 1e-6}
# the service phase's spec file: two jobs over all four experts and a
# nested job whose child snapshot the service ANALYZEs itself
EXPERTS = [f"expert-{e}" for e in range(4)]
SERVICE_SPEC = {"jobs": [
    {"name": "svc-ties", "base": "base", "experts": EXPERTS, "op": "ties",
     "theta": {"trim_frac": 0.3}, "budget": "50%"},
    {"name": "svc-dare", "base": "base", "experts": EXPERTS, "op": "dare",
     "theta": {"density": 0.5, "seed": 3}, "budget": "50%"},
    {"name": "svc-nested", "base": "base", "op": "avg", "budget": "50%",
     "experts": [{"base": "base", "experts": EXPERTS[1:3], "op": "ta",
                  "theta": {"lam": 0.5}, "budget": "50%"}, "expert-0"]},
]}
# float32 serve parity, kernel against plain version: prefill logits of
# std ~40 (vocab 151,936, d 1536) with attention sums in another order
LOGIT_TOL = {"rtol": 1e-4, "atol": 2e-3}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def qwen2_config(layers: int, compute_dtype: str = "bfloat16"):
    """Qwen2-1.5B at published widths, ``layers`` deep, bf16 params."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen2-1.5b"), n_layers=layers,
                               param_dtype="bfloat16",
                               compute_dtype=compute_dtype)


def populate(mp, layers, k, seed, device, layer_only=False):
    """Register base (``DecoderLM`` init, in the port's flat layout) and
    k full experts, made on ``device`` in bf16.  ``layer_only`` keeps the
    decoder layers and drops the embedding and the final norm."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.store.checkpoint import flatten_tree

    g = torch.Generator(device=device).manual_seed(seed)
    model = build_model(qwen2_config(layers), device=device, generator=g)
    base = {n: t for n, t in flatten_tree(model).items()
            if not (layer_only and n in ("embed/embedding", "ln_f"))}
    mp.register_model("base", base)
    params = {n.replace(".", "/"): p.detach()
              for n, p in model.state_dict(keep_vars=True).items()}
    ids = []
    for e in range(k):
        mp.register_model(f"expert-{e}", {
            n: (params[n].float() + 0.02 * torch.randn(
                params[n].shape, generator=g, device=device)
                ).to(torch.bfloat16)
            for n in base
        })
        ids.append(f"expert-{e}")
    shapes = {n: a.shape for n, a in base.items()}
    return ids, sum(a.size for a in base.values()), shapes


class Timer:
    """Median per-call time: CUDA events on a card (L2 flushed before
    every call, as the merge path meets fresh inputs), else the host
    clock (rehearsal only — not a device time)."""

    def __init__(self, device):
        import torch

        self.cuda = device.type == "cuda"
        self.flush = (torch.empty(256 << 20, dtype=torch.uint8, device=device)
                      if self.cuda else None)

    def __call__(self, fn, reps=25, warm=3):
        import torch

        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            if self.cuda:
                self.flush.zero_()
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                fn()
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)


def phase_kernels(device, seed, nb=32, k=4, w=65536):
    """Kernel vs plain version at the merge path's largest group."""
    import numpy as np
    import torch

    from repro_torch.core.operators import dare_mask_batch
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 1)
    x0 = torch.randn((nb, w), generator=g, device=device)
    D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
    thresh = ref.ties_thresholds(D, 0.3).contiguous()
    masks = torch.from_numpy(np.stack([
        dare_mask_batch(seed, list(range(k)), "model.layers.0.mlp.up_proj.weight",
                        b, w, 0.5)
        for b in range(nb)])).to(device).view(torch.uint8)
    timer = Timer(device)
    f32 = 4
    n_out = nb * w
    base_bytes = (nb * w + nb * k * w + nb * w) * f32
    ones = torch.ones((nb, 1, k), device=device)
    cases = [
        ("linear_merge", "src/repro/kernels/merge_block.py:48",
         lambda: mb.linear_merge(x0, D, 0.7, 1.0),
         lambda: ref.linear_ref(x0, D, 0.7, 1.0),
         # one library call computing x0 + 0.7 * sum_k D_k
         lambda: torch.baddbmm(x0.unsqueeze(1), ones, D, alpha=0.7),
         base_bytes, {"f32": n_out * (k + 1)}),
        ("ties_merge", "src/repro/kernels/merge_block.py:84",
         lambda: mb.ties_merge(x0, D, thresh, 1.0),
         lambda: ref.ties_apply_ref(x0, D, thresh, 1.0),
         None, base_bytes + nb * k * f32,
         {"f32": n_out * k * 6, "f64": n_out * 3}),
        ("dare_merge", "src/repro/kernels/merge_block.py:116",
         lambda: mb.dare_merge(x0, D, masks, 0.5, 1.0),
         lambda: ref.dare_ref(x0, D, masks, 0.5, 1.0),
         None, base_bytes + nb * k * w, {"f32": n_out * (2 * k + 2)}),
    ]
    rows = []
    for name, replaces, kern, plain, library, nbytes, ops in cases:
        kernel_name = name.replace("_merge", "") + "_kernel"
        got, want = kern(), plain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        n_diff = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"{name}: kernel disagrees, max abs err {err}")
        # a copy of nbytes / 2 reads and writes nbytes in all, as the kernel
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = sum(n / PEAK[t] for t, n in ops.items()) * 1e3
        rows.append({
            "name": name, "route": "cuda", "kernel": kernel_name,
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": replaces,
            "shape": [nb, k, w], "max_abs_err": err, "bits_differ": n_diff,
            "ms": timer(kern), "plain_ms": timer(plain),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": timer(library) if library is not None else None,
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del src, dst
    del x0, D, thresh, masks
    rows += threshold_rows(device, seed, timer)
    rows += sketch_rows(device, seed, timer)
    rows += flash_rows(device, seed, timer)
    emit({"phase": "kernels", "tolerance": TOL, "kernels": rows})
    return rows


def threshold_rows(device, seed, timer):
    """TIES threshold kernel vs torch.kthvalue (its plain version) at
    THRESH_CASES, bit for bit."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 4)
    rows = []
    for label, (nb, k, w) in THRESH_CASES:
        D = 0.02 * torch.randn((nb, k, w), generator=g, device=device)
        got, want = mb.ties_thresholds(D, TRIM), ref.ties_thresholds(D, TRIM)
        if device.type == "cuda":
            torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"ties_threshold {label}: kernel disagrees "
                                 f"with kthvalue")
        absd = D.abs()
        kth = w - ref.ties_keep(TRIM, w) + 1
        nbytes = nb * k * w * 4 + nb * k * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        # one |x| and one compare per element and radix pass
        ops_ms = 2 * 4 * nb * k * w / PEAK["f32"] * 1e3
        rows.append({
            "name": "ties_threshold", "route": "cuda", "case": label,
            "kernel": "ties_threshold_kernel",
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/ref.py:19",
            "shape": [nb, k, w], "trim_frac": TRIM, "max_abs_err": 0.0,
            "bits_differ": 0,
            "ms": timer(lambda: mb.ties_thresholds(D, TRIM)),
            "plain_ms": timer(lambda: ref.ties_thresholds(D, TRIM)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            # one library call given |D|: torch.kthvalue
            "library_ms": timer(lambda: torch.kthvalue(absd, kth, dim=-1)),
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del D, absd, got, want, src, dst
    return rows


def sketch_close(got, want, w):
    """The l2 and mean bars of tests/test_kernels.py on the raw sums,
    max|x| bit for bit; returns the largest relative error of each."""
    import torch

    rel = ((got - want).abs() / want.abs().clamp(min=1e-30)).amax(dim=0)
    ok = (torch.allclose(got[:, 0], want[:, 0], rtol=2e-4, atol=0)
          and torch.equal(got[:, 1], want[:, 1])
          and torch.allclose(got[:, 2], want[:, 2], rtol=1e-3, atol=1e-6 * w))
    return ok, [float(r) for r in rel]


def sketch_rows(device, seed, timer):
    """ANALYZE sketch kernel vs its plain version at SKETCH_CASES."""
    import torch

    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 3)
    rows = []
    for label, (nb, w) in SKETCH_CASES:
        x = 0.03 * torch.randn((nb, w), generator=g, device=device)
        got, want = mb.sketch_blocks(x), ref.sketch_ref(x)
        if device.type == "cuda":
            torch.cuda.synchronize()
        ok, rel = sketch_close(got, want, w)
        err = float((got - want).abs().max())
        if not ok:
            raise AssertionError(f"sketch_blocks {label}: kernel disagrees, "
                                 f"relative errors {rel}")
        nbytes = nb * w * 4 + nb * 3 * 4
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = 3 * nb * w / PEAK["f32"] * 1e3  # x*x+s, max|x|, s+x
        rows.append({
            "name": "sketch_blocks", "route": "cuda", "case": label,
            "kernel": "sketch_kernel",
            "source": "src/repro_torch/csrc/merge_block.cu",
            "replaces": "src/repro/kernels/merge_block.py:161",
            "shape": [nb, w], "max_abs_err": err, "max_rel_err": rel,
            "absmax_bit_equal": True,
            "ms": timer(lambda: mb.sketch_blocks(x)),
            "plain_ms": timer(lambda: ref.sketch_ref(x)),
            "copy_ms": timer(lambda: dst.copy_(src)),
            "library_ms": None,  # no one PyTorch call gives all three
            "bytes": nbytes, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del x, got, want, src, dst
    return rows


def attention_mask(sq, sk, causal, window, q_offset, device):
    """(Sq, Sk) bool: which keys each query attends."""
    import torch

    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    valid = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        valid &= qpos >= kpos
    if window > 0:
        valid &= qpos - kpos < window
    return valid


def flash_rows(device, seed, timer):
    """Flash-attention kernel vs its plain version at FA_CASES."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    g = torch.Generator(device=device).manual_seed(seed + 2)
    rows = []
    for (label, (b, sq, sk, h, hkv, hd), dt, causal, window, qoff,
         route) in FA_CASES:
        dtype = getattr(torch, dt)
        q = torch.randn((b, sq, h, hd), generator=g, device=device).to(dtype)
        k = torch.randn((b, sk, hkv, hd), generator=g, device=device).to(dtype)
        v = torch.randn((b, sk, hkv, hd), generator=g, device=device).to(dtype)

        def kern():
            return fa.launch(q, k, v, causal, window, qoff, route)

        def plain():
            return ref.flash_attention_ref(q, k, v, causal, window, qoff,
                                           skip_masked_chunks=True)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = FA_TOL[dt]
        if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
            raise AssertionError(f"flash_attention {label}: kernel disagrees, "
                                 f"max abs err {err}")
        # yardstick only: one PyTorch call computing the same function
        mask = attention_mask(sq, sk, causal, window, qoff, device)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        full_causal = causal and window == 0 and qoff == 0 and sq == sk
        lib_mask = None if full_causal or bool(mask.all()) else mask

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=lib_mask, is_causal=full_causal,
                enable_gqa=True)

        # live work: 2 FLOP per (q, k) pair and head dim for q.k, 2 for p.v
        flops = 4 * hd * int(mask.sum()) * b * h
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        bytes_ms = nbytes / PEAK["bytes"] * 1e3
        ops_ms = flops / PEAK["bf16" if dt == "bfloat16" else "f32"] * 1e3
        rows.append({
            "name": "flash_attention", "route": "cuda", "case": label,
            "fa_route": route,
            "kernel": ("flash_attention_tc_kernel" if route == "tc"
                       else "flash_attention_kernel"),
            "routed_by_rule": route == fa._route(dtype, hd),
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:102",
            "shape": [b, sq, sk, h, hkv, hd], "dtype": dt, "causal": causal,
            "window": window, "q_offset": qoff, "tolerance": tol,
            "max_abs_err": err, "ms": timer(kern), "plain_ms": timer(plain),
            "copy_ms": None, "library_ms": timer(library),
            "flops": flops, "bytes": nbytes,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        })
        del q, k, v, got, want, mask
    return rows


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between two uint16 word arrays."""
    import numpy as np

    def ordered(u):
        u = u.astype(np.int32)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def analyze_parity(mp, ids, cpu_catalog, block_size):
    """ANALYZE on ``mp``'s device against the CPU into ``cpu_catalog``:
    catalog rows, then plan selections for every operator."""
    import math

    from repro_torch.core.planner import plan_merge
    from repro_torch.core.sketch import analyze_model

    models = ["base", *ids]
    for m in models:
        analyze_model(cpu_catalog, mp.snapshots.models, m, block_size,
                      base_id=None if m == "base" else "base", device="cpu")
    rows = 0
    worst = {"l2": 0.0, "mean": 0.0, "l2_delta": 0.0}
    for m in models:
        a = mp.catalog.block_metas(m, block_size)
        b = cpu_catalog.block_metas(m, block_size)
        if len(a) != len(b) or not a:
            raise AssertionError(f"analyze parity {m}: {len(a)} vs {len(b)} rows")
        for ra, rb in zip(a, b):
            # tensor, block, bytes, hash; absmax; sign signature
            if ra[:4] != rb[:4] or ra[5] != rb[5] or ra[7] != rb[7]:
                raise AssertionError(f"analyze parity {m}: {ra} vs {rb}")
            for i, key in ((4, "l2"), (6, "mean"), (8, "l2_delta")):
                if (ra[i] is None) != (rb[i] is None):
                    raise AssertionError(f"analyze parity {m} {key}: {ra} vs {rb}")
                if ra[i] is None:
                    continue
                if not math.isclose(ra[i], rb[i], rel_tol=ANALYZE_TOL["rtol"],
                                    abs_tol=ANALYZE_TOL["atol"]):
                    raise AssertionError(f"analyze parity {m} {key}: "
                                         f"{ra[i]} vs {rb[i]}")
                worst[key] = max(worst[key], abs(ra[i] - rb[i]))
        rows += len(a)
    plans = {}
    budget_b = mp.resolve_budget(ids, 0.5)
    for op, theta in OPS:
        pa, pb = (plan_merge(cat, "base", ids, op, theta=theta,
                             budget_b=budget_b, block_size=block_size,
                             reuse=False).plan
                  for cat in (mp.catalog, cpu_catalog))
        same = (pa.selection == pb.selection
                and pa.c_expert_hat == pb.c_expert_hat)
        if not same:
            raise AssertionError(f"analyze parity: {op} plans differ")
        plans[op] = {"c_expert_hat": pa.c_expert_hat, "identical": True}
    return {"rows": rows, "tolerance": ANALYZE_TOL, "max_abs_err": worst,
            "plans": plans}


def phase_parity(root, device, seed, block_size):
    import numpy as np

    from repro_torch.core.api import MergePipe
    from repro_torch.core.catalog import Catalog
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "parity"), block_size=block_size,
                   device=device)
    ids, n_params, _ = populate(mp, 1, 4, seed, device, layer_only=True)
    out = {"phase": "parity", "layers": 1, "params": n_params, "ops": {}}
    mp.ensure_analyzed("base", ids)
    cpu_catalog = Catalog(os.path.join(root, "parity-cpu.sqlite"))
    out["analyze"] = analyze_parity(mp, ids, cpu_catalog, block_size)
    cpu_catalog.close()
    for op, theta in OPS:
        with measure(mp.stats) as io_k:
            rk = mp.merge("base", ids, op, theta=theta, budget=0.5)
        with measure(mp.stats) as io_s:
            rs = mp.merge("base", ids, op, theta=theta, budget=0.5,
                          compute="stream")
        a, b = mp.load(rk.sid), mp.load(rs.sid)
        n_diff = max_ulp = n = 0
        for t in a:
            ulps = bf16_ulps(a[t], b[t])
            n_diff += int(np.count_nonzero(ulps))
            max_ulp = max(max_ulp, int(ulps.max()))
            n += ulps.size
        io_same = all(io_k[c] == io_s[c]
                      for c in ("base_read", "expert_read", "out_written"))
        out["ops"][op] = {"elements": n, "elements_differ": n_diff,
                          "max_ulp": max_ulp, "iostats_equal": io_same}
        if max_ulp > 1 or not io_same:
            raise AssertionError(f"parity {op}: {out['ops'][op]}")
    mp.close()
    emit(out)


def analyze_bytes(stats, before):
    """Bytes read under the ``analyze`` I/O category since ``before``."""
    def read(snap):
        return snap["read"].get("analyze", {}).get("bytes", 0)

    return read(stats.snapshot()) - read(before)


def device_time_ms(prof):
    """Device time per activity (kernels, copies) of a profiled run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            out[e.key[:80]] = us / 1e3
    return out


def phase_merge(root, device, seed, block_size, layers):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import sketch
    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ops
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "merge"), block_size=block_size,
                   device=device)
    t0 = time.perf_counter()
    ids, n_params, shapes = populate(mp, layers, 4, seed, device)
    t_reg = time.perf_counter() - t0
    activities = [ProfilerActivity.CUDA if device.type == "cuda"
                  else ProfilerActivity.CPU]
    # host time of ANALYZE's sketch stage (stack, staging, kernels, copy
    # back); the rest of ANALYZE is reads, hashes and signatures
    real_sketch_rows = sketch._sketch_rows
    sketch_s = [0.0]

    def timed_sketch_rows(*a, **kw):
        t = time.perf_counter()
        try:
            return real_sketch_rows(*a, **kw)
        finally:
            sketch_s[0] += time.perf_counter() - t

    sketch._sketch_rows = timed_sketch_rows
    # the main path: launch counts start at 0 here and are read at the end
    mb.reset_launches()
    before = mp.stats.snapshot()
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof:
            mp.ensure_analyzed("base", ids)
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        sketch._sketch_rows = real_sketch_rows
    t_analyze = time.perf_counter() - t0
    sketches = mb.LAUNCHES["sketch_blocks"]
    if sketches == 0:
        raise AssertionError("analyze: sketch_blocks never launched")
    device_ms = device_time_ms(prof)
    sketch_ms = sum(t for n, t in device_ms.items() if "sketch_kernel" in n)
    busy = sum(device_ms.values())
    out = {"phase": "merge", "layers": layers, "params_per_model": n_params,
           "k": len(ids), "budget": 0.5, "register_s": t_reg,
           "analyze": {"wall_s": t_analyze, "sketch_stage_s": sketch_s[0],
                       "analyze_bytes": analyze_bytes(mp.stats, before),
                       "sketch_launches": sketches,
                       "sketch_kernel_ms": sketch_ms,
                       "device_busy_ms": busy,
                       "device_idle_share": 1 - busy / 1e3 / t_analyze,
                       "device_top_ms": dict(sorted(
                           device_ms.items(), key=lambda kv: -kv[1])[:6])},
           "ops": {}}
    # host time of the engine's compute stage (staging, kernels, copy back)
    real_merge_blocks = ops.merge_blocks
    stage_s = [0.0]

    def timed_merge_blocks(*a, **kw):
        t = time.perf_counter()
        try:
            return real_merge_blocks(*a, **kw)
        finally:
            stage_s[0] += time.perf_counter() - t

    ops.merge_blocks = timed_merge_blocks
    # the shape of each TIES threshold launch
    real_thresholds = mb.ties_thresholds
    thresh_shapes = []

    def recorded_thresholds(D, trim_frac):
        thresh_shapes.append(tuple(D.shape))
        return real_thresholds(D, trim_frac)

    mb.ties_thresholds = recorded_thresholds
    for op, theta in OPS:
        before = dict(mb.LAUNCHES)
        stage_s[0] = 0.0
        t0 = time.perf_counter()
        with measure(mp.stats) as io, profile(activities=activities) as prof:
            res = mp.merge("base", ids, op, theta=theta, budget=0.5)
        wall = time.perf_counter() - t0
        device_ms = device_time_ms(prof)
        kernel_ms = sum(t for n, t in device_ms.items()
                        if re.search(r"\b(linear|ties|dare)_kernel\b", n))
        threshold_ms = sum(t for n, t in device_ms.items()
                           if re.search(r"\bties_threshold_kernel\b", n))
        kth = [n for n in device_ms if re.search("kth", n, re.I)]
        if kth:
            raise AssertionError(f"merge {op}: a kthvalue kernel ran: {kth}")
        launches = {n: mb.LAUNCHES[n] - before[n] for n in mb.LAUNCHES}
        wants = (["dare_merge"] if op == "dare" else
                 ["ties_threshold", "ties_merge"] if op == "ties" else
                 ["linear_merge"])
        for want in wants:
            if launches[want] == 0:
                raise AssertionError(f"merge {op}: {want} never launched")
        run, hat = res.stats["c_expert_run"], res.stats["c_expert_hat"]
        if run > hat:
            raise AssertionError(f"merge {op}: c_expert_run {run} > hat {hat}")
        merged = mp.load(res.sid)
        for name, shape in shapes.items():
            u = merged[name]
            if u.shape != shape or np.any((u & 0x7F80) == 0x7F80):
                raise AssertionError(f"merge {op}: {name} not finite / wrong shape")
        if not mp.verify(res.sid):
            raise AssertionError(f"merge {op}: snapshot hashes do not verify")
        out["ops"][op] = {
            "wall_s": wall, "out_mb_per_s": io["out_written"] / wall / 1e6,
            "base_read": io["base_read"], "expert_read": io["expert_read"],
            "out_written": io["out_written"], "c_expert_run": run,
            "c_expert_hat": hat, "windows": res.stats["pipeline"]["windows"],
            "launches": launches, "kernel_ms": kernel_ms,
            "threshold_kernel_ms": threshold_ms,
            "compute_stage_s": stage_s[0],
            "device_busy_ms": sum(device_ms.values()),
            "device_idle_share": 1 - sum(device_ms.values()) / 1e3 / wall,
            "device_top_ms": dict(sorted(device_ms.items(),
                                         key=lambda kv: -kv[1])[:6]),
        }
        if op == "ties":
            ties_sid, ties_flat = res.sid, merged
        del merged
    ops.merge_blocks = real_merge_blocks
    mb.ties_thresholds = real_thresholds
    by_rows = sorted(thresh_shapes, key=lambda sh: (sh[0] * sh[1], sh))
    out["ops"]["ties"]["threshold_launches"] = {
        "rows_min": by_rows[0][0] * by_rows[0][1],
        "rows_max": by_rows[-1][0] * by_rows[-1][1],
        "median_shape": list(by_rows[len(by_rows) // 2]),
        "most_common": [[list(sh), n] for sh, n in
                        collections.Counter(thresh_shapes).most_common(4)]}
    out["launches"] = dict(mb.LAUNCHES)
    out["ties_sid"] = ties_sid
    mp.close()
    emit(out)
    return out["launches"], ties_flat


def phase_service(root, device, block_size):
    """merge_cli --spec, in process, on the merge workspace."""
    import torch

    from repro_torch.api import Session
    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.launch import merge_cli
    from repro_torch.store.iostats import measure

    ws = os.path.join(root, "merge")
    spec_path = os.path.join(root, "service-spec.json")
    with open(spec_path, "w") as f:
        json.dump(SERVICE_SPEC, f)
    seen = {}

    class RecordingSession(Session):
        """The CLI's Session, keeping run_all's results and I/O bytes."""

        def run_all(self, **kw):
            before = self.stats.snapshot()
            with measure(self.stats) as io:
                seen["results"] = super().run_all(**kw)
            seen["io"] = dict(io, analyze=analyze_bytes(self.stats, before))
            return seen["results"]

    argv = ["--workspace", ws, "--spec", spec_path,
            "--block-size", str(block_size), "--shared-budget", "60%",
            "--cache-max-bytes", "4GiB", "--device", str(device)]
    cli_session = merge_cli.Session
    merge_cli.Session = RecordingSession
    # the service path: launch counts start at 0 here and are read after
    mb.reset_launches()
    t0 = time.perf_counter()
    try:
        merge_cli.main(argv)
        if device.type == "cuda":
            torch.cuda.synchronize()
    finally:
        merge_cli.Session = cli_session
    wall = time.perf_counter() - t0
    launches = dict(mb.LAUNCHES)
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"service: {name} never launched")
    results = seen["results"]
    jobs = {}
    mp = MergePipe(ws, block_size=block_size, device=device)
    for res in results:
        rec = mp.explain(res.sid)
        run, hat, budget = (rec["c_expert_run"], rec["c_expert_hat"],
                            rec["budget_b"])
        if run > hat or (budget >= 0 and hat > budget):
            raise AssertionError(f"service {res.sid}: run {run}, hat {hat}, "
                                 f"budget {budget}")
        if not mp.verify(res.sid):
            raise AssertionError(f"service {res.sid}: snapshot does not verify")
        jobs[res.sid] = {"op": rec["op"], "c_expert_run": run,
                         "c_expert_hat": hat, "budget_b": budget}
    mp.close()
    if len(jobs) != len(SERVICE_SPEC["jobs"]):
        raise AssertionError(f"service: {len(jobs)} jobs committed")
    # the first level's shared window: its planned union below the
    # per-job sum, and the expert bytes read in all below the jobs' hats
    batch = results[0].stats["batch"]
    per_job = sum(j["c_expert_hat"] for j in jobs.values())
    if not (batch["c_expert_hat_union"] < batch["c_expert_hat_sum"]
            and seen["io"]["expert_read"] < per_job):
        raise AssertionError(f"service: no sharing: {batch}, "
                             f"{seen['io']['expert_read']} of {per_job}")
    emit({"phase": "service", "argv": argv[2:], "wall_s": wall, "jobs": jobs,
          "window": {k: batch[k] for k in (
              "jobs", "c_expert_hat_union", "c_expert_hat_sum",
              "sharing_factor", "shared_budget_b", "pool_respected")},
          "io": seen["io"], "per_job_expert_hat_sum": per_job,
          "launches": launches})
    return launches


@contextlib.contextmanager
def plain_attention():
    """Route the model's flash attention to its plain version (on the
    card too), for the kernel-against-plain serve parity."""
    from repro_torch.kernels import ref
    from repro_torch.models import attention

    kernel = attention.flash_attention
    attention.flash_attention = ref.flash_attention_ref
    try:
        yield
    finally:
        attention.flash_attention = kernel


def phase_serve(device, seed, layers, merged):
    """Serve the merged TIES snapshot through the port's ServeEngine."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import from_jax_flat
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = qwen2_config(layers)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SERVE["min_prompt"], SERVE["max_prompt"] + 1,
                           size=SERVE["requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in lengths]
    new = SERVE["new_tokens"]

    def engine_and_requests(model):
        reqs = [Request(rid=i, prompt=p, max_new_tokens=new)
                for i, p in enumerate(prompts)]
        return ServeEngine(model, batch_slots=SERVE["batch_slots"],
                           max_len=SERVE["max_len"]), reqs

    def run(model):
        engine, reqs = engine_and_requests(model)
        engine.run(reqs)
        if not all(r.done and len(r.out_tokens) == new for r in reqs):
            raise AssertionError("serve: a request did not finish")
        return engine, reqs

    # parity: float32 compute on the merged bf16 weights, kernel vs plain
    t0 = time.perf_counter()
    m32 = from_jax_flat(dataclasses.replace(cfg, compute_dtype="float32"),
                        merged, device=device)
    load_s = time.perf_counter() - t0
    worst = 0.0
    for p in prompts:
        toks = torch.as_tensor(p, dtype=torch.long, device=device)[None]
        with torch.inference_mode():
            lk = m32.prefill(toks)[0]
            with plain_attention():
                lp = m32.prefill(toks)[0]
        worst = max(worst, float((lk - lp).abs().max()))
        if not torch.isfinite(lk).all() or not torch.allclose(lk, lp,
                                                              **LOGIT_TOL):
            raise AssertionError(f"serve parity: prefill logits differ by "
                                 f"{worst} at prompt length {len(p)}")
    _, k_reqs = run(m32)
    with plain_attention():
        _, p_reqs = run(m32)
    same = [a.out_tokens == b.out_tokens for a, b in zip(k_reqs, p_reqs)]
    if not all(same):
        raise AssertionError(f"serve parity: greedy tokens differ for "
                             f"requests {[i for i, s in enumerate(same) if not s]}")
    del m32

    model = from_jax_flat(cfg, merged, device=device)
    run(model)  # warm-up: bf16 GEMM and kernel first launches

    # the main path: the launch count starts at 0 here and is read after
    timing = {"prefill_s": 0.0, "prefill_tokens": 0, "decode_s": 0.0,
              "decode_steps": 0, "decode_tokens": 0}
    engine, reqs = engine_and_requests(model)
    prefill_slot, step = engine._prefill_slot, engine.step

    def timed_prefill(slot, req):
        t = time.perf_counter()
        n = prefill_slot(slot, req)  # ends in a host sync (sampling)
        timing["prefill_s"] += time.perf_counter() - t
        timing["prefill_tokens"] += len(req.prompt)
        return n

    def timed_step():
        active = sum(r is not None for r in engine._slot_req)
        t = time.perf_counter()
        step()  # ends in a host sync (sampling)
        timing["decode_s"] += time.perf_counter() - t
        timing["decode_steps"] += active > 0
        timing["decode_tokens"] += active

    engine._prefill_slot, engine.step = timed_prefill, timed_step
    fa.reset_launches()
    t0 = time.perf_counter()
    engine.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fa.LAUNCHES["flash_attention"]
    if launches == 0:
        raise AssertionError("serve: flash_attention never launched")
    tc_launches = fa.LAUNCHES["flash_attention_tc"]
    if tc_launches != launches:
        raise AssertionError(f"serve: {fa.LAUNCHES} — a bf16 prefill launch "
                             f"missed the tensor-core route")
    if not all(r.done and len(r.out_tokens) == new for r in reqs):
        raise AssertionError("serve: a request did not finish")
    if any(not 0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens):
        raise AssertionError("serve: token out of the vocabulary")

    # the same requests again under the profiler (device activity only,
    # as in ``merge``): device time by activity.  The idle share is taken
    # against the timed run's wall, which the profiler does not stretch.
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(model)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    device_ms = device_time_ms(prof)
    kernel_ms = sum(t for n, t in device_ms.items()
                    if re.search(r"\bflash_attention_tc_kernel\b", n))
    fma_ms = sum(t for n, t in device_ms.items()
                 if re.search(r"\bflash_attention_kernel\b", n))
    if kernel_ms == 0 or fma_ms != 0:
        raise AssertionError(f"serve: profile shows {kernel_ms} ms of the "
                             f"tensor-core kernel, {fma_ms} ms of the FMA one")
    busy = sum(device_ms.values())
    emit({
        "phase": "serve", "layers": layers, "requests": len(prompts),
        "prompt_lengths": [int(n) for n in lengths], "new_tokens": new,
        "batch_slots": SERVE["batch_slots"], "max_len": SERVE["max_len"],
        "load_s": load_s,
        "parity": {"compute_dtype": "float32", "max_logit_diff": worst,
                   "logit_tol": LOGIT_TOL, "tokens_identical": True},
        "wall_s": wall,
        "prefill_tokens": timing["prefill_tokens"],
        "prefill_s": timing["prefill_s"],
        "prefill_tokens_per_s": timing["prefill_tokens"] / timing["prefill_s"],
        "decode_steps": timing["decode_steps"],
        "decode_tokens": timing["decode_tokens"],
        "decode_s": timing["decode_s"],
        "decode_tokens_per_s": timing["decode_tokens"] / timing["decode_s"],
        "ms_per_decode_step": timing["decode_s"] / timing["decode_steps"] * 1e3,
        "launches": {"flash_attention": launches,
                     "flash_attention_tc": tc_launches},
        "profiled_wall_s": prof_wall, "flash_kernel_ms": kernel_ms,
        "device_busy_ms": busy,
        "device_idle_share": 1 - busy / 1e3 / wall,
        "device_top_ms": dict(sorted(device_ms.items(),
                                     key=lambda kv: -kv[1])[:8]),
    })
    return {"flash_attention": launches}


def ptxas_report(log_path):
    """Per kernel of one build: registers, spills, stack and static shared
    memory, from nvcc's ``-Xptxas -v`` output."""
    from repro_torch.kernels.build import nvcc

    cufilt = os.path.join(os.path.dirname(nvcc()), "cu++filt")  # demangler
    out, cur = {}, None
    with open(log_path) as f:
        for ln in f:
            m = re.search(r"Compiling entry function '(\S+)'", ln)
            if m:
                cur = m.group(1)
                out[cur] = {}
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", ln)
            if m:
                out[cur].update(stack=int(m.group(1)),
                                spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[cur]["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", ln)
                out[cur]["smem_static"] = int(sm.group(1)) if sm else 0
    if os.path.exists(cufilt) and out:
        names = subprocess.run([cufilt], input="\n".join(out), text=True,
                               capture_output=True).stdout.split("\n")
        if len(names) >= len(out):
            out = {n: v for n, v in zip(names, out.values())}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=128 * 1024)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import merge_block as mb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    emit({"config": "qwen2-1.5b", "dtype": "bfloat16", "experts": 4,
          "block_size": args.block_size, "seed": args.seed,
          "reduced": f"depth {args.layers} of "
                     f"{get_config('qwen2-1.5b').n_layers} decoder layers "
                     f"(+ embedding, final norm) for merge and serve; "
                     f"widths as published"})

    t0 = time.perf_counter()
    libraries = (mb.LIBRARY, fa.LIBRARY)
    with ThreadPoolExecutor(len(libraries)) as ex:  # one nvcc per source
        paths = list(ex.map(lambda lib: lib.build(), libraries))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.relpath(p, HERE) for p in paths]})
    # each kernel's registers, spills and static shared memory (ptxas -v)
    emit({"ptxas": {os.path.basename(lib.source): ptxas_report(lib.log_path())
                    for lib in libraries}})

    rows = phase_kernels(device, args.seed)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke-ws-", dir=os.path.join(HERE, "build"))
    try:
        phase_parity(root, device, args.seed, args.block_size)
        launches, merged = phase_merge(root, device, args.seed,
                                       args.block_size, args.layers)
        service = phase_service(root, device, args.block_size)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # each kernel's launches over the paths that run it
    launches = {n: launches[n] + service[n] for n in launches}
    launches.update(phase_serve(device, args.seed, args.layers, merged))
    keys = ("name", "kernel", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "copy_ms")
    # one row per kernel of the main path: the threshold at the largest
    # group, the sketch at ANALYZE's launch, flash attention at the
    # prefill shape through the tensor-core kernel (the serve phase checked
    # that every bf16 prefill launch took that route)
    firsts = {}
    for r in rows:
        if r.get("fa_route", "tc") == "tc":
            firsts.setdefault(r["name"], r)
    emit({"kernels": [{k: ({**r, "launches": launches[r["name"]]})[k]
                       for k in keys} for r in firsts.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
