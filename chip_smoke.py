#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's merge path once on one NVIDIA card.

    python3 chip_smoke.py            # needs one CUDA card; exits 2 without

Configuration: Qwen2-1.5B at its published widths (d_model 1536, 12 heads
/ 2 KV heads, head_dim 128, d_ff 8960, vocab 151936, QKV bias, tied
embedding), stored in bfloat16, depth cut to 4 of 28 decoder layers plus
the embedding and the final norm.  A base model and K = 4 "full"
experts (expert = base + 0.02 * N(0, 1) per tensor) are made on the card
from ``--seed``; nothing is downloaded.  Default 128 KiB blocks.

Phases, one JSON line each:

  build    nvcc builds src/repro_torch/csrc/merge_block.cu (sm_90a)
  kernels  each Hopper kernel against its plain PyTorch version at the
           merge path's largest window group (NB = 32, K = 4, W = 65,536
           float32): max abs error (rtol = atol = 1e-5), median CUDA-event
           times of kernel, plain version, a device-to-device copy of the
           same bytes and (where one exists) one PyTorch library call,
           and the HBM-bytes bound
  parity   one full-width decoder layer, 50% budget: MergePipe.merge on
           the card (pipelined engine, torch kernels) against the numpy
           stream engine, for avg / ta / ties / dare: bf16 outputs within
           one ulp, equal per-category I/O bytes
  merge    the whole configuration, 50% budget, all four operators
           through MergePipe.merge on the card: wall time, I/O bytes,
           budget soundness, windows, kernel launches, and from
           torch.profiler the kernels' device time, the device's busy
           time by activity and its idle share

Then the kernels' contract line, and last {"ok": true, "device": ...}.
Any failure raises and exits non-zero.  The workspace lives under
build/ (gitignored) and is removed at the end.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Qwen2-1.5B (HF Qwen/Qwen2-1.5B config.json)
D_MODEL, N_HEADS, N_KV, HEAD_DIM, D_FF, VOCAB, N_LAYERS = (
    1536, 12, 2, 128, 8960, 151936, 28)
OPS = [("avg", {}), ("ta", {"lam": 0.7}), ("ties", {"trim_frac": 0.3}),
       ("dare", {"density": 0.5, "seed": 3})]
# H100 data sheet (SXM): HBM bytes/s, float32 and float64 vector FLOP/s
PEAK = {"bytes": 3.35e12, "f32": 67e12, "f64": 34e12}
TOL = 1e-5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def qwen2_shapes(n_layers: int, embed: bool):
    shapes = {}
    if embed:
        shapes["model.embed_tokens.weight"] = (VOCAB, D_MODEL)
    q, kv = N_HEADS * HEAD_DIM, N_KV * HEAD_DIM
    for i in range(n_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "self_attn.q_proj.weight": (q, D_MODEL),
            p + "self_attn.q_proj.bias": (q,),
            p + "self_attn.k_proj.weight": (kv, D_MODEL),
            p + "self_attn.k_proj.bias": (kv,),
            p + "self_attn.v_proj.weight": (kv, D_MODEL),
            p + "self_attn.v_proj.bias": (kv,),
            p + "self_attn.o_proj.weight": (D_MODEL, q),
            p + "mlp.gate_proj.weight": (D_FF, D_MODEL),
            p + "mlp.up_proj.weight": (D_FF, D_MODEL),
            p + "mlp.down_proj.weight": (D_MODEL, D_FF),
            p + "input_layernorm.weight": (D_MODEL,),
            p + "post_attention_layernorm.weight": (D_MODEL,),
        })
    if embed:
        shapes["model.norm.weight"] = (D_MODEL,)
    return shapes


def populate(mp, shapes, k, seed, device):
    """Register base + k full experts, made on ``device`` in bf16."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    base = {}
    for name, shape in shapes.items():
        if name.endswith("norm.weight"):
            t = torch.ones(shape, device=device)
        else:
            t = 0.02 * torch.randn(shape, generator=g, device=device)
        base[name] = t.to(torch.bfloat16)
    mp.register_model("base", base)
    ids = []
    for e in range(k):
        mp.register_model(f"expert-{e}", {
            n: (t.float() + 0.02 * torch.randn(t.shape, generator=g, device=device)
                ).to(torch.bfloat16)
            for n, t in base.items()
        })
        ids.append(f"expert-{e}")
    n_params = sum(t.numel() for t in base.values())
    return ids, n_params


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
            "name": name, "route": "cuda",
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
    emit({"phase": "kernels", "tolerance": TOL, "kernels": rows})
    return rows


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps between two uint16 word arrays."""
    import numpy as np

    def ordered(u):
        u = u.astype(np.int32)
        return np.where(u & 0x8000, -(u & 0x7FFF), u)

    return np.abs(ordered(a) - ordered(b))


def phase_parity(root, device, seed, block_size):
    import numpy as np

    from repro_torch.core.api import MergePipe
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "parity"), block_size=block_size,
                   device=device)
    ids, n_params = populate(mp, qwen2_shapes(1, embed=False), 4, seed, device)
    out = {"phase": "parity", "layers": 1, "params": n_params, "ops": {}}
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
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import MergePipe
    from repro_torch.kernels import merge_block as mb
    from repro_torch.kernels import ops
    from repro_torch.store.iostats import measure

    mp = MergePipe(os.path.join(root, "merge"), block_size=block_size,
                   device=device)
    t0 = time.perf_counter()
    shapes = qwen2_shapes(layers, embed=True)
    ids, n_params = populate(mp, shapes, 4, seed, device)
    t_reg = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp.ensure_analyzed("base", ids)
    t_analyze = time.perf_counter() - t0
    out = {"phase": "merge", "layers": layers, "params_per_model": n_params,
           "k": len(ids), "budget": 0.5, "register_s": t_reg,
           "analyze_s": t_analyze, "ops": {}}
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
    activities = [ProfilerActivity.CUDA if device.type == "cuda"
                  else ProfilerActivity.CPU]
    # the main path: launch counts start at 0 here and are read at the end
    mb.reset_launches()
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
        launches = {n: mb.LAUNCHES[n] - before[n] for n in mb.LAUNCHES}
        want = "dare_merge" if op == "dare" else (
            "ties_merge" if op == "ties" else "linear_merge")
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
            "compute_stage_s": stage_s[0],
            "device_busy_ms": sum(device_ms.values()),
            "device_idle_share": 1 - sum(device_ms.values()) / 1e3 / wall,
            "device_top_ms": dict(sorted(device_ms.items(),
                                         key=lambda kv: -kv[1])[:6]),
        }
        del merged
    ops.merge_blocks = real_merge_blocks
    out["launches"] = dict(mb.LAUNCHES)
    mp.close()
    emit(out)
    return out["launches"]


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
          "reduced": f"depth {args.layers} of {N_LAYERS} decoder layers "
                     f"(+ embedding, final norm); widths as published"})

    t0 = time.perf_counter()
    lib = mb.build()
    with open(lib[: -len(".so")] + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(lib, HERE), "ptxas": ptxas})

    rows = phase_kernels(device, args.seed)
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="smoke-ws-", dir=os.path.join(HERE, "build"))
    try:
        phase_parity(root, device, args.seed, args.block_size)
        launches = phase_merge(root, device, args.seed, args.block_size,
                               args.layers)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "copy_ms")
    emit({"kernels": [{k: ({**r, "launches": launches[r["name"]]})[k]
                       for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
