#!/usr/bin/env python3
"""Ablate the float32 tensor-core kernels (the "tf32x3" route: the
forward ``flash_attention_tf32_kernel`` and the backward
``fa_backward_tf32``) on one NVIDIA card: which of their parts is right,
and what each costs.

    python3 tools/ablate_flash_tf32.py [VARIANT ...]   # needs one CUDA card

Builds variants of ``src/repro_torch/csrc/flash_attention.cu`` and
``flash_attention_bwd.cu``, each the committed sources changed by text
substitutions (VARIANTS below), as copies of ``src/repro_torch`` under
``build/ablate_tf32/`` (gitignored), all at once; then, in the order
given (all by default), for each variant in a process of its own: the
forward at every pair of TC_HEAD_DIMS on small causal, windowed and
cross shapes against the plain version in float32 (the largest error,
FA_TOL 2e-5); the forward at the smoke's float32 rows and the backward
at its float32 training rows by the kernels' mean device time
(``torch.profiler``, REPS calls, each after a 1 GiB L2 flush), each
backward's largest error against autograd through the plain version and
whether it meets BWD_TOL (rtol 1e-4, atol 1e-5); and the kernels'
registers and spills from the builds' ``-Xptxas -v`` logs.  One JSON
line a variant, then the card's name and power limit.  Exits 2 without a
card, 1 if a variant does not build or run.
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
OUT_DIR = os.path.join(HERE, "build", "ablate_tf32")
FWD = "flash_attention.cu"
BWD = "flash_attention_bwd.cu"

#: name -> [(source, old, new, count)] substitutions
VARIANTS = {
    "base": [],
    # no k-step of Q in registers at (192, 128): one CTA an SM
    "q_in_smem": [(FWD, "  return HD == 192 ? 12 : 0;\n", "  return 0;\n",
                   1)],
    # the forward's S summed on the tensor cores in one running
    # accumulator, not each k-step added in float32
    "s_running": [(FWD, "gemm_tf32x3_rn<BK, HD / 8>(s, qfrag, ks, ks_lo, "
                        "Steps<BK>{});",
                   "gemm_tf32x3<BK, HD / 8>(s, qfrag, ks, ks_lo, "
                   "Steps<BK>{}, false);", 1)],
    # the dK / dV kernel's S summed in float32 a k-step at (192, 128) too
    "dkdv_s_rn": [(BWD, "    if constexpr (HD == 192)  // no registers for two "
                        "steps in flight\n",
                   "    if constexpr (false)\n", 1)],
    # the backward's dP summed so
    "dp_running": [(BWD, "gemm_tf32x3_rn<BN, HDV / 8>(dp, do_rows, vs, vs_lo, "
                         "Steps<BN>{});",
                    "gemm_tf32x3<BN, HDV / 8>(dp, do_rows, vs, vs_lo, "
                    "Steps<BN>{}, false);", 2)],
    # dQ^T's blocks in one product of 64 queries at (256, 256) too
    "dq_nq64": [(BWD, "  constexpr int NQ = HD > 192 ? 32 : 64;",
                 "  constexpr int NQ = 64;", 1)],
}
REPS = 10

_CHILD = r"""
import json, re, sys
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

reps = int(sys.argv[1])
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
g = torch.Generator(device=dev).manual_seed(0)


def rand(*shape):
    return torch.randn(shape, generator=g, device=dev)


def device_ms(f, pattern=r"flash_attention_tf32_kernel"):
    for _ in range(3):
        f()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            f()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0)
             or getattr(e, "self_cuda_time_total", 0)
             for e in prof.key_averages() if re.search(pattern, e.key))
    return us / 1e3 / reps


out = {"max_abs_err": {}, "device_ms": {}}
for hd, hdv in fa.TC_HEAD_DIMS:
    worst = 0.0
    for b, sq, sk, h, hkv, causal, window, qoff in (
            (2, 130, 130, 4, 2, True, 0, 0), (1, 100, 150, 4, 4, False, 0, 0),
            (1, 300, 300, 4, 1, True, 70, 0), (1, 1, 200, 4, 2, True, 0, 199)):
        q, k, v = rand(b, sq, h, hd), rand(b, sk, hkv, hd), rand(b, sk, hkv, hdv)
        got = fa.launch(q, k, v, causal, window, qoff, "tf32x3")
        want = ref.flash_attention_ref(q, k, v, causal, window, qoff)
        worst = max(worst, float((got - want).abs().max()))
    out["max_abs_err"][f"{hd}-{hdv}"] = worst
for label, (b, s, h, hkv, hd, hdv, window) in (
        ("mla_prefill_f32", (1, 2048, 16, 16, 192, 128, 0)),
        ("rg_prefill_f32", (1, 3072, 16, 1, 256, 256, 2048)),
        ("prefill_window_f32", (1, 2048, 12, 2, 128, 128, 512))):
    q, k, v = rand(b, s, h, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hdv)
    out["device_ms"][label] = device_ms(
        lambda: fa.launch(q, k, v, True, window, 0, "tf32x3"))
    got = fa.launch(q, k, v, True, window, 0, "tf32x3")
    want = ref.flash_attention_ref(q, k, v, True, window, 0,
                                   skip_masked_chunks=True)
    out["max_abs_err"][label] = float((got - want).abs().max())
out["bwd_max_abs_err"], out["bwd_ok"] = {}, {}
for label, (b, s, h, hkv, hd, hdv, window) in (
        ("mla_train_f32", (2, 2048, 16, 16, 192, 128, 0)),
        ("rg_train_f32", (1, 3072, 16, 1, 256, 256, 2048)),
        ("train_f32", (2, 1024, 12, 2, 128, 128, 0))):
    q, k, v = rand(b, s, h, hd), rand(b, s, hkv, hd), rand(b, s, hkv, hdv)
    do = rand(b, s, h, hdv)
    o, lse = fa._forward(q, k, v, True, window, 0, "tf32x3", with_lse=True)
    call = lambda: fa.backward(do, q, k, v, o, lse, True, window)
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(*qkv, True, window, 0),
                               qkv, do)
    got = call()
    out["bwd_max_abs_err"][label] = max(float((a - w).abs().max())
                                        for a, w in zip(got, want))
    out["bwd_ok"][label] = all(torch.allclose(a, w, rtol=1e-4, atol=1e-5)
                               for a, w in zip(got, want))
    out["device_ms"][label] = device_ms(call, r"_tf32_kernel|fa_bwd_")
    del q, k, v, do, o, lse, qkv, want, got
ptxas = {}
for lib in (fa.LIBRARY, fa.BWD_LIBRARY):
    with open(lib.log_path()) as f:
        log = f.read()
    for name, body in re.findall(
            r"Compiling entry function '(\S+)'(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        m = re.search(r"(attention|dkdv|dq)_tf32_kernelILi(\d+)ELi(\d+)E",
                      name)
        if m:
            regs = re.search(r"Used (\d+) registers", body)
            spill = re.search(r"(\d+) bytes spill stores", body)
            ptxas["-".join(m.groups())] = [int(regs.group(1)),
                                           int(spill.group(1))]
    out.setdefault("serialised", []).extend(sorted(set(re.findall(
        r"\((C75(?:12|15|20))\).*?function '\S+?tf32_kernelILi(\d+)",
        log))))
out["registers_spill_stores"] = ptxas
print(json.dumps(out))
"""

_BUILD = r"""
from repro_torch.kernels import flash_attention as fa
fa.LIBRARY.build()
fa.BWD_LIBRARY.build()
"""


def make_variant(name: str) -> str:
    """A copy of the package with ``name``'s substitutions; its root."""
    root = os.path.join(OUT_DIR, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(PACKAGE, os.path.join(root, "src", "repro_torch"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for src, old, new, count in VARIANTS[name]:
        path = os.path.join(root, "src", "repro_torch", "csrc", src)
        with open(path) as f:
            text = f.read()
        if text.count(old) != count:
            raise SystemExit(f"{name}: {old[:60]!r} found "
                             f"{text.count(old)} times, want {count}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return root


def run(root: str, code: str, *args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return subprocess.run([sys.executable, "-c", code, *args], env=env,
                          capture_output=True, text=True, check=False)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_flash_tf32: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    roots = {name: make_variant(name) for name in dict.fromkeys(names)}
    with ThreadPoolExecutor(len(roots)) as ex:  # one nvcc a variant
        builds = dict(zip(roots, ex.map(
            lambda n: run(roots[n], _BUILD), roots)))
    bad = {n: p.stderr[-2000:] for n, p in builds.items() if p.returncode}
    if bad:
        print(json.dumps({"build_failed": bad}))
        return 1
    for name in names:
        proc = run(roots[name], _CHILD, str(REPS))
        if proc.returncode:
            print(json.dumps({"variant": name,
                              "failed": proc.stderr[-3000:]}))
            return 1
        print(json.dumps({"variant": name, **json.loads(proc.stdout)}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
