#!/usr/bin/env python3
"""How far float32 Mamba-2 logits sit from float64 ones, as a share of the
served-tokens tolerance (rtol 1e-4, atol 2e-3; PERF.md §2).

    PYTHONPATH=src python3 tools/mamba_float32_error.py \
        [--device cpu|cuda] [--layers 64] [--d-model 2560] [--tokens 600] \
        [--new 8] [--log-decay segsum|cancel]

Mamba-2 2.7B's config (``--layers`` and ``--d-model`` cut it; the other
widths as published), bf16 weights drawn from ``--seed``, ``--tokens``
prompt tokens and ``--new`` more.  On the same weights: the chunked
forward in float64 compute (the reference precision), the chunked
forward in float32, and the chunked prefill plus recurrent decode steps
in float32 (teacher-forced on the same tokens).  Prints one JSON line:
the largest share of its tolerance an element uses, each float32 path
against float64 and against each other, and the residual stream's
relative L2 error after each layer of the float32 forward.
``--log-decay cancel`` replaces the port's directly summed intra-chunk
log decay (``ssm._segsum``) with the reference's difference of two
cumulative sums, to compare the two in float32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model, ssm

TOL = {"rtol": 1e-4, "atol": 2e-3}


def cancelled_segsum(la):
    """The reference's intra-chunk log decay: cum_i - cum_j."""
    cum = torch.cumsum(la, dim=2)
    return cum[:, :, :, None, :] - cum[:, :, None, :, :]


def share(got, want):
    d = (got.double() - want.double()).abs()
    return float((d / (TOL["atol"] + TOL["rtol"] * want.double().abs()))
                 .max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=64)
    ap.add_argument("--d-model", type=int, default=2560)
    ap.add_argument("--tokens", type=int, default=600)
    ap.add_argument("--new", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-decay", choices=("segsum", "cancel"),
                    default="segsum")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.log_decay == "cancel":
        ssm._segsum = cancelled_segsum
    dev = torch.device(args.device)
    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              n_layers=args.layers, d_model=args.d_model,
                              param_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=g)
    rng = np.random.default_rng(args.seed)
    t, new = args.tokens, args.new
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, t + new)),
                           device=dev)
    rows = {}
    layer_out = model._layer

    def recording(x, layer):
        y = layer_out(x, layer)
        rows.setdefault(model.cfg.compute_dtype, []).append(y[0].double())
        return y

    model._layer = recording
    out = {}
    with torch.inference_mode():
        for dt in ("float64", "float32"):
            model.cfg = dataclasses.replace(cfg, compute_dtype=dt)
            out[dt] = model(toks)[0, t - 1:t + new - 1]
        logits, cache = model.prefill(toks[:, :t])
        dec = [logits[0, 0]]
        for i in range(new - 1):
            logits, cache = model.decode_step(toks[:, t + i:t + i + 1], cache)
            dec.append(logits[0, 0])
        dec = torch.stack(dec)
    f64, f32 = out["float64"], out["float32"]
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
        "layers": args.layers, "d_model": args.d_model, "tokens": t,
        "new": new, "log_decay": args.log_decay,
        "logit_max": float(f64.abs().max()), "logit_std": float(f64.std()),
        "tolerance_used": {"forward32_vs_64": share(f32, f64),
                           "decode32_vs_64": share(dec, f64),
                           "decode32_vs_forward32": share(dec, f32)},
        "per_layer_rel_l2": [float((a - b).norm() / b.norm()) for a, b in
                             zip(rows["float32"], rows["float64"])],
    }))


if __name__ == "__main__":
    main()
