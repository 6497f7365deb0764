"""Training launcher — the JAX package's ``launch/train.py`` in torch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 20 --batch 4 --seq 64 --workspace /tmp/run1 \
        [--device cpu]

Trains on one device, ``--device`` (default ``cuda``, which fails where
there is no card; ``cpu`` runs the plain attention and its autograd).
On the card the model's attention runs the Hopper flash kernels, forward
and backward.  ``--grad-compress`` enables int8 error-feedback gradient
compression (train/grad_compress.py).  ``--production-mesh`` and
``--multi-pod`` (the reference's device meshes) are not ported yet.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.train.data import DataPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainLoop
from repro_torch.train.train_state import init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=arch_ids(), required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--workspace",
                    default=os.path.join(tempfile.gettempdir(), "repro-train"))
    ap.add_argument("--run-id", default="train")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skill", type=int, default=0,
                    help="synthetic-data skill id (expert branches)")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--step-deadline", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    if args.production_mesh or args.multi_pod:
        raise SystemExit("--production-mesh / --multi-pod: the device-mesh "
                         "layer is not ported yet")
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=device)

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    step_fn = make_train_step(model, opt, grad_compression=args.grad_compress)
    snaps = SnapshotStore(args.workspace)

    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(args.seed),
        grad_compression=args.grad_compress,
    )
    loop = TrainLoop(
        model, step_fn, snaps, run_id=args.run_id,
        ckpt_every=args.ckpt_every, step_deadline_s=args.step_deadline,
    )
    state, start = loop.restore_or_init(state)
    pipe = DataPipeline(
        cfg.vocab_size, batch=args.batch, seq=args.seq,
        seed=args.seed, skill=args.skill, start_step=start, device=device,
    )
    try:
        loop.run(state, pipe, num_steps=args.steps, start_step=start)
    finally:
        pipe.close()
    print(f"[train] done; checkpoints under {args.workspace}")


if __name__ == "__main__":
    main()
