"""Training launcher — the JAX package's ``launch/train.py`` in torch.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --smoke --steps 20 --batch 4 --seq 64 --workspace /tmp/run1 \
        [--device cpu]

Trains under a device mesh, as the reference does: by default
``make_debug_mesh()`` over the ranks there are (one process: a one-rank
group and the (1, 1) mesh over ``--device``), with ``--production-mesh``
the (16, 16) mesh and with ``--multi-pod`` the (2, 16, 16) one, which
need a process group of 256 or 512 ranks (``torchrun`` sets one up
through its environment) and fail where it is missing.  A group the
launcher opened itself it closes at the end.  Parameters, the
optimizer's moments and the batches are DTensors placed by
``train_rules``; ``--device`` defaults to ``cuda``, which fails where
there is no card (``cpu`` runs the plain attention and its autograd).
On the card the model's attention runs the Hopper flash kernels, forward
and backward, on each rank's shard (``local_map``).  ``--grad-compress``
enables int8 error-feedback gradient compression
(train/grad_compress.py).  The
vision and audio families exit with an error: their loss needs context
embeddings (``vision_embeds`` / ``audio_embeds``) that the synthetic
data pipeline does not make, in the reference's launcher as here; train
them through ``make_train_step`` with those in the batch.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs import arch_ids, get_config, get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import (
    ensure_process_group,
    make_debug_mesh,
    make_production_mesh,
)
from repro_torch.launch.sharding import distribute_parameters
from repro_torch.models import build_model, shardctx
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.train.data import DataPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_loop import TrainLoop
from repro_torch.train.train_state import init_train_state, make_train_step

# the families whose loss reads context embeddings from the batch
_NEEDS_CONTEXT = {"vlm": "vision_embeds", "audio": "audio_embeds"}


def build_on_mesh(cfg, device: torch.device, mesh, rules, opt: AdamWConfig,
                  seed: int, grad_compression: bool = False):
    """The launcher's model, train step and state, inside
    ``use_mesh(mesh, rules)``: the model built on ``device``, its
    parameters made DTensors placed by its ``param_specs``, then drawn
    from ``seed`` (the same values as a meshless draw from ``seed``) with
    the optimizer's moments placed as they are."""
    model = build_model(cfg, device=device)
    distribute_parameters(model, mesh, rules)
    step_fn = make_train_step(model, opt, grad_compression=grad_compression)
    state = init_train_state(
        model, torch.Generator(device=device).manual_seed(seed),
        grad_compression=grad_compression)
    return model, step_fn, state


def _train(args, cfg, device: torch.device) -> None:
    """The run, inside the default process group."""
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if args.production_mesh or args.multi_pod:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device_type=device.type)
    else:
        mesh = make_debug_mesh(device_type=device.type)
    rules = shardctx.train_rules(args.multi_pod)

    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    snaps = SnapshotStore(args.workspace)

    with shardctx.use_mesh(mesh, rules):
        model, step_fn, state = build_on_mesh(
            cfg, device, mesh, rules, opt, args.seed, args.grad_compress)
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

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in _NEEDS_CONTEXT:
        raise SystemExit(f"{args.arch}: the {cfg.family} family's loss needs "
                         f"{_NEEDS_CONTEXT[cfg.family]} in every batch, and "
                         f"the launcher's data pipeline supplies no context "
                         f"embeddings")
    device = resolve_device(args.device)
    opened = ensure_process_group(device.type)
    try:
        _train(args, cfg, device)
    finally:
        if opened:
            dist.destroy_process_group()
    print(f"[train] done; checkpoints under {args.workspace}")


if __name__ == "__main__":
    main()
