"""The merge-then-serve loop, end to end — the JAX package's
``examples/serve_merged.py`` in torch: train two experts, submit the
merge to a live :class:`~repro_torch.api.MergeService` (the always-on
job API — admission control, budget arbitration, cancellation), wait on
the future-style handle, and hand the committed snapshot to the serving
engine.

    PYTHONPATH=src python -m repro_torch.launch.serve_merged \
        [--arch granite-3-8b] [--steps 20] [--device cpu]

Training, the merge and serving run on ``--device``: ``cuda`` (the
default; fails where there is no card) runs the flash-attention and
merge kernels, ``cpu`` their plain versions.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.api import MergeService, MergeSpec
from repro_torch.configs import arch_ids, get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model, load_flat
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.store.checkpoint import flatten_tree
from repro_torch.train.data import DataPipeline
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step


def main(argv=None) -> list:
    """Run the loop; returns the served requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=arch_ids(), default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    model = build_model(cfg, device=device)
    step = make_train_step(
        model, AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=args.steps))

    def fresh():
        """The base: both experts start from the same seeded draw."""
        return init_train_state(
            model, torch.Generator(device=device).manual_seed(args.seed))

    base = flatten_tree(fresh().params)
    experts = []
    for skill in range(2):
        st = fresh()
        pipe = DataPipeline(cfg.vocab_size, batch=4, seq=32, seed=skill,
                            skill=skill, device=device)
        try:
            for _ in range(args.steps):
                st, _ = step(st, next(pipe))
        finally:
            pipe.close()
        experts.append(flatten_tree(st.params))

    with tempfile.TemporaryDirectory() as ws, MergeService(
        ws, block_size=32 * 1024, budget="1GiB", tenants={"serving": 1.0},
        device=device,
    ) as svc:
        svc.register_model("base", base)
        ids = [svc.register_model(f"e{i}", p)
               for i, p in enumerate(experts)]

        # submit the merge like a serving-path tenant would: asynchronous,
        # budget-arbitrated, cancellable; the handle is a future
        handle = svc.submit(
            MergeSpec.build("base", ids, op="ties",
                            theta={"trim_frac": 0.3}, budget="50%",
                            name="serve-merged"),
            tenant="serving", priority=5,
        )
        res = handle.wait()
        print(f"[merge] committed {res.sid}  "
              f"(job {handle.job_id}, window {handle.window_id}, "
              f"expert_read={res.stats['c_expert_run'] / 1e6:.1f}MB)")
        load_flat(model, svc.load(res.sid))

    engine = ServeEngine(model, batch_slots=4, max_len=64)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(rid=i,
                prompt=rng.integers(0, cfg.vocab_size, size=8)
                .astype(np.int32),
                max_new_tokens=12)
        for i in range(args.requests)
    ]
    engine.run(reqs)
    for r in reqs:
        print(f"[serve] req {r.rid}: {len(r.out_tokens)} tokens -> "
              f"{r.out_tokens[:8]}...")
    if not all(r.done for r in reqs):
        raise RuntimeError("serve: a request did not complete")
    print("[serve] all requests completed on the merged model")
    return reqs


if __name__ == "__main__":
    main()
