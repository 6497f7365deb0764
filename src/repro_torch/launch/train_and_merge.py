"""End-to-end workflow: train expert branches of a model-zoo architecture,
then merge them with MergePipe under an I/O budget and evaluate — the
JAX package's ``examples/train_and_merge.py`` in torch.

This is the paper's target workflow (iterative expert merging inside an
LLM development pipeline), end to end:

  1. init a base model (a dense --arch; default a small qwen3-family
     reduction, --full uses a ~100M config),
  2. branch-train K experts on distinct synthetic skills (each from the
     same seeded base draw),
  3. ANALYZE + budget-aware TIES merge of the expert checkpoints,
  4. evaluate base vs experts vs merged on every skill.

    PYTHONPATH=src python -m repro_torch.launch.train_and_merge \
        [--arch qwen3-14b] [--experts 3] [--steps 30] [--budget 0.5] \
        [--full] [--device cpu]

Training, ANALYZE and the merge run on ``--device``: ``cuda`` (the
default; fails where there is no card) runs the flash-attention and
merge kernels, ``cpu`` their plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import torch

from repro_torch.configs import arch_ids, get_smoke_config
from repro_torch.core import MergePipe
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import build_model, load_flat
from repro_torch.store.checkpoint import flatten_tree
from repro_torch.store.iostats import IOStats, measure
from repro_torch.train.data import DataPipeline, synth_batch, to_device
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_state import init_train_state, make_train_step


def scaled_config(arch: str, full: bool):
    cfg = get_smoke_config(arch)
    if full:  # ~100M-param variant, still CPU-trainable for a few steps
        cfg = dataclasses.replace(
            cfg, n_layers=8, d_model=512, n_heads=8, n_kv_heads=4,
            d_ff=1536, vocab_size=32000,
        )
    return cfg


@torch.no_grad()
def eval_loss(model, vocab, skill, batches=3):
    tot = 0.0
    for s in range(batches):
        b = synth_batch(seed=1234, step=s, batch=4, seq=32, vocab=vocab,
                        skill=skill)
        tot += float(model.loss_fn(to_device(b, model.device)))
    return tot / batches


def main(argv=None) -> dict:
    """Run the workflow; returns the evaluation table
    ``{model name: [loss per skill]}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=arch_ids(), default="qwen3-14b")
    ap.add_argument("--experts", type=int, default=3)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--budget", type=float, default=0.5)
    ap.add_argument("--full", action="store_true",
                    help="~100M-param variant (slower)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = scaled_config(args.arch, args.full)
    model = build_model(cfg, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[setup] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.experts} experts x {args.steps} steps on {device}")

    opt = AdamWConfig(lr=3e-3, warmup_steps=max(args.steps // 10, 1),
                      total_steps=args.steps)
    step = make_train_step(model, opt)

    def fresh():
        """The base: every branch starts from the same seeded draw."""
        return init_train_state(
            model, torch.Generator(device=device).manual_seed(args.seed))

    base = flatten_tree(fresh().params)
    experts = []
    for k in range(args.experts):
        t0 = time.time()
        st = fresh()
        pipe = DataPipeline(cfg.vocab_size, batch=4, seq=32, seed=k,
                            skill=k, device=device)
        try:
            for _ in range(args.steps):
                st, m = step(st, next(pipe))
        finally:
            pipe.close()
        print(f"[train] expert {k} (skill {k}): final loss "
              f"{float(m['loss']):.3f} in {time.time()-t0:.1f}s")
        experts.append(flatten_tree(st.params))

    stats = IOStats()
    table = {}
    with tempfile.TemporaryDirectory() as ws:
        mp = MergePipe(ws, block_size=64 * 1024, stats=stats, device=device)
        mp.register_model("base", base)
        ids = []
        for i, p in enumerate(experts):
            ids.append(mp.register_model(f"skill-{i}", p))

        t0 = time.time()
        with measure(stats) as io:
            res = mp.merge("base", ids, op="ties",
                           theta={"trim_frac": 0.3, "lam": 1.0},
                           budget=args.budget)
        print(f"[merge] {res.sid} in {time.time()-t0:.1f}s — expert read "
              f"{io['expert_read']/1e6:.1f} MB "
              f"(budget {args.budget:.0%} of naive), "
              f"out {io['out_written']/1e6:.1f} MB")
        ex = mp.explain(res.sid)
        print(f"[merge] touched {ex['touched_blocks']} blocks across "
              f"{ex['touched_tensors']} tensors; budget respected: "
              f"{ex['budget_respected']}")
        merged = mp.load(res.sid)
        mp.close()

    print(f"\n{'model':14s}" + "".join(
        f"skill{k:<9d}" for k in range(args.experts)))

    def row(name, flat):
        load_flat(model, flat)
        table[name] = [eval_loss(model, cfg.vocab_size, k)
                       for k in range(args.experts)]
        print(f"{name:14s}" + "".join(f"{x:<14.3f}" for x in table[name]))

    row("base", base)
    for i, p in enumerate(experts):
        row(f"expert-{i}", p)
    row("merged", merged)
    print("\nThe merged model recovers multiple skills from one "
          "checkpoint — with expert I/O bounded by the budget.")
    return table


if __name__ == "__main__":
    main()
