"""Budget sweep (API v2) — the JAX package's ``examples/budget_sweep.py``
in torch: the paper's Fig 6 interactively — how the expert-read budget
trades I/O for output fidelity — run as ONE batch.

The whole sweep is submitted to a Session and planned together: every
expert block is physically read once and fans out to every sweep point
that selected it, so the J-point sweep pays roughly the bytes of its
*largest* budget instead of the sum of all budgets (O(K) instead of
O(K·J) expert reads).

    PYTHONPATH=src python -m repro_torch.launch.budget_sweep \
        [--seed 7] [--device cpu]

ANALYZE and the full merge run on ``--device``: ``cuda`` (the default;
fails where there is no card) runs the sketch and TIES kernels, ``cpu``
their plain versions.  The sweep itself runs on the stream engine (the
numpy host path) on either device, as the sequential baseline it is
compared with.  Prints what the reference prints; returns the table, the
batch's sharing, each committed snapshot's tensor hashes and the
Session's IOStats.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.api import MergeSpec, Session
from repro_torch.launch.quickstart import iostats_bytes, snapshot_hashes
from repro_torch.store.iostats import IOStats, measure


def main(argv=None) -> dict:
    """Run the sweep; returns its numbers (see the module doc)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    shapes = {f"layer{i}/w": (128, 512) for i in range(16)}
    base = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    stats = IOStats()
    with tempfile.TemporaryDirectory() as ws, Session(
        ws, block_size=32 * 1024, stats=stats, device=args.device
    ) as sess:
        sess.register_model("base", base)
        ids = []
        for i in range(10):
            ex = {k: v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
                  for k, v in base.items()}
            ids.append(sess.register_model(f"e{i}", ex))

        full_sid = sess.run(
            MergeSpec.build("base", ids, op="ties",
                            theta={"trim_frac": 0.3}, name="full")
        ).sid
        full = sess.load(full_sid)

        # submit the whole sweep, execute as one shared-read batch
        fracs = (0.1, 0.25, 0.5, 0.75, 1.0)
        handles = [
            sess.submit(
                MergeSpec.build("base", ids, op="ties",
                                theta={"trim_frac": 0.3},
                                budget=f"{int(frac * 100)}%",
                                reuse_plan=False),
                sid=f"b{frac}",
            )
            for frac in fracs
        ]
        with measure(stats) as io:
            t0 = time.time()
            results = sess.run_all(shared_reads=True, compute="stream")  # same engine as the sequential baseline
            wall = time.time() - t0

        batch = results[0].stats["batch"]
        print(f"{'budget':>8s} {'planned MB':>10s} {'rel-l2 vs full':>14s} "
              f"{'blocks':>7s}")
        rows = []
        for frac, h in zip(fracs, handles):
            out = sess.load(h.sid)
            num = sum(float(np.sum((out[k] - full[k]) ** 2)) for k in out)
            den = sum(float(np.sum(full[k] ** 2)) for k in out)
            ex = sess.explain(h.sid)
            print(f"{frac:>8.0%} {h.result.stats['c_expert_hat']/1e6:>10.2f} "
                  f"{(num/den)**0.5:>14.2e} {ex['touched_blocks']:>7d}")
            rows.append({"budget": frac,
                         "planned_mb": h.result.stats["c_expert_hat"] / 1e6,
                         "rel_l2": (num / den) ** 0.5,
                         "blocks": ex["touched_blocks"],
                         "budget_b": ex["budget_b"],
                         "planned": ex["c_expert_hat"]})
        print(f"\nbatch wall       : {wall:.2f}s")
        print(f"expert MB read   : {io['expert_read']/1e6:.2f} "
              f"(sequential would read {batch['c_expert_hat_sum']/1e6:.2f})")
        print(f"sharing factor   : {batch['sharing_factor']:.2f}x "
              f"({batch['cache']['hits']} cached block reads)")
        return {
            "rows": rows,
            "expert_mb": io["expert_read"] / 1e6,
            "sequential_mb": batch["c_expert_hat_sum"] / 1e6,
            "sharing_factor": batch["sharing_factor"],
            "cached_block_reads": batch["cache"]["hits"],
            "batch_wall_s": wall,
            "snapshots": {name: snapshot_hashes(sess, sid) for name, sid in
                          [("full", full_sid)]
                          + [(h.sid, h.sid) for h in handles]},
            "iostats": iostats_bytes(stats),
        }


if __name__ == "__main__":
    main()
