"""MergePipe quickstart (API v2) — the JAX package's
``examples/quickstart.py`` in torch: register models, declare a
MergeSpec with a typed budget, run it, audit the lineage — the paper's
Fig 3 workflow.

    PYTHONPATH=src python -m repro_torch.launch.quickstart \
        [--seed 0] [--device cpu]

The merges (TIES, and a TIES over a DARE sub-merge) and ANALYZE run on
``--device``: ``cuda`` (the default; fails where there is no card) runs
the merge and sketch kernels, ``cpu`` their plain versions.  Prints what
the reference prints; returns its numbers, the graph's lineage, each
committed snapshot's tensor hashes and the Session's IOStats.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np

from repro_torch.api import MergeSpec, Session
from repro_torch.store.iostats import IOStats, measure


def snapshot_hashes(sess, sid) -> dict:
    """Each tensor's content hash in a committed snapshot (blake2b over
    its bytes, re-validated at commit): equal hashes are equal bytes."""
    with sess.snapshots.models.open_model(sid) as r:
        return {t: r.spec(t)["hash"] for t in r.tensor_names()}


def iostats_bytes(stats) -> dict:
    """Bytes per category of every IOStats counter (read, written, cache
    hits / misses by tier, skipped)."""
    return {kind: {cat: c["bytes"] for cat, c in sorted(cats.items())}
            for kind, cats in stats.snapshot().items()
            if isinstance(cats, dict)}


def main(argv=None) -> dict:
    """Run the quickstart; returns its numbers (see the module doc)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    base = {
        "layer0/w": rng.normal(size=(256, 384)).astype(np.float32),
        "layer1/w": rng.normal(size=(384, 256)).astype(np.float32),
        "embed": rng.normal(size=(1024, 64)).astype(np.float32),
    }
    experts = [
        {k: v + 0.03 * rng.normal(size=v.shape).astype(np.float32)
         for k, v in base.items()}
        for _ in range(4)
    ]

    stats = IOStats()
    with tempfile.TemporaryDirectory() as ws, Session(
        ws, block_size=64 * 1024, stats=stats, device=args.device
    ) as sess:
        sess.register_model("base", base)
        ids = [sess.register_model(f"expert-{i}", e)
               for i, e in enumerate(experts)]

        # Declare the merge: typed budget ("40%" of the naive full-read
        # expert bytes — no int/float ambiguity), schema-checked theta.
        spec = MergeSpec.build(
            "base", ids, op="ties",
            theta={"trim_frac": 0.3, "lam": 1.0},
            budget="40%",
        )
        with measure(stats) as io:
            result = sess.run(spec)
        naive = sum(sum(a.nbytes for a in e.values()) for e in experts)
        print(f"committed snapshot: {result.sid}")
        print(f"expert bytes read : {io['expert_read']:,} "
              f"(naive would read {naive:,})")
        print(f"base/out bytes    : {io['base_read']:,} / {io['out_written']:,}")

        # the audit record: what was merged, which blocks, which experts,
        # which declarative spec produced it
        audit = sess.explain(result.sid)
        print(json.dumps(audit, indent=2, default=str)[:1200])

        # merge graphs are specs too: TIES over a DARE sub-merge
        sub = MergeSpec.build("base", ids[:2], op="dare",
                              theta={"density": 0.5, "seed": 1}, name="sub")
        graph = MergeSpec.build("base", [sub, ids[2]], op="ties",
                                theta={"trim_frac": 0.3}, name="graph")
        sess.run(graph)
        lineage = sess.merge_graph("graph")
        print("merge graph lineage:", json.dumps(lineage, indent=2))

        merged = sess.load(result.sid)
        print("merged tensors:", {k: v.shape for k, v in merged.items()})
        assert sess.verify(result.sid)
        return {
            "sid": result.sid,
            "expert_read": io["expert_read"],
            "base_read": io["base_read"],
            "out_written": io["out_written"],
            "naive": naive,
            "budget_b": audit["budget_b"],
            "planned": audit["c_expert_hat"],
            "shapes": {k: tuple(v.shape) for k, v in merged.items()},
            "lineage": lineage,
            "snapshots": {name: snapshot_hashes(sess, sid) for name, sid in
                          (("ties", result.sid), ("sub", "sub"),
                           ("graph", "graph"))},
            "iostats": iostats_bytes(stats),
        }


if __name__ == "__main__":
    main()
