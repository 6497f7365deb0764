#!/usr/bin/env python3
"""Time the merge path's host work and a training checkpoint's save for
several checkouts of this repository on one NVIDIA card, in turns.

    python3 tools/compare_host_path.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one; an unpacked
``git archive`` of another commit beside it).  For each tree, in the
order given, a fresh process imports that tree's ``repro_torch`` and, in
a workspace under this checkout's gitignored ``build/``: registers the
store phase's base and four experts at depth 1
(``chip_smoke.populate_store`` of this checkout), ANALYZEs them, times one
Session
merge each at CASES (wall seconds, card synchronised), then
``save_train_checkpoint`` of a float32 state the size of the smoke's
loop-phase TrainState (params, Adam's two moments).  One JSON line per
tree, then the card's name and power limit.  Give the trees as parent,
change, change, parent: host times move by tens of percent between runs
of the same tree, so read the spread beside the difference.

Exits 2 without a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

#: (label, [(operator, budget), ...]): one Session batch each
CASES = [
    ("avg_50", [("avg", "50%")]),
    ("ties_50", [("ties", "50%")]),
    ("dare_50", [("dare", "50%")]),
    ("ties_2", [("ties", "2%")]),
    ("full_4", [("avg", "100%"), ("ta", "100%"), ("ties", "100%"),
                ("dare", "100%")]),
]
#: float32 elements of each tensor of the checkpoint: the depth-1
#: Qwen2-1.5B's embedding, MLP, attention and the rest, each saved as
#: params and Adam's two moments (3.36 GB)
CKPT = (233_373_696, 8_960 * 1536 * 3, 1536 * 1536 * 2, 1536 * 256 * 2)

_CHILD = r"""
import json, os, shutil, sys, time
import numpy as np
import torch

HERE = sys.argv[1]
CASES, CKPT = json.loads(sys.argv[2]), json.loads(sys.argv[3])
sys.path.insert(1, HERE)
import chip_smoke as cs
from repro_torch.api import MergeSpec, Session
from repro_torch.store.checkpoint import save_train_checkpoint
from repro_torch.store.snapshot import SnapshotStore

out = {}


def timed(label, fn):
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    out[label] = time.perf_counter() - t


root = os.path.join(HERE, "build", "host-path-ws")
shutil.rmtree(root, ignore_errors=True)
dev = torch.device("cuda", 0)
sess = Session(root, block_size=128 * 1024, device=dev)
ids = []
timed("register", lambda: ids.extend(
    cs.populate_store(sess, 1, 4, 0, dev)[0]))
timed("analyze", lambda: sess.ensure_analyzed("base", ids))
for label, jobs in CASES:
    for op, budget in jobs:
        sess.submit(MergeSpec.build("base", ids, op=op,
                                    theta=dict(cs.OPS)[op], budget=budget,
                                    reuse_plan=False), sid=f"{label}-{op}")
    timed(label, lambda: sess.run_all(prefer_packed=False,
                                      cache_max_bytes=16 << 30))
sess.close()
rng = np.random.default_rng(0)
state = {f"t{i}/{part}": rng.standard_normal(n, dtype=np.float32)
         for part in ("params", "mu", "nu") for i, n in enumerate(CKPT)}
store = SnapshotStore(os.path.join(root, "checkpoints"))
timed("checkpoint_save", lambda: save_train_checkpoint(store, 2, state))
out["checkpoint_gb"] = sum(a.nbytes for a in state.values()) / 1e9
shutil.rmtree(root, ignore_errors=True)
print(json.dumps({"seconds": out}))
"""


def main() -> int:
    trees = sys.argv[1:]
    if not trees:
        print(__doc__, file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("compare_host_path: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for tree in trees:
        env = dict(os.environ, PYTHONPATH=os.path.join(os.path.abspath(tree),
                                                       "src"))
        proc = subprocess.run(
            [sys.executable, "-c", _CHILD, here, json.dumps(CASES),
             json.dumps(CKPT)],
            env=env, capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return 1
        print(json.dumps({"tree": tree, **json.loads(
            proc.stdout.strip().splitlines()[-1])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
