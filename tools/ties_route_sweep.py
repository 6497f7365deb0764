#!/usr/bin/env python3
"""Time TIES's two routes on one NVIDIA card at the smoke's ROUTE_CASES,
the sweep that sets ``ties_route``'s limits.

    python3 tools/ties_route_sweep.py [--reps N] [--passes P]

Runs ``chip_smoke.route_rows`` (the fused kernel and the pair in turns on
the same inputs, bit-equal, each by CUDA events, by wall time from an idle
card to the end of the call, and by host time to the call's return) P
times over the cases, every other pass in reverse order, so a drift of
the host's speed during the sweep shows as a difference between passes.
Prints the card's name and power limit, then one JSON line per case and
pass.  Exits 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=51)
    ap.add_argument("--passes", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ties_route_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(HERE, "src"), HERE]
    import chip_smoke

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(),
          flush=True)
    dev = torch.device("cuda", 0)
    timer = chip_smoke.Timer(dev)
    for p in range(args.passes):
        cases = chip_smoke.ROUTE_CASES[::-1 if p % 2 else 1]
        for row in chip_smoke.route_rows(dev, 0, timer, cases=cases,
                                         reps=args.reps):
            print(json.dumps({"pass": p, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
