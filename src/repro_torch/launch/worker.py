"""Shard worker process entrypoint — ``python -m repro_torch.launch.worker``.

Launched by :class:`repro_torch.dist.transport.LocalProcessTransport` (and by
``merge_cli worker`` for manual runs): reads a :class:`ShardLease` JSON
document, executes it against the shared workspace, and writes the
result doc the coordinator splices from.

Exit codes:

* ``0`` — lease completed; the result doc exists;
* ``3`` — :class:`~repro_torch.testing.chaos.SimulatedCrash` (armed via the
  lease's chaos field): the staged region and shard journal survive on
  disk for lease re-issue, exactly like a kill -9;
* anything else — a real error (traceback on stderr); the coordinator
  aborts the window.  A lease that names a CUDA device where there is
  none is such an error: it never runs on the CPU.

``--device`` replaces the lease's device (``merge_cli worker --device
cpu`` runs a lease on the host).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

from repro_torch.dist.lease import ShardLease
from repro_torch.dist.worker import run_worker
from repro_torch.testing.chaos import SimulatedCrash

CRASH_EXIT = 3


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.worker",
        description="execute one shard lease against a MergePipe workspace",
    )
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--lease", required=True, help="ShardLease JSON path")
    ap.add_argument("--result", required=True,
                    help="where to write the result doc")
    ap.add_argument("--device", default=None,
                    help="where the worker computes: 'cuda' (fails without "
                         "a card), 'cpu' (the kernels' plain versions); "
                         "default the lease's device")
    args = ap.parse_args(argv)
    lease = ShardLease.read(args.lease)
    if args.device is not None:
        lease = dataclasses.replace(lease, device=args.device)
    try:
        run_worker(args.workspace, lease, result_path=args.result)
    except SimulatedCrash as e:
        print("simulated crash: %s" % e, file=sys.stderr)
        return CRASH_EXIT
    return 0


if __name__ == "__main__":
    sys.exit(main())
