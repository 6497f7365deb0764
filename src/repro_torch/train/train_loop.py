"""Fault-tolerant training loop — the JAX package's
``train/train_loop.py`` in torch.

Production behaviors, scaled to one card:
  * checkpoint every N steps through the transactional snapshot layer
    (atomic publish — a crash mid-save can never corrupt the latest
    checkpoint);
  * resume-from-latest on start: the checkpoint is copied into the
    initial state's tensors, on their device;
  * the data pipeline needs no persisted state beyond the step cursor
    (stateless indexing);
  * straggler mitigation hook: a per-step deadline; steps that exceed it
    are logged and counted (timed after synchronising the model's
    device, in place of ``jax.block_until_ready``);
  * optional failure injection (``crash_at_step``) used by the tests to
    prove restart-exactness.

The step runs eagerly (there is no ``jax.jit``); it updates the state in
place.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.store.checkpoint import (
    latest_checkpoint,
    load_train_checkpoint,
    save_train_checkpoint,
)
from repro_torch.store.snapshot import SnapshotStore
from repro_torch.train.data import DataPipeline
from repro_torch.train.train_state import TrainState


class TrainLoop:
    def __init__(
        self,
        model,
        train_step: Callable,
        snapshots: SnapshotStore,
        run_id: str = "train",
        ckpt_every: int = 50,
        step_deadline_s: float = 0.0,  # 0 = no straggler tracking
        log_fn: Callable[[str], None] = print,
    ):
        self.model = model
        self.train_step = train_step
        self.snapshots = snapshots
        self.run_id = run_id
        self.ckpt_every = ckpt_every
        self.step_deadline_s = step_deadline_s
        self.log = log_fn
        self.straggler_steps: List[int] = []

    def restore_or_init(self, init_state: TrainState) -> Tuple[TrainState, int]:
        sid = latest_checkpoint(self.snapshots, self.run_id)
        if sid is None:
            return init_state, 0
        state, step = load_train_checkpoint(self.snapshots, sid, init_state)
        self.log(f"[train] resumed from {sid} at step {step}")
        return state, step

    def _sync(self) -> None:
        device = self.model.device
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run(
        self,
        state: TrainState,
        pipeline: DataPipeline,
        num_steps: int,
        start_step: int = 0,
        crash_at_step: Optional[int] = None,
        metrics_cb: Optional[Callable[[int, Dict], None]] = None,
    ) -> TrainState:
        losses = []
        for step in range(start_step, num_steps):
            if crash_at_step is not None and step == crash_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            batch = next(pipeline)
            state, metrics = self.train_step(state, batch)
            if self.step_deadline_s:
                # straggler detection: wait for the step and time it
                self._sync()
                dt = time.time() - t0
                if dt > self.step_deadline_s:
                    self.straggler_steps.append(step)
                    self.log(
                        f"[train] step {step} straggled ({dt:.2f}s > "
                        f"{self.step_deadline_s:.2f}s deadline)"
                    )
            if metrics_cb:
                metrics_cb(step, {k: float(v) for k, v in metrics.items()})
            losses.append(float(metrics["loss"]))
            if (step + 1) % self.ckpt_every == 0 or step + 1 == num_steps:
                sid = save_train_checkpoint(
                    self.snapshots, step + 1, state, self.run_id
                )
                self.log(
                    f"[train] step {step+1} loss={losses[-1]:.4f} ckpt={sid}"
                )
        return state
