"""Deterministic synthetic data pipeline (token LM batches) — the JAX
package's ``train/data.py`` in torch.

Stateless indexing = fault tolerance: batch ``i`` is a pure function of
(seed, i, shape), so resume-after-crash replays the exact stream from the
checkpointed step with no pipeline state to persist.  ``synth_batch`` is
the reference's, numpy for numpy, so both packages train on the same
arrays.  :class:`DataPipeline` places each batch on its ``device``: on a
card the int64 arrays are staged in pinned host memory and copied with
``non_blocking=True``; a small host-side prefetch queue overlaps batch
synthesis with device compute.  Under a device mesh
(``models/shardctx.py``) the token arrays become DTensors placed by
``sharding_for(("batch", None))``: each rank keeps its batch shard.

The synthetic distribution is a mixture of K "skill" Markov chains so
that experts fine-tuned on different skills genuinely diverge — the merge
examples (examples/train_and_merge.py) rely on that.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator, Optional, Union

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.sharding import distribute
from repro_torch.models.shardctx import sharding_for


def _chain(rng: np.random.Generator, vocab: int, skill: int, n: int) -> np.ndarray:
    """Skill-conditioned Markov stream: token_{t+1} = f(token_t) + noise."""
    mult = 3 + 2 * skill
    add = 7 + 11 * skill
    x = np.empty(n, np.int32)
    x[0] = rng.integers(0, vocab)
    noise = rng.integers(0, vocab, size=n)
    flip = rng.random(n) < 0.15
    for t in range(1, n):
        nxt = (x[t - 1] * mult + add) % vocab
        x[t] = noise[t] if flip[t] else nxt
    return x


def synth_batch(
    seed: int,
    step: int,
    batch: int,
    seq: int,
    vocab: int,
    skill: int = 0,
) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed * 1_000_003 + step) * 7 + skill)
    toks = np.stack([_chain(rng, vocab, skill, seq + 1) for _ in range(batch)])
    return {
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """Token arrays (2-d) as int64 tensors on ``device`` (pinned and
    non-blocking on a card); other entries pass through."""
    out = {}
    for k, v in batch.items():
        if getattr(v, "ndim", 0) != 2:
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.int64))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t
    return out


class DataPipeline:
    """Prefetching iterator over synthetic batches placed on ``device``
    (default the card; ``device="cpu"`` for the tests)."""

    def __init__(
        self,
        vocab: int,
        batch: int,
        seq: int,
        seed: int = 0,
        skill: int = 0,
        start_step: int = 0,
        prefetch: int = 2,
        extra: Optional[Dict[str, Any]] = None,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = resolve_device(device)
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed, self.skill = seed, skill
        self.step = start_step
        self.extra = extra or {}
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self.step
        while not self._stop.is_set():
            b = synth_batch(self.seed, step, self.batch, self.seq,
                            self.vocab, self.skill)
            b.update(self.extra)
            try:
                self._q.put((step, b), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        while True:
            step, b = self._q.get()
            if step < self.step:  # stale after a resume seek
                continue
            self.step = step + 1
            b = to_device(b, self.device)
            sh = {k: sharding_for(("batch", None), tuple(v.shape))
                  for k, v in b.items() if getattr(v, "ndim", 0) == 2}
            return {k: distribute(v, *sh[k]) if sh.get(k) else v
                    for k, v in b.items()}

    def state(self) -> Dict[str, int]:
        """Pipeline state for the checkpoint — just the step cursor."""
        return {"seed": self.seed, "step": self.step, "skill": self.skill}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
