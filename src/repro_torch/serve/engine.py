"""Batched serving engine: continuous prefill + decode over a model — the
JAX package's ``serve/engine.py`` in torch.

A request queue, a fixed decode batch with slot recycling, and greedy or
temperature sampling.  The decode cache is allocated once at engine
start; each request is prefilled alone and spliced into its slot, and
frees the slot when done.  All active slots decode together from the
longest length.  Everything runs under ``torch.inference_mode()`` on the
model's device.  Temperature sampling draws from a CPU
``torch.Generator`` seeded with ``rng_seed``: repeatable, but not the
JAX package's ``jax.random`` numbers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(
        self,
        model,
        batch_slots: int = 4,
        max_len: int = 256,
        rng_seed: int = 0,
    ):
        self.model = model
        self.slots = batch_slots
        self.max_len = max_len
        self.cfg = model.cfg
        self.device = model.device
        self._gen = torch.Generator().manual_seed(rng_seed)
        # one shared cache batch; slot i belongs to at most one request
        with torch.inference_mode():
            self.cache = model.init_cache(batch_slots, max_len)
        self._slot_req: List[Optional[Request]] = [None] * batch_slots

    # -- single-request prefill, spliced into the shared cache ------------
    def _prefill_slot(self, slot: int, req: Request) -> int:
        """Prefill one request and write its row of every cache entry but
        ``len`` into ``slot``: the model's ``cache_batch_axes()`` names
        each entry's batch axis (``DecoderLM``'s (L, B, S, ...) entries:
        1; ``GriffinLM``'s LRU states (n_super, 2, B, ...): 2).  The row
        is zeroed and the request's entry written at its start along every
        other axis, as the reference's zero-padded splice."""
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None, :]
        logits, cache1 = self.model.prefill(toks)
        # first generated token comes from the prefill logits
        req.out_tokens.append(self._sample(req, logits[0, 0]))
        for name, axis in self.model.cache_batch_axes().items():
            row = self.cache[name].select(axis, slot)
            small = cache1[name].select(axis, 0)
            row.zero_()
            row[tuple(slice(0, n) for n in small.shape)] = small.to(row.dtype)
        s = cache1["len"]
        self.cache["len"] = s
        return s

    def _sample(self, req: Request, logits: torch.Tensor) -> int:
        if req.temperature > 0:
            probs = torch.softmax(logits.float().cpu() / req.temperature, -1)
            return int(torch.multinomial(probs, 1, generator=self._gen))
        return int(torch.argmax(logits))

    def submit(self, req: Request) -> bool:
        for slot, owner in enumerate(self._slot_req):
            if owner is None:
                self._slot_req[slot] = req
                req._slot = slot  # type: ignore[attr-defined]
                with torch.inference_mode():
                    req._len = self._prefill_slot(slot, req)  # type: ignore
                return True
        return False

    def step(self) -> None:
        """One decode step for every active slot (batched)."""
        active = [r for r in self._slot_req if r is not None]
        if not active:
            return
        # the cache shares one length; per-slot lengths are tracked here.
        # All active requests advance together from the longest (shorter
        # prompts see zero rows between their end and it, as in the
        # reference).
        cur = max(getattr(r, "_len") for r in active)
        tok = np.zeros((self.slots, 1), np.int64)
        for r in active:
            tok[getattr(r, "_slot"), 0] = r.out_tokens[-1]
        self.cache["len"] = cur
        with torch.inference_mode():
            logits, self.cache = self.model.decode_step(
                torch.as_tensor(tok, device=self.device), self.cache)
            logits = logits[:, 0]
            greedy = torch.argmax(logits, dim=-1).tolist()
            for r in active:
                slot = getattr(r, "_slot")
                r.out_tokens.append(greedy[slot] if r.temperature <= 0
                                    else self._sample(r, logits[slot]))
                setattr(r, "_len", cur + 1)
                if (len(r.out_tokens) >= r.max_new_tokens
                        or cur + 1 >= self.max_len):
                    r.done = True
                    self._slot_req[slot] = None

    def run(self, requests: List[Request], max_steps: int = 10_000) -> None:
        pending = list(requests)
        steps = 0
        while (pending or any(self._slot_req)) and steps < max_steps:
            while pending and self.submit(pending[0]):
                pending.pop(0)
            self.step()
            steps += 1
