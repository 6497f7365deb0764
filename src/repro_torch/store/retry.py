"""Shared retry policy: bounded exponential backoff with full jitter.

Extracted from :mod:`repro_torch.store.remote` so every layer that faces
transient faults — remote GETs (:class:`~repro_torch.store.tiered.TieredReader`),
disk-cache fills, and the :class:`~repro_torch.api.service.MergeService`'s
executor-level retry — uses one policy object instead of re-inventing
backoff loops.

Backoff uses *full jitter* (AWS architecture-blog style): the sleep after
the i-th failure is drawn uniformly from ``[0, base * multiplier**i]``.
Deterministic tests pass a seeded ``random.Random`` via ``rng``; the cap
keeps a retry storm from synchronizing across a fleet of workers while
the expected backoff still doubles per attempt.

:func:`is_transient` is the service's retryable-vs-poison classifier: a
job that died to an infrastructure fault (remote fault, I/O error,
simulated/real worker death) deserves another attempt with its journal
intact; a job that failed deterministically (bad operator theta, budget
violation, shape mismatch) will fail again on every retry and must be
quarantined instead of looping forever.
"""
from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with full-jitter exponential backoff.

    ``attempts`` is the total try count (1 = no retry).  After the i-th
    failure the policy sleeps ``uniform(0, base_backoff_s * multiplier**i)``
    (full jitter; ``jitter=False`` restores the legacy deterministic
    sleep for latency-sensitive assertions).  Defaults are kept tiny so
    fault-injection tests stay fast while the shape is the production one.
    """

    attempts: int = 4
    base_backoff_s: float = 0.002
    multiplier: float = 2.0
    jitter: bool = True

    def backoff_s(self, failure_idx: int, rng: Optional[random.Random] = None) -> float:
        cap = self.base_backoff_s * (self.multiplier ** failure_idx)
        if not self.jitter:
            return cap
        return (rng or random).uniform(0.0, cap)

    def call(
        self,
        fn: Callable[[], object],
        on_retry: Optional[Callable[[int], None]] = None,
        retry_on: Tuple[Type[BaseException], ...] = (IOError,),
        rng: Optional[random.Random] = None,
    ):
        """Call ``fn`` with bounded retry on ``retry_on`` exceptions.

        The default ``retry_on=(IOError,)`` covers
        :class:`~repro_torch.store.remote.RemoteError` (an ``IOError``
        subclass) and ordinary filesystem hiccups.  On exhaustion the
        last exception is re-raised with the attempt count chained in.
        """
        last: Optional[BaseException] = None
        tries = max(1, self.attempts)
        for i in range(tries):
            try:
                return fn()
            except retry_on as e:
                last = e
                if i + 1 >= tries:
                    break
                if on_retry is not None:
                    on_retry(i + 1)
                time.sleep(self.backoff_s(i, rng))
        raise type(last)(
            f"request failed after {tries} attempts: {last}"
        ) from last


#: exception types that indicate infrastructure trouble worth retrying —
#: the fault may clear on the next attempt (and a resumable journal makes
#: the retry cost O(remaining work), not O(full merge))
TRANSIENT_TYPES: Tuple[Type[BaseException], ...] = (
    IOError,          # includes RemoteError, disk hiccups
    TimeoutError,
    ConnectionError,
)


def is_transient(exc: BaseException) -> bool:
    """Classify a job failure: True = retryable infrastructure fault,
    False = deterministic (poison) failure that would recur on retry.

    :class:`~repro_torch.testing.chaos.SimulatedCrash` — and by extension any
    worker death — counts as transient: the job's journal survives, so a
    retry resumes instead of restarting.
    """
    from repro_torch.testing.chaos import SimulatedCrash

    if isinstance(exc, SimulatedCrash):
        return True
    # hash-validation failures are IOError but deterministic re-runs may
    # still clear them (torn write on a flaky disk) — keep them transient;
    # the attempt cap quarantines genuinely poisoned jobs either way
    return isinstance(exc, TRANSIENT_TYPES)
