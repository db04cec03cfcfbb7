"""Retry backoff: exponential growth with seeded jitter (a copy of
skypilot_tpu/utils/backoff.py: ``Backoff`` and ``stable_seed``).

A fixed retry cadence synchronises every recovering process into herds
against whatever just failed; exponential backoff with jitter spreads
them out. The jitter is SEEDED per caller, so a chaos run's retry
timeline is reproducible: the same failure schedule gives the same
sleeps, while two callers with different seeds draw independent
streams.
"""
from __future__ import annotations

import hashlib
import random
import time
from typing import Optional


def stable_seed(text: str) -> int:
    """Deterministic int seed from an id string. ``hash(str)`` is salted
    per process (PYTHONHASHSEED), which would break the reproducible
    retry timeline."""
    return int.from_bytes(
        hashlib.sha256(text.encode('utf-8')).digest()[:4], 'big')


class Backoff:
    """Exponential backoff with half-jitter.

    Attempt n (0-based) sleeps ``uniform(0.5, 1.0) * min(cap,
    base * 2**n)``: the 0.5 floor keeps retries from collapsing to
    zero-sleep spins while the jitter half desynchronises callers.
    """

    def __init__(self, base: float = 1.0, cap: float = 30.0,
                 seed: Optional[int] = None):
        if base < 0 or cap < 0:
            raise ValueError(f'base={base} and cap={cap} must be >= 0')
        self.base = base
        self.cap = cap
        self._rng = random.Random(seed)
        self.attempt = 0

    def next(self) -> float:
        """The next sleep duration (advances the attempt counter)."""
        # 2.0**attempt overflows a float near 1024; past ~64 doublings
        # every realistic cap has long since won.
        raw = min(self.cap, self.base * (2.0 ** min(self.attempt, 64)))
        self.attempt += 1
        return raw * (0.5 + 0.5 * self._rng.random())

    def sleep(self) -> float:
        """Sleep the next duration; returns how long was slept."""
        duration = self.next()
        if duration > 0:
            time.sleep(duration)
        return duration

    def reset(self) -> None:
        """Back to attempt 0 (after a success inside a long loop)."""
        self.attempt = 0
