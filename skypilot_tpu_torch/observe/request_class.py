"""The closed request-class registry: the serving plane's declared,
bounded ``cls`` metric label (a copy of
skypilot_tpu/observe/request_class.py: ``CLASSES``, ``DEFAULT_CLASS``,
``HEADER``, ``OBJECTIVES``, ``normalize``, ``from_headers``,
``is_good``).

A request declares its class on the ``X-Skytpu-Class`` header, which
any client can set to anything; :func:`normalize` is the one mapping
from that raw string into the closed set (unknown or absent clamps to
``other``), so a metric label never takes a new value.
:data:`OBJECTIVES` carries each class's latency objective, the
goodput cut: a finished request is good when its TTFT, and its TPOT
when it decoded more than one token, are at or under the bounds.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

# The declared finite label values. ``other`` is the clamp target for
# anything unknown and the default for unlabeled traffic — it MUST stay
# a member, or clamping would itself mint a new value.
CLASSES: Tuple[str, ...] = ('interactive', 'long_context', 'batch',
                            'other')
DEFAULT_CLASS = 'other'

# The header a client (or the loadgen harness) declares its class on.
# The LB clamps it through normalize() before forwarding, and the
# engine clamps it again.
HEADER = 'X-Skytpu-Class'

@dataclasses.dataclass(frozen=True)
class ClassObjective:
    """One class's latency objective — the goodput cut. Both bounds
    are declared histogram bucket bounds (engine TTFT buckets include
    2.5/10/30 s, TPOT buckets include 0.25/0.5/1.0 s), so windowed
    bucket-delta evaluation needs no interpolation."""
    ttft_seconds: float
    tpot_seconds: float


OBJECTIVES: Mapping[str, ClassObjective] = {
    'interactive': ClassObjective(ttft_seconds=2.5, tpot_seconds=0.25),
    'long_context': ClassObjective(ttft_seconds=10.0, tpot_seconds=0.25),
    'batch': ClassObjective(ttft_seconds=30.0, tpot_seconds=1.0),
    'other': ClassObjective(ttft_seconds=10.0, tpot_seconds=0.5),
}
assert set(OBJECTIVES) == set(CLASSES)


def normalize(raw: Optional[str]) -> str:
    """Map a raw (client-supplied, untrusted) class string into the
    closed set: case/whitespace-insensitive exact match, anything else
    — including None/empty — clamps to ``other``. This is the ONE
    sanctioned path from an ``X-Skytpu-Class`` header value to a
    metric ``cls=`` label."""
    if not raw:
        return DEFAULT_CLASS
    value = raw.strip().lower()
    return value if value in CLASSES else DEFAULT_CLASS


def from_headers(headers) -> str:
    """The request's class from an HTTP header mapping (aiohttp
    CIMultiDict or plain dict), already clamped."""
    try:
        raw = headers.get(HEADER, '')
    except AttributeError:
        raw = ''
    return normalize(raw)


def is_good(cls: str, ttft_seconds: float,
            tpot_seconds: Optional[float]) -> bool:
    """The goodput predicate: did this request complete within its
    class's latency objective? ``tpot_seconds`` is None for
    single-token requests — TTFT alone judges those."""
    obj = OBJECTIVES.get(cls) or OBJECTIVES[DEFAULT_CLASS]
    if ttft_seconds > obj.ttft_seconds:
        return False
    return tpot_seconds is None or tpot_seconds <= obj.tpot_seconds
