"""Engine flight recorder: a fixed-size, lock-free hot-loop event ring (a
copy of skypilot_tpu/observe/flight.py: ``FlightRecorder``, the event
codes and ``snapshot_to_journal``).

The decode loop records no span and takes no lock per token: it stores
``(monotonic_ns, event_code, slot, seq)`` tuples into a preallocated
ring, one atomic counter bump (``itertools.count``) plus one list-slot
store each, and never a device sync. ``GET /debug/flight`` on the
engine dumps the ring, newest last, with the codes decoded; per-request
TTFT and TPOT come from host timestamps taken at admit and publish,
never from per-token telemetry. A failure reset snapshots the ring into
the event journal (observe/journal.py, kind ``flight_snapshot``), so a
post-mortem has the loop's last events whether or not anyone scraped
``/debug/flight`` in time.
"""
from __future__ import annotations

import itertools
import time

from skypilot_tpu_torch.utils import knobs
from typing import Any, Dict, List, Optional, Tuple

# Event codes (ints in the ring; names only at dump time).
DISPATCH = 1        # fused step enqueued; seq = k (step width)
COLLECT = 2         # fused step consumed; seq = k
ADMIT = 3           # a request prefilled into `slot`; seq = bucket
FINISH = 4          # `slot` finished; seq = tokens generated
SPEC = 5            # speculative verify round; seq = accepted tokens
RESET = 6           # device-state rebuild (failure path)
CANCEL = 7          # a cancel applied to `slot`
CHUNK = 8           # a prefill chunk ran for `slot`; seq = tokens done

CODE_NAMES: Dict[int, str] = {
    DISPATCH: 'dispatch', COLLECT: 'collect', ADMIT: 'admit',
    FINISH: 'finish', SPEC: 'spec', RESET: 'reset', CANCEL: 'cancel',
    CHUNK: 'chunk',
}

_CAPACITY_ENV = 'SKYTPU_FLIGHT_CAPACITY'
DEFAULT_CAPACITY = 65536


class FlightRecorder:
    """Fixed-capacity ring of hot-loop events.

    Concurrent writers are safe with no lock: each ``record`` claims a
    unique monotonically-increasing index from the shared counter and
    stores one immutable tuple into its slot — overwrites only ever
    replace the OLDEST entries (index mod capacity), so a wraparound
    loses nothing but them. ``snapshot`` reads a point-in-time copy of
    the slots; an entry being concurrently replaced is seen as either
    its old or its new tuple, never a torn value.
    """

    __slots__ = ('capacity', '_buf', '_ctr')

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = knobs.get_int(_CAPACITY_ENV)
        if capacity < 1:
            raise ValueError('flight ring needs capacity >= 1')
        self.capacity = capacity
        self._buf: List[Optional[Tuple[int, int, int, int]]] = \
            [None] * capacity
        self._ctr = itertools.count()

    def record(self, code: int, slot: int = 0, seq: int = 0) -> None:
        """THE hot-path call: one counter bump + one slot store."""
        i = next(self._ctr)
        self._buf[i % self.capacity] = (time.monotonic_ns(), code, slot,
                                        seq)

    def snapshot(self) -> List[Tuple[int, int, int, int]]:
        """Point-in-time copy, oldest first (by monotonic timestamp —
        ring order is index order, but a concurrent writer may have
        replaced a slot between the copy's first and last element)."""
        entries = [e for e in list(self._buf) if e is not None]
        entries.sort(key=lambda e: e[0])
        return entries

    def dump(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Decoded events for the /debug/flight endpoint (newest-last;
        ``limit`` keeps only the newest N)."""
        entries = self.snapshot()
        if limit is not None and limit > 0:
            entries = entries[-limit:]
        return [{'t_ns': ns, 'event': CODE_NAMES.get(code, str(code)),
                 'slot': slot, 'seq': seq}
                for ns, code, slot, seq in entries]

    def clear(self) -> None:
        """Drop every entry (the engine clears the ring after warm-up;
        a failure reset keeps it, so overlapping failures still see
        their history)."""
        self._buf = [None] * self.capacity
        self._ctr = itertools.count()



def snapshot_to_journal(recorder: FlightRecorder, *,
                        reason: Optional[str] = None,
                        entity: Optional[str] = None,
                        max_events: Optional[int] = None) -> bool:
    """Persist the ring into the event journal (kind=flight_snapshot),
    newest ``max_events`` when given; False for an empty ring or a
    failed write (best-effort like every journal write)."""
    entries = recorder.snapshot()
    if not entries:
        return False
    if max_events is not None and max_events > 0:
        entries = entries[-max_events:]
    from skypilot_tpu_torch.observe import journal
    return journal.record_event(
        'flight_snapshot', entity=entity, reason=reason,
        data={'events': [list(e) for e in entries],
              'columns': ['t_ns', 'code', 'slot', 'seq'],
              'codes': {str(k): v for k, v in CODE_NAMES.items()}})
