"""The rollout plane's state machines (a copy of the rollout part of
skypilot_tpu/analysis/state_machines.py: ``ROLLOUT_WORKER_TRANSITIONS``,
``ROLLOUT_LEASE_TRANSITIONS`` and ``can_transition``).

Every status write of the port's rollout dispatcher goes through its
guarded setters (``set_rollout_worker_status``, ``set_lease_status``),
which refuse an edge these tables do not declare.
"""
from __future__ import annotations

from typing import Dict, Set

# RolloutWorkerStatus (train/rollout/dispatcher.py). No terminal state:
# a harvested (preempted) worker that comes back re-registers and goes
# ALIVE again; its leases were already reassigned.
ROLLOUT_WORKER_TRANSITIONS: Dict[str, Set[str]] = {
    'ALIVE': {'LOST'},
    'LOST': {'ALIVE'},
}

# RolloutLeaseStatus (train/rollout/dispatcher.py). A prompt lease is
# minted PENDING, handed to a worker (LEASED), and completed exactly
# once (DONE, terminal: the first completed trajectory wins). LEASED ->
# PENDING is the reassignment edge (owner died, lease timed out, or the
# worker released it after a failed generation). PENDING -> DONE is
# legal on purpose: a lease can sit PENDING (owner reaped) while its
# original owner, alive after all, finishes and submits; refusing that
# trajectory would waste real rollout compute.
ROLLOUT_LEASE_TRANSITIONS: Dict[str, Set[str]] = {
    'PENDING': {'LEASED', 'DONE'},
    'LEASED': {'PENDING', 'DONE'},
    'DONE': set(),
}


def can_transition(table: Dict[str, Set[str]], frm: str, to: str) -> bool:
    """True iff ``frm -> to`` is declared legal (self-loops always are;
    an UNKNOWN ``frm`` refuses everything: fail closed)."""
    if frm == to:
        return True
    return to in table.get(frm, set())
