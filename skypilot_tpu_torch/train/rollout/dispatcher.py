"""Rollout dispatcher: worker registry + prompt-lease state machine (a
copy of skypilot_tpu/train/rollout/dispatcher.py that speaks its wire
unchanged, so JAX workers and learners talk to it and the port's talk
to the JAX one).

The control plane of the harvested-RL topology — it never runs a
model. It tracks rollout workers (heartbeats → ALIVE/LOST, the
``data_service`` registry idiom), owns the :class:`RolloutSpec` of the
job it serves, and runs the prompt-lease machine: every trajectory
group starts life as a lease (``PENDING``), is handed to exactly one
worker at a time (``LEASED``), and is completed exactly once
(``DONE``, first submission wins). Because a lease's prompt is a pure
function of ``(spec, lease_id)`` (``rollout/spec.py``), reassignment
is *at-least-once by construction*: handing a dead worker's leases to
a survivor — or to a worker that turns out to still be alive — can
duplicate rollout work but never corrupt the stream; the learner
consumes each completed group once.

Leases come back from the dead three ways, all funneled through the
guarded ``set_lease_status`` setter and journaled:

  * **worker loss** — the reaper marks silent workers LOST and moves
    their LEASED leases back to PENDING (``rollout_lease_reassign``
    with the orphaned lease ids, one event per lost worker — the
    chaos suite counts these against its kill schedule);
  * **orphan sweep** — LEASED leases owned by a non-ALIVE worker
    (a crash between the LOST write and its reassignment) rebalance
    on every reaper pass;
  * **lease timeout** — a wedged-but-heartbeating worker cannot sit
    on a lease forever.

State lives in WAL sqlite (``utils/sqlite_utils``; 3.34-safe, no
RETURNING). All status writes go through the guarded setters, whose
edges ``analysis/state_machines.py`` declares, inside ``BEGIN
IMMEDIATE`` transactions.
Completed trajectories are buffered in a BOUNDED in-memory queue for
the learner's ``collect`` — backpressure gates lease minting, so a
slow learner throttles the fleet instead of hoarding its output.
Delivery to the learner is at-least-once over the wire (unacked
collect replies re-deliver); a dispatcher CRASH, by contrast, loses
at most ``result_cap`` buffered groups whose leases are already DONE
— bounded wasted compute, never corruption or a stall (lease state
is durable, fresh leases keep flowing on restart). Persisting the
result buffer is deliberately out of scope: trajectories are
megabytes of npy per group and the window is seconds wide.
"""
from __future__ import annotations

import collections
import enum
import json
import logging
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from skypilot_tpu_torch.analysis import state_machines
from skypilot_tpu_torch.observe import journal
from skypilot_tpu_torch.train.rollout import spec as spec_lib
from skypilot_tpu_torch.train.rollout import telemetry
from skypilot_tpu_torch.utils import failpoints
from skypilot_tpu_torch.utils import framed
from skypilot_tpu_torch.utils import knobs
from skypilot_tpu_torch.utils import sqlite_utils

logger = logging.getLogger(__name__)

DEFAULT_HEARTBEAT_TIMEOUT = knobs.get_float(
    'SKYTPU_ROLLOUT_HEARTBEAT_TIMEOUT')
DEFAULT_LEASE_TIMEOUT = knobs.get_float('SKYTPU_ROLLOUT_LEASE_TIMEOUT')
# Outstanding = minted-but-not-DONE leases. Bounds duplicated work
# after a mass preemption AND (with the result cap) the dispatcher's
# memory; the learner's consumption rate is the real throttle.
DEFAULT_MAX_OUTSTANDING = knobs.get_int('SKYTPU_ROLLOUT_MAX_OUTSTANDING')
DEFAULT_RESULT_CAP = knobs.get_int('SKYTPU_ROLLOUT_RESULT_CAP')
# DONE lease rows kept for accounting before the reaper GCs them.
_DONE_KEEP_ROWS = 10_000


class RolloutWorkerStatus(enum.Enum):
    """Registry state of one rollout worker."""
    ALIVE = 'ALIVE'
    LOST = 'LOST'


class RolloutLeaseStatus(enum.Enum):
    """Lifecycle of one prompt lease."""
    PENDING = 'PENDING'
    LEASED = 'LEASED'
    DONE = 'DONE'


def _connect(path: str) -> sqlite3.Connection:
    conn = sqlite_utils.connect_wal(path)
    conn.execute("""
        CREATE TABLE IF NOT EXISTS workers (
            worker_id TEXT PRIMARY KEY,
            status TEXT,
            last_heartbeat REAL,
            joined_ts REAL
        )""")
    conn.execute("""
        CREATE TABLE IF NOT EXISTS leases (
            lease_id INTEGER PRIMARY KEY,
            status TEXT,
            worker_id TEXT,
            assigned_ts REAL,
            attempts INTEGER DEFAULT 0
        )""")
    conn.execute("""
        CREATE TABLE IF NOT EXISTS meta (
            key TEXT PRIMARY KEY,
            value TEXT
        )""")
    conn.commit()
    return conn


# ----------------------------------------------------- guarded setters

def set_rollout_worker_status(
        conn: sqlite3.Connection, worker_id: str,
        new: RolloutWorkerStatus, *,
        reason: Optional[str] = None,
        require_heartbeat_before: Optional[float] = None,
) -> Tuple[Optional[str], bool]:
    """THE worker-status write path.

    Returns ``(old_status, changed)``. A missing row is created only
    for ``new == ALIVE`` (registration is the machine's entry point).
    ``require_heartbeat_before`` makes the reaper's LOST write
    conditional: a heartbeat landing between the reaper's scan and
    this transaction keeps the worker ALIVE (no stale kill). Journals
    ``rollout_worker_join`` / ``rollout_worker_lost`` exactly once per
    winning edge, inside the transaction.
    """
    now = time.time()
    with sqlite_utils.immediate(conn):
        row = conn.execute(
            'SELECT status, last_heartbeat FROM workers '
            'WHERE worker_id = ?', (worker_id,)).fetchone()
        if row is None:
            if new is not RolloutWorkerStatus.ALIVE:
                return None, False
            conn.execute(
                'INSERT INTO workers (worker_id, status, '
                'last_heartbeat, joined_ts) VALUES (?, ?, ?, ?)',
                (worker_id, new.value, now, now))
            journal.record_event('rollout_worker_join', worker_id,
                                 reason=reason or 'register')
            return None, True
        old, last_hb = row
        if require_heartbeat_before is not None and \
                last_hb is not None and \
                last_hb >= require_heartbeat_before:
            return old, False
        if not state_machines.can_transition(
                state_machines.ROLLOUT_WORKER_TRANSITIONS, old,
                new.value):
            return old, False
        if old == new.value:
            # Self-loop: refresh liveness facts, no journal.
            conn.execute(
                'UPDATE workers SET last_heartbeat = ? '
                'WHERE worker_id = ?', (now, worker_id))
            return old, False
        conn.execute(
            'UPDATE workers SET status = ?, last_heartbeat = ? '
            'WHERE worker_id = ?', (new.value, now, worker_id))
        if new is RolloutWorkerStatus.ALIVE:
            journal.record_event('rollout_worker_join', worker_id,
                                 reason=reason or 'rejoin',
                                 data={'old': old})
        else:
            journal.record_event('rollout_worker_lost', worker_id,
                                 reason=reason, data={'old': old})
        return old, True


def set_lease_status(
        conn: sqlite3.Connection,
        changes: List[Tuple[int, 'RolloutLeaseStatus', Optional[str]]],
        *,
        require_owner: Optional[str] = None,
) -> List[Tuple[int, str, str]]:
    """THE lease-status write path: bulk edges in ONE transaction.

    ``changes`` is ``[(lease_id, new_status, worker_id)]`` —
    ``worker_id`` is the new owner for LEASED, ``None`` otherwise. A
    missing row is created only for ``new == PENDING`` (minting is
    the machine's entry point). Transitions not declared in
    ``ROLLOUT_LEASE_TRANSITIONS`` are refused silently (the caller's
    plan raced a faster writer — at-least-once semantics make that
    harmless). ``require_owner`` makes every edge conditional on the
    lease's CURRENT owner — a compare-and-set inside this
    transaction, so callers never need to hold a process lock across
    the read and the write (the owner check and the status flip are
    atomic at the DB). Returns the applied ``(lease_id, old, new)``
    edges.
    """
    applied: List[Tuple[int, str, str]] = []
    now = time.time()
    with sqlite_utils.immediate(conn):
        for lease_id, new, worker_id in changes:
            row = conn.execute(
                'SELECT status, worker_id FROM leases '
                'WHERE lease_id = ?', (lease_id,)).fetchone()
            if row is None:
                if new is not RolloutLeaseStatus.PENDING or \
                        require_owner is not None:
                    continue
                conn.execute(
                    'INSERT INTO leases (lease_id, status, worker_id, '
                    'assigned_ts, attempts) VALUES (?, ?, NULL, ?, 0)',
                    (lease_id, new.value, now))
                applied.append((lease_id, '', new.value))
                continue
            old, old_owner = row
            if require_owner is not None and old_owner != require_owner:
                continue
            if old == new.value or not state_machines.can_transition(
                    state_machines.ROLLOUT_LEASE_TRANSITIONS, old,
                    new.value):
                continue
            if new is RolloutLeaseStatus.LEASED:
                conn.execute(
                    'UPDATE leases SET status = ?, worker_id = ?, '
                    'assigned_ts = ?, attempts = attempts + 1 '
                    'WHERE lease_id = ?',
                    (new.value, worker_id, now, lease_id))
            else:
                conn.execute(
                    'UPDATE leases SET status = ?, worker_id = ?, '
                    'assigned_ts = ? WHERE lease_id = ?',
                    (new.value, worker_id, now, lease_id))
            applied.append((lease_id, old, new.value))
    return applied


class RolloutDispatcher:
    """TCP front + sqlite lease/registry state + heartbeat reaper."""

    def __init__(self, db_path: str, *, host: str = '127.0.0.1',
                 port: int = 0,
                 heartbeat_timeout: float = DEFAULT_HEARTBEAT_TIMEOUT,
                 lease_timeout: float = DEFAULT_LEASE_TIMEOUT,
                 max_outstanding: int = DEFAULT_MAX_OUTSTANDING,
                 result_cap: int = DEFAULT_RESULT_CAP):
        self._db_path = db_path
        self._heartbeat_timeout = heartbeat_timeout
        self._lease_timeout = lease_timeout
        self._max_outstanding = max(1, max_outstanding)
        self._local = threading.local()
        self._stop = threading.Event()
        # Serializes the lease handler's read-plan phase (bounding
        # over-mint between concurrent lease RPCs). NEVER held across
        # a commit: every write is its own guarded transaction whose
        # compare-and-set refuses a plan that raced a faster writer
        # (``set_lease_status`` returns the edges that actually
        # applied; ``require_owner`` makes release owner-conditional;
        # ``_mint_ids`` reserves the id counter atomically), so
        # correctness comes from the DB — right even across processes
        # — and no handler thread ever stalls behind another's
        # WAL-contention retry sleep.
        self._assign_lock = threading.Lock()
        # Completed trajectory groups awaiting the learner. Bounded:
        # when full, the oldest (stalest — the learner would likely
        # drop it anyway) is evicted, and lease minting pauses.
        self._results: 'collections.deque[Dict[str, Any]]' = (
            collections.deque(maxlen=max(1, result_cap)))
        # Groups handed to a collect reply but not yet acked by the
        # NEXT collect: a reply lost on the wire must not lose real
        # rollout compute (the lease is already DONE — the work could
        # never be re-executed). Unacked groups are re-delivered; the
        # learner dedupes by lease_id.
        self._inflight: List[Dict[str, Any]] = []
        self._results_lock = threading.Lock()
        self._conn()   # create tables before the server answers
        self._server = framed.FramedServer(host, port, self._handle,
                                           name='rollout-dispatcher')
        self.addr = self._server.addr
        self._reaper = threading.Thread(
            target=self._reap_loop, name='rollout-dispatcher-reaper',
            daemon=True)

    # ------------------------------------------------------- lifecycle

    def start(self) -> 'RolloutDispatcher':
        self._server.start()
        self._reaper.start()
        logger.info(
            f'rollout dispatcher on {self.addr[0]}:{self.addr[1]} '
            f'(db={self._db_path}, heartbeat_timeout='
            f'{self._heartbeat_timeout}s, lease_timeout='
            f'{self._lease_timeout}s)')
        return self

    def stop(self) -> None:
        self._stop.set()
        self._server.stop()
        self._reaper.join(timeout=5.0)

    def _conn(self) -> sqlite3.Connection:
        conn = getattr(self._local, 'conn', None)
        if conn is None:
            conn = _connect(self._db_path)
            self._local.conn = conn
        return conn

    # ------------------------------------------------------------ meta

    def _meta_get(self, key: str) -> Optional[str]:
        row = self._conn().execute(
            'SELECT value FROM meta WHERE key = ?', (key,)).fetchone()
        return row[0] if row else None

    def _meta_set(self, conn: sqlite3.Connection, key: str,
                  value: str) -> None:
        with sqlite_utils.immediate(conn):
            conn.execute(
                'INSERT INTO meta (key, value) VALUES (?, ?) '
                'ON CONFLICT(key) DO UPDATE SET value = excluded.value',
                (key, value))

    def _mint_ids(self, conn: sqlite3.Connection, n: int) -> List[int]:
        """Reserve ``n`` fresh lease ids: the counter's
        read-increment-write is ONE BEGIN IMMEDIATE transaction, so
        sqlite's write lock is the arbiter and no Python lock is
        needed — concurrent minters get disjoint ranges even across
        processes."""
        with sqlite_utils.immediate(conn):
            row = conn.execute(
                "SELECT value FROM meta WHERE key = 'next_lease_id'"
            ).fetchone()
            next_id = int(row[0]) if row else 0
            conn.execute(
                'INSERT INTO meta (key, value) VALUES (?, ?) '
                'ON CONFLICT(key) DO UPDATE SET value = excluded.value',
                ('next_lease_id', str(next_id + n)))
        return list(range(next_id, next_id + n))

    def snapshot_version(self) -> int:
        return int(self._meta_get('snapshot_version') or -1)

    def spec_fp(self) -> Optional[str]:
        return self._meta_get('spec_fp')

    # -------------------------------------------------------- handlers

    def _handle(self, obj: Dict[str, Any], arrays: framed.Arrays
                ) -> Tuple[Dict[str, Any], Optional[framed.Arrays]]:
        op = str(obj.get('op', ''))
        if op == 'register':
            return self._op_register(obj), None
        if op == 'heartbeat':
            return self._op_heartbeat(obj), None
        if op == 'lease':
            return self._op_lease(obj), None
        if op == 'submit':
            return self._op_submit(obj, arrays), None
        if op == 'release':
            return self._op_release(obj), None
        if op == 'collect':
            return self._op_collect(obj)
        if op == 'put_spec':
            return self._op_put_spec(obj), None
        if op == 'publish':
            return self._op_publish(obj), None
        if op == 'stats':
            return self._op_stats(), None
        raise framed.RemoteError(f'unknown op {op!r}', kind='bad_op')

    def _spec_reply(self, reply: Dict[str, Any]) -> Dict[str, Any]:
        raw = self._meta_get('spec')
        if raw is not None:
            reply['spec'] = json.loads(raw)
        reply['spec_fp'] = self.spec_fp()
        reply['snapshot_version'] = self.snapshot_version()
        return reply

    def _op_register(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        worker_id = str(obj['worker_id'])
        old, changed = set_rollout_worker_status(
            self._conn(), worker_id, RolloutWorkerStatus.ALIVE)
        telemetry.WORKERS_UP.set(float(self._alive_count()))
        return self._spec_reply(
            {'ok': True, 'rejoined': bool(old is not None and changed)})

    def _op_heartbeat(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        worker_id = str(obj['worker_id'])
        conn = self._conn()
        # `status IN (?)` reads the column, never writes it (status
        # writes are the guarded setters').
        cur = conn.execute(
            'UPDATE workers SET last_heartbeat = ? '
            'WHERE worker_id = ? AND status IN (?)',
            (time.time(), worker_id, RolloutWorkerStatus.ALIVE.value))
        conn.commit()
        if cur.rowcount == 0:
            # Unknown or LOST: tell the worker to re-register — its
            # leases were reassigned; rejoining gets it fresh ones.
            return {'ok': False, 'resync': True}
        reply: Dict[str, Any] = {'ok': True,
                                 'snapshot_version':
                                     self.snapshot_version()}
        if not obj.get('have_spec'):
            self._spec_reply(reply)
        return reply

    def _op_put_spec(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        try:
            spec = spec_lib.RolloutSpec.from_json(obj['spec'])
        except (ValueError, TypeError) as e:
            raise framed.RemoteError(
                f'cannot parse rollout spec: {e}', kind='spec') from e
        fp = spec.fingerprint()
        conn = self._conn()
        with sqlite_utils.immediate(conn):
            row = conn.execute(
                "SELECT value FROM meta WHERE key = 'spec_fp'"
            ).fetchone()
            if row is None:
                conn.execute(
                    "INSERT INTO meta (key, value) VALUES "
                    "('spec', ?), ('spec_fp', ?)",
                    (json.dumps(spec.to_json()), fp))
            elif row[0] != fp:
                raise framed.RemoteError(
                    f'dispatcher already serves spec {row[0]}, client '
                    f'sent {fp} — one dispatcher serves one rollout '
                    f'job; start another (or a fresh --db) for a new '
                    f'one', kind='spec_mismatch')
        return {'ok': True, 'spec_fp': fp}

    def _op_publish(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        version = int(obj['version'])
        current = self.snapshot_version()
        if version <= current:
            # Stale announcement (a learner restart replaying an old
            # cadence): versions are monotonic, refuse quietly.
            return {'ok': True, 'snapshot_version': current}
        self._meta_set(self._conn(), 'snapshot_version', str(version))
        telemetry.SNAPSHOT_VERSION.set(float(version))
        journal.record_event('rollout_snapshot_publish', 'learner',
                             data={'version': version})
        return {'ok': True, 'snapshot_version': version}

    def _alive_count(self) -> int:
        return int(self._conn().execute(
            'SELECT COUNT(*) FROM workers WHERE status = ?',
            (RolloutWorkerStatus.ALIVE.value,)).fetchone()[0])

    def _op_lease(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        if failpoints.ACTIVE:
            failpoints.fire('rollout.lease')
        worker_id = str(obj['worker_id'])
        max_n = max(1, int(obj.get('max_n', 1)))
        want_fp = obj.get('spec_fp')
        have_fp = self.spec_fp()
        if want_fp is not None and have_fp is not None and \
                want_fp != have_fp:
            # Refuse BEFORE granting: generation is the expensive
            # step, and a diverged worker's trajectories would only
            # be refused at submit anyway.
            raise framed.RemoteError(
                f'dispatcher serves spec {have_fp}, worker leases '
                f'for {want_fp} — jobs diverged; restart the older '
                f'side', kind='spec_mismatch')
        conn = self._conn()
        row = conn.execute(
            'SELECT status FROM workers WHERE worker_id = ?',
            (worker_id,)).fetchone()
        if row is None or row[0] != RolloutWorkerStatus.ALIVE.value:
            return {'ok': False, 'resync': True}
        with self._assign_lock:
            # Reads + arithmetic only — the lock bounds over-minting
            # between concurrent lease RPCs, never a commit.
            pending = [l for (l,) in conn.execute(
                'SELECT lease_id FROM leases WHERE status = ? '
                'ORDER BY lease_id LIMIT ?',
                (RolloutLeaseStatus.PENDING.value, max_n)).fetchall()]
            want_new = max_n - len(pending)
            to_mint = 0
            if want_new > 0:
                outstanding = int(conn.execute(
                    'SELECT COUNT(*) FROM leases WHERE status != ?',
                    (RolloutLeaseStatus.DONE.value,)).fetchone()[0])
                with self._results_lock:
                    backlog = len(self._results)
                # Backpressure: don't mint work the learner is not
                # consuming — a full result buffer means new leases
                # would only evict completed groups.
                headroom = min(
                    self._max_outstanding - outstanding,
                    (self._results.maxlen or 1) - backlog - outstanding)
                to_mint = min(want_new, max(0, headroom))
        # Writes OUTSIDE the lock: each sets its own transaction and
        # can sleep on WAL contention or an armed sqlite.commit
        # failpoint — other handler threads must keep moving.
        minted: List[int] = []
        if to_mint > 0:
            minted = self._mint_ids(conn, to_mint)
            set_lease_status(conn, [
                (l, RolloutLeaseStatus.PENDING, None) for l in minted])
            telemetry.LEASES.inc(len(minted), event='minted')
        grant: List[int] = []
        if pending or minted:
            # The grant is whatever the guarded setter ACTUALLY
            # applied: a concurrent granter of the same PENDING ids
            # loses cleanly (LEASED -> LEASED refused) instead of two
            # workers both believing they own the lease.
            applied = set_lease_status(conn, [
                (l, RolloutLeaseStatus.LEASED, worker_id)
                for l in pending + minted])
            grant = [l for l, _, _ in applied]
            if grant:
                telemetry.LEASES.inc(len(grant), event='leased')
        return {'ok': True, 'leases': grant,
                'spec_fp': self.spec_fp(),
                'snapshot_version': self.snapshot_version()}

    def _op_submit(self, obj: Dict[str, Any],
                   arrays: framed.Arrays) -> Dict[str, Any]:
        worker_id = str(obj['worker_id'])
        lease_id = int(obj['lease_id'])
        version = int(obj.get('snapshot_version', -1))
        want_fp = obj.get('spec_fp')
        have_fp = self.spec_fp()
        if want_fp is not None and have_fp is not None and \
                want_fp != have_fp:
            raise framed.RemoteError(
                f'dispatcher serves spec {have_fp}, worker submitted '
                f'for {want_fp} — jobs diverged; restart the older '
                f'side', kind='spec_mismatch')
        traj = self._validate_trajectory(lease_id, version, arrays)
        conn = self._conn()
        # Apply first, diagnose on refusal: the guarded setter's
        # transaction is the arbiter (DONE is terminal, so the first
        # writer wins atomically) — no lock held across the commit,
        # and no check-then-act window between a status read and the
        # write.
        applied = set_lease_status(
            conn, [(lease_id, RolloutLeaseStatus.DONE, None)])
        if not applied:
            row = conn.execute(
                'SELECT status FROM leases WHERE lease_id = ?',
                (lease_id,)).fetchone()
            if row is None:
                raise framed.RemoteError(
                    f'unknown lease {lease_id}', kind='unknown_lease')
            if row[0] == RolloutLeaseStatus.DONE.value:
                # At-least-once duplicate (the lease was reassigned
                # and someone else finished first): drop quietly.
                telemetry.LEASES.inc(event='duplicate')
                return {'ok': True, 'accepted': False,
                        'duplicate': True}
            raise framed.RemoteError(
                f'lease {lease_id} refused DONE from {row[0]}',
                kind='bad_transition')
        telemetry.LEASES.inc(event='done')
        with self._results_lock:
            self._results.append(traj)
            telemetry.QUEUE_DEPTH.set(float(len(self._results)),
                                      role='dispatcher')
        telemetry.TRAJECTORIES.inc(role='worker')
        return {'ok': True, 'accepted': True, 'duplicate': False,
                'worker_id': worker_id}

    def _validate_trajectory(self, lease_id: int, version: int,
                             arrays: framed.Arrays) -> Dict[str, Any]:
        missing = {'completions', 'rewards', 'behavior_lp'} - set(
            arrays or {})
        if missing:
            raise framed.RemoteError(
                f'trajectory for lease {lease_id} lacks arrays '
                f'{sorted(missing)}', kind='bad_trajectory')
        comp = arrays['completions']
        rew = arrays['rewards']
        lp = arrays['behavior_lp']
        if comp.ndim != 2 or rew.shape != (comp.shape[0],) or \
                lp.shape != comp.shape:
            raise framed.RemoteError(
                f'trajectory shapes disagree: completions '
                f'{comp.shape}, rewards {rew.shape}, behavior_lp '
                f'{lp.shape}', kind='bad_trajectory')
        return {'lease_id': lease_id, 'version': version,
                'completions': np.asarray(comp, np.int32),
                'rewards': np.asarray(rew, np.float32),
                'behavior_lp': np.asarray(lp, np.float32)}

    def _op_release(self, obj: Dict[str, Any]) -> Dict[str, Any]:
        """A worker hands back a lease it cannot serve (failed
        generation, shutdown): LEASED -> PENDING without waiting for
        the lease timeout. Only the current owner may release."""
        worker_id = str(obj['worker_id'])
        lease_id = int(obj['lease_id'])
        conn = self._conn()
        # Owner-conditional compare-and-set inside the setter's own
        # transaction: "only the current owner may release" holds
        # without holding a process lock across the commit (a lease
        # reassigned-and-re-leased between any read here and the
        # write can no longer be released by its old owner).
        applied = set_lease_status(
            conn, [(lease_id, RolloutLeaseStatus.PENDING, None)],
            require_owner=worker_id)
        if not applied:
            return {'ok': True, 'released': False}
        telemetry.LEASES.inc(event='released')
        return {'ok': True, 'released': True}

    def _op_collect(self, obj: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], framed.Arrays]:
        """Hand up to ``max_n`` completed groups to the learner.

        At-least-once delivery: ``ack`` carries the lease ids the
        learner actually received from the PREVIOUS reply; anything
        handed out but not acked (a reply torn mid-send, a collect
        timeout) is re-delivered ahead of fresh groups. Duplicates
        (reply arrived, ack lost) are deduped learner-side by
        lease_id — leases complete exactly once, so the id is a
        sufficient key."""
        max_n = max(1, int(obj.get('max_n', 1)))
        acked = set(int(a) for a in (obj.get('ack') or []))
        out: List[Dict[str, Any]] = []
        with self._results_lock:
            unacked = [t for t in self._inflight
                       if t['lease_id'] not in acked]
            out.extend(unacked[:max_n])
            while self._results and len(out) < max_n:
                out.append(self._results.popleft())
            # Unacked overflow (a smaller max_n than last time) stays
            # inflight for the round after.
            self._inflight = list(out) + unacked[max_n:]
            telemetry.QUEUE_DEPTH.set(float(len(self._results)),
                                      role='dispatcher')
        meta = [{'lease_id': t['lease_id'], 'version': t['version']}
                for t in out]
        arrays: framed.Arrays = {}
        for i, t in enumerate(out):
            arrays[f'completions_{i}'] = t['completions']
            arrays[f'rewards_{i}'] = t['rewards']
            arrays[f'behavior_lp_{i}'] = t['behavior_lp']
        return {'ok': True, 'trajectories': meta,
                'snapshot_version': self.snapshot_version()}, arrays

    def _op_stats(self) -> Dict[str, Any]:
        conn = self._conn()
        workers = dict(conn.execute(
            'SELECT status, COUNT(*) FROM workers GROUP BY status'
        ).fetchall())
        leases = dict(conn.execute(
            'SELECT status, COUNT(*) FROM leases GROUP BY status'
        ).fetchall())
        with self._results_lock:
            backlog = len(self._results)
        return {'ok': True, 'workers': workers, 'leases': leases,
                'result_backlog': backlog,
                'snapshot_version': self.snapshot_version(),
                'spec_fp': self.spec_fp()}

    def result_backpressure(self) -> float:
        """Result-buffer fill share in [0, 1]: (backlog + live leases)
        over the buffer capacity — the complement of the headroom
        ``_op_lease`` mints against. 1.0 means a new lease would only
        evict completed groups; an elastic fleet controller scales the
        rollout pool DOWN before that point, so no worker generates a
        trajectory the staleness window would drop. Thread-safe (thread-local conn + the
        results lock), so the controller loop may probe it directly."""
        outstanding = int(self._conn().execute(
            'SELECT COUNT(*) FROM leases WHERE status != ?',
            (RolloutLeaseStatus.DONE.value,)).fetchone()[0])
        with self._results_lock:
            backlog = len(self._results)
        cap = self._results.maxlen or 1
        return min(1.0, max(0.0, (backlog + outstanding) / cap))

    def lease_owners(self) -> List[str]:
        """The workers that own a LEASED lease now, the most recently
        granted first (the harness picks its kill victims among them).
        Thread-safe, as :meth:`result_backpressure`."""
        return [w for (w,) in self._conn().execute(
            'SELECT worker_id FROM leases WHERE status = ? '
            'GROUP BY worker_id ORDER BY MAX(assigned_ts) DESC',
            (RolloutLeaseStatus.LEASED.value,)).fetchall()]

    # ----------------------------------------------------------- reaper

    def _reap_loop(self) -> None:
        interval = max(0.05, self._heartbeat_timeout / 4.0)
        while not self._stop.wait(interval):
            try:
                self._reap_once()
            except Exception as e:  # noqa: BLE001 — reaper must survive
                logger.warning(f'rollout reaper pass failed: {e}')

    def _leases_of(self, conn: sqlite3.Connection,
                   worker_id: str) -> List[int]:
        return [l for (l,) in conn.execute(
            'SELECT lease_id FROM leases WHERE status = ? AND '
            'worker_id = ?',
            (RolloutLeaseStatus.LEASED.value, worker_id)).fetchall()]

    def _reassign(self, conn: sqlite3.Connection, lease_ids: List[int],
                  entity: str, reason: str) -> None:
        applied = set_lease_status(conn, [
            (l, RolloutLeaseStatus.PENDING, None) for l in lease_ids])
        if not applied:
            # A faster writer (submit, release, another sweep) moved
            # every lease first — nothing happened, journal nothing.
            return
        telemetry.LEASES.inc(len(applied), event='reassigned')
        journal.record_event(
            'rollout_lease_reassign', entity, reason=reason,
            data={'leases': [l for l, _, _ in applied]})

    def _reap_once(self) -> None:
        conn = self._conn()
        now = time.time()
        # 1. Silent workers -> LOST, their leases -> PENDING.
        cutoff = now - self._heartbeat_timeout
        stale = [w for (w,) in conn.execute(
            'SELECT worker_id FROM workers WHERE status = ? AND '
            'last_heartbeat < ?',
            (RolloutWorkerStatus.ALIVE.value, cutoff)).fetchall()]
        for worker_id in stale:
            # No lock: the LOST write is a compare-and-set
            # (require_heartbeat_before) in its own transaction, and
            # the reassign's LEASED -> PENDING edges are refused by
            # the setter for any lease a faster writer already moved.
            # A lease acquired between the two is caught by the
            # orphan sweep below.
            _, changed = set_rollout_worker_status(
                conn, worker_id, RolloutWorkerStatus.LOST,
                reason='heartbeat_timeout',
                require_heartbeat_before=cutoff)
            if not changed:
                continue
            orphaned = self._leases_of(conn, worker_id)
            self._reassign(conn, orphaned, worker_id,
                           'heartbeat_timeout')
            logger.warning(
                f'rollout worker {worker_id} lost (no heartbeat for '
                f'{self._heartbeat_timeout}s); reassigned leases '
                f'{orphaned}')
        # 2. Orphan sweep: LEASED leases owned by a non-ALIVE worker —
        # a crash between the LOST write and its reassignment would
        # otherwise strand them forever (survivors only heartbeat).
        orphans = [l for (l,) in conn.execute(
            'SELECT lease_id FROM leases WHERE status = ? AND '
            '(worker_id IS NULL OR worker_id NOT IN '
            '(SELECT worker_id FROM workers WHERE status = ?))',
            (RolloutLeaseStatus.LEASED.value,
             RolloutWorkerStatus.ALIVE.value)).fetchall()]
        if orphans:
            self._reassign(conn, orphans, 'dispatcher',
                           'orphan_sweep')
        # 3. Lease timeout: a wedged-but-heartbeating owner cannot sit
        # on a lease forever (at-least-once makes re-execution safe).
        timed_out = [l for (l,) in conn.execute(
            'SELECT lease_id FROM leases WHERE status = ? AND '
            'assigned_ts < ?',
            (RolloutLeaseStatus.LEASED.value,
             now - self._lease_timeout)).fetchall()]
        if timed_out:
            self._reassign(conn, timed_out, 'dispatcher',
                           'lease_timeout')
        # 4. DONE-row GC: keep a bounded accounting tail.
        with sqlite_utils.immediate(conn):
            row = conn.execute(
                'SELECT lease_id FROM leases WHERE status = ? '
                'ORDER BY lease_id DESC LIMIT 1 OFFSET ?',
                (RolloutLeaseStatus.DONE.value,
                 _DONE_KEEP_ROWS)).fetchone()
            if row is not None:
                conn.execute(
                    'DELETE FROM leases WHERE status = ? AND '
                    'lease_id <= ?',
                    (RolloutLeaseStatus.DONE.value, row[0]))
        telemetry.WORKERS_UP.set(float(self._alive_count()))
