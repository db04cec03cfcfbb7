"""Durable structured event journal (sqlite, WAL): a copy of what the
engine uses of skypilot_tpu/observe/journal.py — ``record_event``,
``query``, ``tail`` and ``db_path`` — over the same schema and knobs, so
the JAX control plane's ``journal.query`` (and the ``observe`` CLI on
it) reads the rows the port writes.

The DB is one WAL-mode sqlite file (``SKYTPU_OBSERVE_DB``, default
``~/.skytpu/observe/journal.db``); ``SKYTPU_DISABLE_JOURNAL`` drops
every write. Writes are INSERT-only autocommits and never in the way:
an I/O failure is swallowed (``record_event`` returns False), since
telemetry must not fail the operation it describes. The port has no
trace module, so ``trace_id`` is NULL unless the caller passes one (as
the JAX journal writes when no trace is active).
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any, Dict, List, Optional

from skypilot_tpu_torch.utils import knobs

_DB_PATH_ENV = 'SKYTPU_OBSERVE_DB'
_DISABLE_ENV = 'SKYTPU_DISABLE_JOURNAL'

# ``PRAGMA journal_mode=WAL`` can meet a lock while another process
# opens the file: retried this many times, this far apart.
_WAL_RETRIES = 5
_WAL_RETRY_SLEEP_S = 0.05


def db_path() -> str:
    """The journal's path, with no filesystem side effect."""
    return os.path.expanduser(knobs.get_str(_DB_PATH_ENV))


def _enabled() -> bool:
    return not knobs.get_bool(_DISABLE_ENV)


# Per-thread connection cache keyed by path (a test repoints
# SKYTPU_OBSERVE_DB per case and must not inherit a stale connection).
_local = threading.local()


def _connect_wal(path: str, timeout: float = 30.0) -> sqlite3.Connection:
    conn = sqlite3.connect(path, timeout=timeout)
    for attempt in range(_WAL_RETRIES):
        try:
            conn.execute('PRAGMA journal_mode=WAL')
            break
        except sqlite3.OperationalError:
            if attempt == _WAL_RETRIES - 1:
                raise
            time.sleep(_WAL_RETRY_SLEEP_S)
    return conn


def _conn() -> sqlite3.Connection:
    path = db_path()
    cached = getattr(_local, 'conn', None)
    if cached is not None and getattr(_local, 'path', None) == path:
        return cached
    os.makedirs(os.path.dirname(path), exist_ok=True)
    conn = _connect_wal(path)
    conn.execute("""
        CREATE TABLE IF NOT EXISTS events (
            event_id INTEGER PRIMARY KEY AUTOINCREMENT,
            ts REAL,
            kind TEXT,
            machine TEXT,
            entity TEXT,
            old_status TEXT,
            new_status TEXT,
            reason TEXT,
            trace_id TEXT,
            pid INTEGER,
            data TEXT
        )""")
    conn.execute('CREATE INDEX IF NOT EXISTS idx_events_trace '
                 'ON events (trace_id)')
    conn.execute('CREATE INDEX IF NOT EXISTS idx_events_entity '
                 'ON events (machine, entity)')
    conn.commit()
    _local.conn = conn
    _local.path = path
    return conn


def record_event(kind: str, entity: Optional[str] = None, *,
                 machine: Optional[str] = None,
                 reason: Optional[str] = None,
                 trace_id: Optional[str] = None,
                 data: Optional[Dict[str, Any]] = None) -> bool:
    """A non-transition milestone (a spill run, a wake, a flight
    snapshot...); False when the journal is off or the write failed."""
    if not _enabled():
        return False
    try:
        with _conn() as conn:
            conn.execute(
                'INSERT INTO events (ts, kind, machine, entity, '
                'old_status, new_status, reason, trace_id, pid, data) '
                'VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)',
                (time.time(), kind, machine, entity, None, None, reason,
                 trace_id, os.getpid(),
                 json.dumps(data) if data else None))
        return True
    except (sqlite3.Error, OSError):
        return False


_COLUMNS = ('event_id', 'ts', 'kind', 'machine', 'entity', 'old_status',
            'new_status', 'reason', 'trace_id', 'pid', 'data')


def _row_to_dict(row) -> Dict[str, Any]:
    d = dict(zip(_COLUMNS, row))
    if d.get('data'):
        try:
            d['data'] = json.loads(d['data'])
        except ValueError:
            pass
    return d


def query(*, machine: Optional[str] = None, entity: Optional[str] = None,
          trace_id: Optional[str] = None, kind: Optional[str] = None,
          since: Optional[float] = None,
          limit: int = 1000) -> List[Dict[str, Any]]:
    """Filtered events, oldest first."""
    clauses, params = [], []
    for col, val in (('machine', machine), ('entity', entity),
                     ('trace_id', trace_id), ('kind', kind)):
        if val is not None:
            clauses.append(f'{col} = ?')
            params.append(val)
    if since is not None:
        clauses.append('ts >= ?')
        params.append(since)
    where = (' WHERE ' + ' AND '.join(clauses)) if clauses else ''
    sql = (f'SELECT {", ".join(_COLUMNS)} FROM events{where} '
           f'ORDER BY event_id LIMIT ?')
    params.append(max(1, int(limit)))
    try:
        with _conn() as conn:
            rows = conn.execute(sql, params).fetchall()
    except (sqlite3.Error, OSError):
        return []
    return [_row_to_dict(r) for r in rows]


def tail(n: int = 20) -> List[Dict[str, Any]]:
    """The most recent ``n`` events, oldest first."""
    try:
        with _conn() as conn:
            rows = conn.execute(
                f'SELECT {", ".join(_COLUMNS)} FROM events '
                f'ORDER BY event_id DESC LIMIT ?',
                (max(1, int(n)),)).fetchall()
    except (sqlite3.Error, OSError):
        return []
    return [_row_to_dict(r) for r in reversed(rows)]
