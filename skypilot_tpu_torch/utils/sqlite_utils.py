"""sqlite helpers for the port's state DBs (a copy of
skypilot_tpu/utils/sqlite_utils.py: ``connect_wal`` and ``immediate``).

Every state DB runs in WAL mode so readers never block the single
writer. Converting a fresh DELETE-mode file to WAL needs an exclusive
lock, and two connections doing it at once can get 'database is
locked' without the busy timeout being honoured; ``connect_wal``
retries that race.
"""
from __future__ import annotations

import contextlib
import sqlite3
import time
from typing import Iterator

from skypilot_tpu_torch.utils import failpoints as failpoints_lib

_WAL_RETRIES = 50
_WAL_RETRY_SLEEP_S = 0.05


def connect_wal(path: str, timeout: float = 30.0) -> sqlite3.Connection:
    """sqlite3.connect + retried `PRAGMA journal_mode=WAL`."""
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


@contextlib.contextmanager
def immediate(conn: sqlite3.Connection) -> Iterator[sqlite3.Connection]:
    """BEGIN IMMEDIATE transaction scope for read-modify-write.

    sqlite's default deferred transaction takes only a read lock until
    the first write, so SELECT-then-UPDATE lets a concurrent writer
    claim the row in between. BEGIN IMMEDIATE takes the write lock up
    front: the block is atomic against every other writer.

    Raises sqlite3.OperationalError if the connection is already
    mid-transaction: a nested claim would silently lose the lock its
    atomicity rests on.
    """
    conn.execute('BEGIN IMMEDIATE')
    try:
        yield conn
        if failpoints_lib.ACTIVE:
            # Inside the try: a firing rolls the transaction back, as a
            # real commit failure does. Callers must tolerate the write
            # having NOT happened.
            failpoints_lib.fire('sqlite.commit')
    except BaseException:
        conn.rollback()
        raise
    else:
        conn.commit()
