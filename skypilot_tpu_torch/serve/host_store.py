"""Host-RAM spill tier for the block-paged KV cache (a copy of
skypilot_tpu/serve/host_store.py).

The engine's prefix store holds page REFS on the device pool. When a
session goes idle (``SKYTPU_ENGINE_KV_IDLE_SPILL_S``) or pressure evicts
an entry, the engine exports the entry's pages (models/paging.py
``export_pages``), frees the device refs at once and parks the page
CONTENTS here. A later request extending the same prefix wakes the
entry: fresh pages from the allocator, the blob scattered back in
(``import_pages``), and admission proceeds through the shared-prefix
path.

Entries are framed-npy blobs (utils/framed.py ``_encode_payload``): one
npy block per pool field (k/v or c_kv/k_rope, and on an int8 pool their
int8 codes' fp32 scale sidecars, four blocks) with a JSON head holding
the page count and the content fingerprint
(serve/disagg/handoff.py ``kv_fingerprint``); ``pop`` verifies it, so a
corrupted blob raises instead of waking garbage KV. bf16 pools, and
int8 codes with their scales, round-trip bit for bit. Keys are the engine's prefix-store keys (token tuples); one
copy of an entry lives at a time.

Budget: LRU by BYTES against ``SKYTPU_ENGINE_KV_HOST_MB`` (0 disables the
tier). Eviction here is a plain drop: the entry's device pages were
freed at spill time, so the session just re-prefills. Every access is
under one lock; ``occupancy()`` is the /health snapshot.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional, Tuple

from skypilot_tpu_torch.serve.disagg import handoff as handoff_lib
from skypilot_tpu_torch.utils import framed

logger = logging.getLogger(__name__)


class HostPageStore:
    """Byte-budgeted LRU of spilled KV page blobs, keyed by prefix
    token key. Thread-safe."""

    def __init__(self, budget_mb: int):
        self.budget_bytes = int(budget_mb) * (1 << 20)
        self._lock = threading.Lock()
        # key -> (blob bytes, n_pages); _order is the LRU order (a hit
        # pops, so nothing ever moves to the end).
        self._entries: Dict[Tuple[int, ...], Tuple[bytes, int]] = {}
        self._order: List[Tuple[int, ...]] = []
        self._bytes = 0
        self._pages = 0

    def put(self, key, arrays: Dict[str, Any], n_pages: int) -> bool:
        """Park one spilled entry. Returns False (and stores nothing)
        when the blob alone exceeds the whole budget; otherwise evicts
        LRU entries until it fits. A duplicate key is refreshed."""
        meta = {'n_pages': int(n_pages),
                'kv_sha256': handoff_lib.kv_fingerprint(arrays)}
        blob = framed._encode_payload(meta, arrays)  # pylint: disable=protected-access
        if len(blob) > self.budget_bytes:
            return False
        with self._lock:
            self._pop_locked(key)
            while self._bytes + len(blob) > self.budget_bytes:
                dropped = self._pop_locked(self._order[0])
                assert dropped is not None
                logger.debug('host tier evicted a %d-page entry for '
                             'space', dropped[1])
            self._entries[key] = (blob, int(n_pages))
            self._order.append(key)
            self._bytes += len(blob)
            self._pages += int(n_pages)
        return True

    def pop(self, key) -> Optional[Dict[str, Any]]:
        """Wake: remove and decode the entry. Returns the page arrays
        (numpy, bf16 as CPU torch tensors), or None on a miss. Raises
        framed.RemoteError(kind='integrity') when the blob's content
        fingerprint no longer matches."""
        with self._lock:
            entry = self._pop_locked(key)
        if entry is None:
            return None
        meta, arrays = framed._decode_payload(entry[0])  # pylint: disable=protected-access
        if handoff_lib.kv_fingerprint(arrays) != meta.get('kv_sha256'):
            raise framed.RemoteError(
                'spilled KV blob failed its content fingerprint',
                kind='integrity')
        return arrays

    def _pop_locked(self, key) -> Optional[Tuple[bytes, int]]:
        entry = self._entries.pop(key, None)
        if entry is None:
            return None
        self._order.remove(key)
        self._bytes -= len(entry[0])
        self._pages -= entry[1]
        return entry

    def clear(self) -> None:
        """Drop every entry (prefix-store wipes and failure resets
        distrust everything; re-prefill is always correct)."""
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self._bytes = 0
            self._pages = 0

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def pages_spilled(self) -> int:
        """Device pages' worth of KV parked here (the
        skytpu_engine_kv_pages_spilled gauge, sampled at scrape)."""
        with self._lock:
            return self._pages

    def occupancy(self) -> Dict[str, int]:
        """Host-tier occupancy for /health: entry count, resident
        bytes, page count and the byte budget."""
        with self._lock:
            return {'entries': len(self._entries),
                    'bytes': self._bytes,
                    'pages': self._pages,
                    'budget_bytes': self.budget_bytes}
