"""Block-paged KV cache: the device page pools and the host-side
refcounted allocator (port of skypilot_tpu/models/paging.py:
``PagedKV``, ``pages_for``, ``_write_indices``, ``scatter_prefill``,
``PageAllocator``).

Page 0 is the TRASH page: never allocated; writes for inactive rows are
routed to it so a freed page can never be corrupted by a stale step.
The tensors of a :class:`PagedKV` are updated in place (the JAX version
returns new pytrees).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

TRASH_PAGE = 0


@dataclasses.dataclass
class PagedKV:
    """Paged dense K/V pool + per-slot tables.

    k/v: [L, n_pages, page_size, KH, hd] — page id indexes axis 1.
    table: [B, max_pages] int32 page ids (0 = trash / unassigned).
    length: [B] int32 valid token count per slot."""
    k: torch.Tensor
    v: torch.Tensor
    table: torch.Tensor
    length: torch.Tensor

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def max_pages(self) -> int:
        return self.table.shape[1]


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering positions [0, n_tokens)."""
    return -(-n_tokens // page_size)


def _write_indices(pcache: PagedKV, pos: torch.Tensor,
                   active: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(page_id, offset) for token positions ``pos`` [B, ...]; inactive
    rows route to the trash page."""
    psz, maxp = pcache.page_size, pcache.max_pages
    pos = torch.clamp(pos.long(), max=maxp * psz - 1)
    pid = torch.gather(pcache.table.long(), 1, pos // psz)
    if active is not None:
        pid = torch.where(active[:, None], pid, torch.zeros_like(pid))
    return pid, pos % psz


def scatter_prefill(pcache: PagedKV, k_rows: torch.Tensor,
                    v_rows: torch.Tensor, slots: torch.Tensor, s: int,
                    lengths: torch.Tensor) -> PagedKV:
    """Write a grouped prefill's rows, in place: positions [0, s) of
    k_rows/v_rows [L, N, >=s, KH, hd] land in the pages the admitted
    slots' table rows cover; length[slots] = lengths."""
    dev = pcache.k.device
    pos = torch.arange(s, device=dev)
    psz = pcache.page_size
    pid = pcache.table.long()[slots.long()][:, pos // psz]     # [N, s]
    off = (pos % psz)[None, :].expand_as(pid)
    pcache.k[:, pid, off] = k_rows[:, :, :s]
    pcache.v[:, pid, off] = v_rows[:, :, :s]
    pcache.length[slots.long()] = lengths.to(pcache.length.dtype)
    return pcache


class PagesExhausted(Exception):
    """Not enough free pages — admission must wait."""


class PageAllocator:
    """Host-side deterministic free-list allocator with refcounts.

    FIFO over a deque seeded 1..n_pages-1 ascending; ``fingerprint()``
    is the (free_count, next_free_id) digest; ``take()`` claims explicit
    ids; refcounts implement read-only sharing and refuse double frees.
    """

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(f'need >= 2 pages (1 data + trash), got '
                             f'{n_pages}')
        self.n_pages = n_pages
        self._free = collections.deque(range(1, n_pages))
        self._free_set = set(self._free)
        self._rc: Dict[int, int] = {}

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    def can_fit(self, n: int) -> bool:
        return n <= len(self._free)

    def fingerprint(self) -> Tuple[int, int]:
        return (len(self._free), self._free[0] if self._free else -1)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PagesExhausted(f'need {n} pages, {len(self._free)} free')
        out = [self._free.popleft() for _ in range(n)]
        for pid in out:
            self._free_set.discard(pid)
            self._rc[pid] = 1
        return out

    def take(self, pids: Sequence[int]) -> None:
        want = set(pids)
        if len(want) != len(pids):
            raise ValueError(f'duplicate page ids in plan: {pids}')
        missing = want - self._free_set
        if missing:
            raise PagesExhausted(f'plan pages not free: {sorted(missing)}')
        self._free = collections.deque(
            p for p in self._free if p not in want)
        self._free_set -= want
        for pid in pids:
            self._rc[pid] = 1

    def ref(self, pid: int) -> None:
        if pid not in self._rc:
            raise ValueError(f'ref of unallocated page {pid}')
        self._rc[pid] += 1

    def unref(self, pid: int) -> None:
        rc = self._rc.get(pid)
        if rc is None:
            raise ValueError(f'double free of page {pid}')
        if rc == 1:
            del self._rc[pid]
            self._free.append(pid)
            self._free_set.add(pid)
        else:
            self._rc[pid] = rc - 1

    def unref_all(self, pids: Iterable[int]) -> None:
        for pid in pids:
            self.unref(pid)

    def refcount(self, pid: int) -> int:
        return self._rc.get(pid, 0)
